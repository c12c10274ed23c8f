"""The port's flash attention (`repro_torch.kernels.flash_attention`) and
its oracle (`repro_torch.models.attention.reference_attention`) against
the JAX package's, on the CPU.

The JAX entry runs as `tests/test_flash_attention.py` runs it here:
`flash_attention_pallas` in interpret mode. The port's entry gets CPU
tensors, so it runs the plain PyTorch version, which the CUDA kernel
(`kernels/flash_attention/csrc/flash_attention.cu`) is held to on the
card. Inputs are drawn with numpy from a seed; bfloat16 inputs are the
same float32 draw rounded to nearest in both frameworks.

Tolerances: atol = rtol = 3e-5 in float32 (sums in another order), as
`tests/test_flash_attention.py` holds the TPU kernel to the same oracle;
in bfloat16 the kernel's own `FLASH_TOL` (1e-4 + 2^-7 |want| per element:
one bfloat16 rounding of the output plus the float32 difference). Every
query row sees at least one key: a row with none has no defined result
(the JAX kernel averages v over the chunks it visited, the oracle over
all keys).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models.attention import reference_attention as j_reference
from repro_torch.kernels.flash_attention.kernel import FLASH_TOL
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_ref
from repro_torch.models.attention import NEG_INF, reference_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": (3e-5, 3e-5), "bfloat16": FLASH_TOL["bfloat16"]}


def _qkv(shape, dtype: str, seed: int):
    """(jax q, k, v), (torch q, k, v) from one numpy draw."""
    B, Sq, Skv, H, KV, dh = shape
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(B, Sq, H, dh)).astype(np.float32),
              rng.normal(size=(B, Skv, KV, dh)).astype(np.float32),
              rng.normal(size=(B, Skv, KV, dh)).astype(np.float32))
    jd, td = DTYPES[dtype]
    return (tuple(jnp.asarray(a).astype(jd) for a in arrays),
            tuple(torch.as_tensor(a).to(td) for a in arrays))


def _close(got: torch.Tensor, want, dtype: str) -> None:
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype][0], rtol=TOL[dtype][1])


@pytest.mark.parametrize("shape", [
    (2, 128, 128, 4, 2, 32),     # GQA group 2
    (1, 64, 64, 4, 4, 24),       # MHA, dh not a power of two
    (1, 128, 128, 4, 1, 64),     # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference(shape, causal):
    (jq, jk, jv), (q, k, v) = _qkv(shape, "float32", sum(shape))
    want = j_flash(jq, jk, jv, causal=causal, q_chunk=32, kv_chunk=32)
    got = flash_attention(q, k, v, causal=causal, q_chunk=32, kv_chunk=32)
    _close(got, want, "float32")


@pytest.mark.parametrize("window", [32, 96])
def test_flash_sliding_window_matches_reference(window):
    (jq, jk, jv), (q, k, v) = _qkv((2, 128, 128, 4, 2, 32), "float32",
                                   window)
    want = j_flash(jq, jk, jv, causal=True, window=window, q_chunk=32,
                   kv_chunk=32)
    got = flash_attention(q, k, v, causal=True, window=window, q_chunk=32,
                          kv_chunk=32)
    _close(got, want, "float32")


@pytest.mark.parametrize("Sq,Skv", [(64, 128), (128, 96)])
def test_flash_cross_lengths_without_causal_match_reference(Sq, Skv):
    (jq, jk, jv), (q, k, v) = _qkv((1, Sq, Skv, 4, 2, 32), "float32", Sq)
    want = j_flash(jq, jk, jv, causal=False, q_chunk=32, kv_chunk=32)
    got = flash_attention(q, k, v, causal=False, q_chunk=32, kv_chunk=32)
    _close(got, want, "float32")


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_flash_bf16_matches_reference(causal, window):
    (jq, jk, jv), (q, k, v) = _qkv((1, 128, 128, 4, 2, 64), "bfloat16", 3)
    want = j_flash(jq, jk, jv, causal=causal, window=window, q_chunk=64,
                   kv_chunk=64)
    got = flash_attention(q, k, v, causal=causal, window=window,
                          q_chunk=64, kv_chunk=64)
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("q_chunk,kv_chunk", [(48, 32), (32, 80), (0, 32)])
def test_both_packages_refuse_the_same_chunks(q_chunk, kv_chunk):
    """min(chunk, S) must be positive and divide S, in both packages
    (the JAX wrapper asserts or divides by zero, the port raises
    ValueError)."""
    (jq, jk, jv), (q, k, v) = _qkv((1, 128, 128, 2, 2, 16), "float32", 1)
    with pytest.raises((AssertionError, ZeroDivisionError)):
        j_flash(jq, jk, jv, q_chunk=q_chunk, kv_chunk=kv_chunk)
    with pytest.raises(ValueError, match="divide"):
        flash_attention(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk)


def test_chunk_arguments_do_not_change_the_result():
    (_, _, _), (q, k, v) = _qkv((1, 128, 128, 2, 2, 32), "float32", 2)
    ref = flash_ref(q, k, v)
    for qc, kc in ((32, 128), (128, 32), (256, 256)):
        torch.testing.assert_close(
            flash_attention(q, k, v, q_chunk=qc, kv_chunk=kc), ref,
            atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40),
                                           (False, None), (False, 24)])
def test_reference_attention_matches_reference(causal, window):
    """The oracle itself, against the JAX package's, at Sq != Skv."""
    (jq, jk, jv), (q, k, v) = _qkv((2, 48, 64, 6, 3, 24), "float32", 9)
    want = j_reference(jq, jk, jv, causal=causal, window=window)
    got = reference_attention(q, k, v, causal=causal, window=window)
    _close(got, want, "float32")
    assert NEG_INF == -1e30
