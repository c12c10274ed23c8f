"""The port's rotary embedding (`repro_torch.kernels.rope`) against the JAX
package's, on the CPU.

The JAX entry runs as `tests/test_fir_rope.py` runs it here: `rope_pallas`
in interpret mode. The port's entry gets CPU tensors, so it runs the plain
PyTorch version, which the CUDA kernel (`kernels/rope/csrc/rope.cu`) is
held to on the card. Inputs are drawn with numpy from a seed; bfloat16
inputs are the same float32 draw rounded to nearest in both frameworks.

Tolerances, and why:
* against the JAX entry, float32: max |diff| <= 1e-4 x max |x| for
  positions < 512. Both build the inverse frequencies in float32 in the
  same order, but XLA's and PyTorch's exp, sin and cos may differ in the
  last bit, and the angle multiplies an inverse frequency's error by the
  position (512 x 2^-23 ~ 6e-5);
* against the JAX entry, bfloat16: one bfloat16 rounding, |diff| <=
  2^-7 |want| + 1e-4 max |x| (the float32 results above rounded once);
* against `rope_ref` (a float64 frequency table): atol 3e-3, rtol 1e-3
  at positions < 4096, as `tests/test_fir_rope.py` holds the TPU kernel;
* the port's `rope_ref` against the JAX package's: 1e-5 (the same table,
  the same float32 operations).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rope.ops import rope as j_rope
from repro.kernels.rope.ref import rope_ref as j_rope_ref
from repro_torch.kernels.rope.kernel import inv_freq, rope_plain
from repro_torch.kernels.rope.ops import rope
from repro_torch.kernels.rope.ref import rope_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.as_tensor(x).to(td)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _check(got, want, x: np.ndarray, dtype: str) -> None:
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    scale = float(np.abs(x).max())
    if dtype == "float32":
        assert float(np.abs(g - w).max()) <= 1e-4 * scale
    else:
        assert (np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-4 * scale).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["interleaved", "neox"])
@pytest.mark.parametrize("dh", [32, 64, 120, 128])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(dh, layout, dtype, theta):
    rng = np.random.default_rng(dh)
    x = rng.normal(size=(96, dh)).astype(np.float32)
    pos = rng.integers(0, 512, 96).astype(np.int32)
    jx, tx = _both(x, dtype)
    want = j_rope(jx, jnp.asarray(pos), theta=theta, layout=layout)
    got = rope(tx, torch.as_tensor(pos), theta=theta, layout=layout)
    assert got.dtype == tx.dtype
    _check(got, want, x, dtype)


@pytest.mark.parametrize("shape,pos_shape", [
    ((2, 16, 3, 64), (2, 16)),        # one position per (batch, slot)
    ((2, 16, 3, 64), (2, 16, 3)),     # one per row
    ((2, 16, 3, 120), (1, 16)),       # rank x.ndim - 2, broadcast on batch
    ((16, 3, 32), (16,)),             # (S, H, dh)
])
@pytest.mark.parametrize("layout", ["interleaved", "neox"])
def test_rope_broadcast_form_matches_reference(shape, pos_shape, layout):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = rng.normal(size=shape).astype(np.float32)
    pos = rng.integers(0, 512, pos_shape).astype(np.int32)
    want = j_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6,
                  layout=layout)
    got = rope(torch.as_tensor(x), torch.as_tensor(pos), theta=1e6,
               layout=layout)
    assert tuple(got.shape) == shape
    _check(got, want, x, "float32")


@pytest.mark.parametrize("dh", [32, 64, 120, 128])
@pytest.mark.parametrize("layout", ["interleaved", "neox"])
def test_rope_matches_float64_table_oracle(dh, layout):
    rng = np.random.default_rng(dh + 7)
    x = rng.normal(size=(96, dh)).astype(np.float32)
    pos = rng.integers(0, 4096, 96).astype(np.int32)
    tx, tp = torch.as_tensor(x), torch.as_tensor(pos)
    got = rope(tx, tp, layout=layout)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_rope_ref(jnp.asarray(x),
                                                     jnp.asarray(pos),
                                                     layout=layout)),
                               atol=3e-3, rtol=1e-3)
    np.testing.assert_allclose(rope_ref(tx, tp, layout=layout).numpy(),
                               np.asarray(j_rope_ref(jnp.asarray(x),
                                                     jnp.asarray(pos),
                                                     layout=layout)),
                               atol=1e-5, rtol=1e-5)


def test_inverse_frequencies_follow_the_kernel_formula():
    """exp((i * f32(2/dh)) * f32(-ln theta)) in float32, the JAX kernel's
    order; it stays within float32 rounding of the float64 table."""
    for dh, theta in ((64, 1e6), (120, 1e4)):
        inv = inv_freq(dh, theta, "cpu").double().numpy()
        exact = 1.0 / theta ** (np.arange(0, dh, 2) / dh)
        np.testing.assert_allclose(inv, exact, rtol=2e-6)


@pytest.mark.parametrize("layout", ["interleaved", "neox"])
def test_rope_preserves_norm_and_relative_position(layout):
    """Rotations keep each pair's norm; <rope(q, m+d), rope(k, n+d)> ==
    <rope(q, m), rope(k, n)>."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 64, generator=g)
    out = rope_plain(x, torch.full((4,), 300), layout=layout)
    torch.testing.assert_close(out.norm(dim=-1), x.norm(dim=-1), rtol=1e-5,
                               atol=1e-5)
    q, k = torch.randn(1, 64, generator=g), torch.randn(1, 64, generator=g)

    def dot(m, n):
        return float((rope(q, torch.tensor([m]), layout=layout) *
                      rope(k, torch.tensor([n]), layout=layout)).sum())

    assert abs(dot(57, 20) - dot(40, 3)) < 5e-3 * max(1.0, abs(dot(40, 3)))
