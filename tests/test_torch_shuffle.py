"""The port's shuffle unit (`repro_torch.core.shuffle`,
`repro_torch.kernels.shuffle`) against the JAX package's, on the CPU.

The JAX entry runs as `tests/test_shuffle.py` runs it here: `shuffle_pallas`
in interpret mode, at that test's shapes and dtypes. The port's entry gets
CPU tensors, so it runs the plain PyTorch version, which the CUDA kernel
(`kernels/shuffle/csrc/shuffle.cu`) is held to on the card. Inputs are
drawn with numpy from a seed; bfloat16 inputs are the same float32 draw
rounded to nearest in both frameworks.

Tolerance: none. A shuffle moves words, so every output is compared bit
for bit, for every op, half, dtype and shift amount.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shuffle as jcore
from repro.kernels.shuffle.ops import shuffle as j_shuffle
from repro_torch.core import shuffle as tcore
from repro_torch.kernels.shuffle.kernel import shuffle_plain
from repro_torch.kernels.shuffle.ops import shuffle
from repro_torch.kernels.shuffle.ref import shuffle_ref

OPS = ["interleave", "prune_even", "prune_odd", "bit_reverse",
       "circular_shift"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def _both(x: np.ndarray, dtype: str):
    """The same draw as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.as_tensor(x).to(td)


def _bits(a) -> np.ndarray:
    """The words of a JAX array or torch tensor as unsigned integers."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _draw(rng, shape, dtype: str) -> np.ndarray:
    if dtype == "int32":
        return rng.integers(-2 ** 31, 2 ** 31 - 1, shape).astype(np.int32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("shape", [(8, 128), (16, 64), (1, 256), (64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_shuffle_matches_reference_bitwise(op, shape, dtype):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    ja, ta = _both(_draw(rng, shape, dtype), dtype)
    jb, tb = _both(_draw(rng, shape, dtype), dtype)
    halves = ["both"] if op.startswith("prune") else ["lower", "upper",
                                                      "both"]
    amounts = [32, -5] if op == "circular_shift" else [32]
    for half in halves:
        for amount in amounts:
            want = j_shuffle(ja, jb, op, half=half, amount=amount)
            got = shuffle(ta, tb, op, half=half, amount=amount)
            assert got.dtype == ta.dtype
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"{half} {amount}")


@pytest.mark.parametrize("amount", [0, 1, 255, 256, 2 * 128 + 3, -300])
def test_circular_shift_amounts_match_reference_bitwise(amount):
    """Any integer amount, as `jnp.roll` takes it: zero, a whole turn,
    past a turn and negative."""
    rng = np.random.default_rng(amount % 97)
    ja, ta = _both(_draw(rng, (4, 128), "float32"), "float32")
    jb, tb = _both(_draw(rng, (4, 128), "float32"), "float32")
    for half in ("both", "lower", "upper"):
        want = j_shuffle(ja, jb, "circular_shift", half=half, amount=amount)
        got = shuffle(ta, tb, "circular_shift", half=half, amount=amount)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("logn", [1, 3, 6, 8])
def test_core_shuffle_matches_reference_bitwise(logn):
    """`core.shuffle` batched over two leading axes, against the JAX
    package's `core/shuffle.py`."""
    n = 1 << logn
    rng = np.random.default_rng(logn)
    x, y = (rng.normal(size=(2, 3, n)).astype(np.float32) for _ in range(2))
    ja, ta = jnp.asarray(x), torch.as_tensor(x)
    jb, tb = jnp.asarray(y), torch.as_tensor(y)
    for half in ("both", tcore.HALF_LOWER, tcore.HALF_UPPER):
        for name in ("interleave", "bit_reverse"):
            np.testing.assert_array_equal(
                getattr(tcore, name)(ta, tb, half).numpy(),
                np.asarray(getattr(jcore, name)(ja, jb, half)))
        np.testing.assert_array_equal(
            tcore.circular_shift(ta, tb, 3, half).numpy(),
            np.asarray(jcore.circular_shift(ja, jb, 3, half)))
    for drop in ("even", "odd"):
        np.testing.assert_array_equal(
            tcore.prune(ta, tb, drop=drop).numpy(),
            np.asarray(jcore.prune(ja, jb, drop=drop)))
    np.testing.assert_array_equal(tcore.bit_reverse_indices(2 * n),
                                  jcore.bit_reverse_indices(2 * n))
    ev, od = tcore.deinterleave(tcore.interleave(ta, tb))
    assert torch.equal(ev, ta) and torch.equal(od, tb)
    assert (tcore.HALF_LOWER, tcore.HALF_UPPER) == \
        (jcore.HALF_LOWER, jcore.HALF_UPPER)


@pytest.mark.parametrize("op", OPS)
def test_plain_version_is_the_oracle(op):
    """`shuffle_plain` (the kernel's plain version) and `shuffle_ref`
    agree on every half, in the port alone."""
    g = torch.Generator().manual_seed(5)
    a, b = torch.randn(6, 32, generator=g), torch.randn(6, 32, generator=g)
    for half in ("both", "lower", "upper"):
        got = shuffle_plain(a, b, op, half=half, amount=-7)
        want = shuffle_ref(a, b, op, half=half, amount=-7)
        assert torch.equal(got, want)
