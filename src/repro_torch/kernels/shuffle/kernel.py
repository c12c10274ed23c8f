"""The shuffle-unit kernel (`csrc/shuffle.cu`) and its plain version.

`shuffle_cuda` launches the hand-written permutation kernel for Hopper on
CUDA tensors; `shuffle_plain` is `core.shuffle`, the CPU path and what the
kernel is held to, bitwise, on the card. Both take (R, N) blocks A and B
of one dtype and shape and return the permuted block: (R, 2N) for
``half="both"``, else (R, N); the prunes always give (R, N) and ignore
``half``. The kernel copies 4- or 2-byte words (float32, int32,
bfloat16) without converting them.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.shuffle.ref import shuffle_ref

__all__ = ["OPS", "HALVES", "DTYPES", "shuffle_plain", "shuffle_cuda"]

# the ops, as the kernel numbers them; each is an entry of the launch count
OPS = ("interleave", "prune_even", "prune_odd", "bit_reverse",
       "circular_shift")
HALVES = ("both", "lower", "upper")
# the kernel copies words of 4 or 2 bytes
DTYPES = (torch.float32, torch.int32, torch.bfloat16)

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_cuda.declare("shuffle",
              Path(__file__).resolve().parent / "csrc" / "shuffle.cu", OPS, {
    # a, b, out, R, N, out_n, op, half offset, amount, log2(2N),
    # element bytes, stream
    "shuffle_launch": ([_p, _p, _p, _ll, _i, _i, _i, _i, _i, _i, _i, _p],
                       _i),
})


def _check(a: torch.Tensor, b: torch.Tensor, op: str, half: str) -> int:
    """The output width of ``op`` on (R, N) blocks ``a`` and ``b``."""
    if op not in OPS:
        raise ValueError(f"unknown shuffle op {op!r}; one of {OPS}")
    if half not in HALVES:
        raise ValueError(f"half must be one of {HALVES}, got {half!r}")
    if a.ndim != 2 or a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"a and b must be (R, N) blocks of one shape and "
                         f"dtype, got {a.dtype} {tuple(a.shape)} and "
                         f"{b.dtype} {tuple(b.shape)}")
    n = a.shape[1]
    if op == "bit_reverse" and (n < 1 or n & (n - 1)):
        raise ValueError(f"bit_reverse needs N a power of two, got {n}")
    if op.startswith("prune") and n % 2:
        raise ValueError(f"{op} needs an even N, got {n}")
    return n if (half != "both" or op.startswith("prune")) else 2 * n


def shuffle_plain(a: torch.Tensor, b: torch.Tensor, op: str, *,
                  half: str = "both", amount: int = 32) -> torch.Tensor:
    """The kernel's function in plain PyTorch (`core.shuffle` through
    `shuffle_ref`), on any device."""
    _check(a, b, op, half)
    return shuffle_ref(a, b, op, half=half, amount=amount)


def shuffle_cuda(a: torch.Tensor, b: torch.Tensor, op: str, *,
                 half: str = "both", amount: int = 32) -> torch.Tensor:
    """Launch the shuffle kernel over the rows of CUDA (R, N) blocks;
    returns a new block of their dtype."""
    out_n = _check(a, b, op, half)
    _cuda.check_cuda_input(a, DTYPES)
    if b.device != a.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    a, b = a.contiguous(), b.contiguous()
    R, n = a.shape
    out = torch.empty((R, out_n), dtype=a.dtype, device=a.device)
    if R == 0 or n == 0:
        return out
    off = n if (half == "upper" and not op.startswith("prune")) else 0
    _cuda.launch("shuffle", op, a, "shuffle_launch", a.data_ptr(),
                 b.data_ptr(), out.data_ptr(), R, n, out_n, OPS.index(op),
                 off, amount % (2 * n), (2 * n).bit_length() - 1,
                 a.element_size())
    return out

