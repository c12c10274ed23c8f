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
import dataclasses
from pathlib import Path

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.shuffle.ref import shuffle_ref

__all__ = ["OPS", "HALVES", "DTYPES", "shuffle_plain", "shuffle_geometry",
           "source_ranges", "shuffle_launch_args", "shuffle_cuda"]

# the ops, as the kernel numbers them; each is an entry of the launch count
OPS = ("interleave", "prune_even", "prune_odd", "bit_reverse",
       "circular_shift")
HALVES = ("both", "lower", "upper")
# the kernel copies words of 4 or 2 bytes
DTYPES = (torch.float32, torch.int32, torch.bfloat16)

# the launch geometry (`shuffle_geometry`): most threads a block (kThreads
# of csrc/shuffle.cu), the bytes of A and B a block stages in shared memory
# (measured over 8, 16 and 32 KB by tools/shuffle_variants.py) and the most
# it may (kStageBytes)
SHUFFLE_THREADS = 256
SHUFFLE_BLOCK_BYTES = 8 * 1024
SHUFFLE_STAGE_BYTES = 48 * 1024

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_cuda.declare("shuffle",
              Path(__file__).resolve().parent / "csrc" / "shuffle.cu", OPS, {
    # a, b, out, R, N, out_n, op, half offset, amount, log2(2N),
    # element bytes, 16-byte copies, misalignment, staged, the staged runs
    # (a_lo, a_n, b_lo, b_n), rows a block, threads a block, stream
    "shuffle_launch": ([_p, _p, _p, _ll, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                        _i, _i, _i, _i, _i, _i, _i, _p], _i),
})


@dataclasses.dataclass(frozen=True)
class ShuffleGeometry:
    out_n: int          # output words a row
    off: int            # N for the upper half, else 0
    vec: bool           # 16-byte copies, else one word a copy
    staged: bool        # the block's rows of A and B in shared memory
                        # (16-byte copies only)
    ranges: tuple       # (a_lo, a_n, b_lo, b_n): the words of a row staged
    rows: int           # rows a block
    threads: int        # threads a block


def source_ranges(op: str, n: int, out_n: int, off: int,
                  amount: int) -> tuple:
    """(a_lo, a_n, b_lo, b_n): the run of each row of A and of B that holds
    every word the output takes. One half of the interleave or of the
    shift takes one run of each (half the row); every other output takes
    whole rows (the prunes and the bit reversal take every other word)."""
    if out_n == 2 * n or op not in ("interleave", "circular_shift"):
        return 0, n, 0, n
    if op == "interleave":
        # even p take A[p >> 1], odd p B[p >> 1], p in [off, off + n)
        first_a, last_a = off + (off & 1), off + n - 1 - ((off + n - 1) & 1)
        first_b, last_b = off | 1, off + n - 1 - (1 - ((off + n - 1) & 1))
        a = (first_a >> 1, (last_a >> 1) + 1) if first_a <= last_a else (0, 0)
        b = (first_b >> 1, (last_b >> 1) + 1) if first_b <= last_b else (0, 0)
        return a[0], a[1] - a[0], b[0], b[1] - b[0]
    s = (off - amount) % (2 * n)        # the run [s, s + n) of concat(A, B)
    if s < n:
        return s, n - s, 0, s
    return 0, s - n, s - n, 2 * n - s


def shuffle_geometry(R: int, n: int, op: str, half: str, amount: int,
                     elem: int, misalign: int) -> ShuffleGeometry:
    """How `shuffle_launch` cuts (R, N) blocks of ``elem``-byte words for
    ``op`` (its ``half`` and ``amount``): 16-byte copies where the bases
    are aligned (``misalign`` = (a | b | out) % 16 is 0) and a row of N
    words is whole vectors; the runs of A and B the output takes
    (`source_ranges`, widened to whole vectors), `SHUFFLE_BLOCK_BYTES` of
    them staged a block (at least one row); rows are read in place where
    the copies are single words or one row's runs exceed
    `SHUFFLE_STAGE_BYTES`; one thread an output copy of as many rows as
    fit in `SHUFFLE_THREADS`."""
    out_n = n if (half != "both" or op.startswith("prune")) else 2 * n
    off = n if (half == "upper" and not op.startswith("prune")) else 0
    vec = misalign == 0 and (n * elem) % 16 == 0
    ve = 16 // elem if vec else 1
    a_lo, a_n, b_lo, b_n = source_ranges(op, n, out_n, off,
                                         amount % (2 * n))
    ranges = []
    for lo, cnt in ((a_lo, a_n), (b_lo, b_n)):
        hi = -(-(lo + cnt) // ve) * ve if cnt else 0
        lo = lo // ve * ve if cnt else 0
        ranges += [lo, hi - lo]
    row_bytes = elem * (ranges[1] + ranges[3])
    staged = vec and row_bytes <= SHUFFLE_STAGE_BYTES
    if not staged:
        ranges = [0, n, 0, n]
    units = out_n // ve
    fill = max(1, SHUFFLE_THREADS // units)
    rows = max(1, SHUFFLE_BLOCK_BYTES // row_bytes) if staged else fill
    rows = min(rows, R)
    threads = units * min(fill, rows) if units <= SHUFFLE_THREADS \
        else SHUFFLE_THREADS
    return ShuffleGeometry(out_n, off, vec, staged, tuple(ranges), rows,
                           threads)


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


def shuffle_launch_args(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                        op: str, *, half: str, amount: int) -> tuple:
    """The arguments of ``shuffle_launch`` but the stream, for contiguous
    CUDA (R, N) ``a`` and ``b`` and an (R, out_n) ``out``."""
    R, n = a.shape
    misalign = (a.data_ptr() | b.data_ptr() | out.data_ptr()) % 16
    g = shuffle_geometry(R, n, op, half, amount, a.element_size(), misalign)
    return (a.data_ptr(), b.data_ptr(), out.data_ptr(), R, n, g.out_n,
            OPS.index(op), g.off, amount % (2 * n), (2 * n).bit_length() - 1,
            a.element_size(), int(g.vec), misalign, int(g.staged),
            *g.ranges, g.rows, g.threads)


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
    _cuda.launch("shuffle", op, a, "shuffle_launch",
                 *shuffle_launch_args(a, b, out, op, half=half,
                                      amount=amount))
    return out
