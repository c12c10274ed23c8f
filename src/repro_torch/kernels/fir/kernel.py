"""The causal FIR kernel (`csrc/fir.cu`) and its plain version.

`fir_cuda` launches the hand-written kernel for Hopper on CUDA tensors;
`fir_plain` is `core.fir.fir_direct` accumulated in float32, the CPU path
and what the kernel is held to on the card. Both filter each row of an
(R, S) array as one causal FIR over the whole row (zero history only
before sample 0), accumulate in float32 and return the input's dtype.

The plain version takes any tap count and any real dtype, as the
reference `fir_pallas` does: float64 and int64 become float32 and int32
first, as the reference's arrays are with 64-bit types off. The kernel
takes float32 and bfloat16 rows and at most `MAX_TAPS` taps (`fir.cu`'s
``kMaxTaps``); `fir_cuda` refuses anything else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.fir import fir_direct
from repro_torch.kernels import _cuda

__all__ = ["fir_plain", "fir_cuda", "default_block_rows", "MAX_TAPS"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 64
BLOCK_SAMPLES = 4096    # default samples per block: rows of one tile

_p, _i = ctypes.c_void_p, ctypes.c_int
_cuda.declare("fir", Path(__file__).resolve().parent / "csrc" / "fir.cu",
              ("rows",), {
    # x, taps, y, R, S, k, tile, rows per block, dtype, stream
    "fir_launch": ([_p, _p, _p, _i, _i, _i, _i, _i, _i, _p], _i),
    "fir_smem_bytes": ([_i, _i], ctypes.c_size_t),
})


# 64-bit inputs narrow as the reference's arrays do with 64-bit types off
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _check(x: torch.Tensor, taps) -> torch.Tensor:
    """The taps as a float32 (k,) tensor on ``x``'s device."""
    if x.ndim != 2:
        raise ValueError(f"x must be (R, S), got {tuple(x.shape)}")
    if x.is_complex() or x.dtype == torch.bool:
        raise ValueError(f"the FIR takes a real input, got {x.dtype}")
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    if taps.ndim != 1 or taps.shape[0] < 1:
        raise ValueError(f"taps must be (k,) with k >= 1, got "
                         f"{tuple(taps.shape)}")
    return taps.contiguous()


def fir_plain(x: torch.Tensor, taps) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device, for any tap
    count. Returns the input's dtype (float64 and int64 narrowed)."""
    taps = _check(x, taps)
    dtype = _NARROW.get(x.dtype, x.dtype)
    return fir_direct(x.float(), taps).to(dtype)


def default_block_rows(S: int, seq_block: int = 2048) -> int:
    """Rows a block filters by default: as many ``min(seq_block, S)``
    tiles as fill `BLOCK_SAMPLES`."""
    return max(1, BLOCK_SAMPLES // max(1, min(seq_block, S)))


def fir_cuda(x: torch.Tensor, taps, *, seq_block: int = 2048,
             block_rows: int | None = None) -> torch.Tensor:
    """Launch the FIR kernel over the rows of a CUDA (R, S) array. A block
    filters ``block_rows`` rows of one ``seq_block``-sample tile (default:
    as many rows as fill `BLOCK_SAMPLES`)."""
    taps = _check(x, taps)
    _cuda.check_cuda_input(x, tuple(DTYPES))
    if taps.shape[0] > MAX_TAPS:
        raise ValueError(f"the FIR kernel takes at most {MAX_TAPS} taps, "
                         f"got {taps.shape[0]}")
    if seq_block < 1 or (block_rows is not None and block_rows < 1):
        raise ValueError(f"seq_block {seq_block} and block_rows "
                         f"{block_rows} must be positive")
    x = x.contiguous()
    R, S = x.shape
    y = torch.empty_like(x)
    if R == 0 or S == 0:
        return y
    tile = min(seq_block, S)
    rows = block_rows or default_block_rows(S, seq_block)
    k = taps.shape[0]
    _cuda.check_smem("fir", _cuda.library("fir").fir_smem_bytes(tile, k),
                    f"seq_block {tile}")
    _cuda.launch("fir", "rows", x, "fir_launch", x.data_ptr(),
                taps.data_ptr(), y.data_ptr(), R, S, k, tile, min(rows, R),
                DTYPES[x.dtype])
    return y

