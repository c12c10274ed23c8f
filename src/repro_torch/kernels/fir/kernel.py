"""The causal FIR kernel (`csrc/fir.cu`) and its plain version.

`fir_cuda` launches the hand-written kernel for Hopper on CUDA tensors;
`fir_plain` is `core.fir.fir_direct` accumulated in float32, the CPU path
and what the kernel is held to on the card. Both filter each row of an
(R, S) float32 or bfloat16 array as one causal FIR over the whole row
(zero history only before sample 0), accumulate in float32 and return
the input's dtype.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.fir import fir_direct
from repro_torch.kernels import _cuda

__all__ = ["fir_plain", "fir_cuda", "MAX_TAPS"]

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


def _check(x: torch.Tensor, taps) -> torch.Tensor:
    """The taps as a float32 (k,) tensor on ``x``'s device."""
    if x.ndim != 2:
        raise ValueError(f"x must be (R, S), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"the FIR takes float32 or bfloat16 input, got "
                         f"{x.dtype}")
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    if taps.ndim != 1 or not 1 <= taps.shape[0] <= MAX_TAPS:
        raise ValueError(f"taps must be (k,) with 1 <= k <= {MAX_TAPS}, got "
                         f"{tuple(taps.shape)}")
    return taps.contiguous()


def fir_plain(x: torch.Tensor, taps) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    taps = _check(x, taps)
    return fir_direct(x.float(), taps).to(x.dtype)


def fir_cuda(x: torch.Tensor, taps, *, seq_block: int = 2048,
             block_rows: int | None = None) -> torch.Tensor:
    """Launch the FIR kernel over the rows of a CUDA (R, S) array. A block
    filters ``block_rows`` rows of one ``seq_block``-sample tile (default:
    as many rows as fill `BLOCK_SAMPLES`)."""
    taps = _check(x, taps)
    _cuda.check_cuda_input(x, tuple(DTYPES))
    if seq_block < 1 or (block_rows is not None and block_rows < 1):
        raise ValueError(f"seq_block {seq_block} and block_rows "
                         f"{block_rows} must be positive")
    x = x.contiguous()
    R, S = x.shape
    y = torch.empty_like(x)
    if R == 0 or S == 0:
        return y
    tile = min(seq_block, S)
    rows = block_rows or max(1, BLOCK_SAMPLES // tile)
    k = taps.shape[0]
    _cuda.check_smem("fir", _cuda.library("fir").fir_smem_bytes(tile, k),
                    f"seq_block {tile}")
    _cuda.launch("fir", "rows", x, "fir_launch", x.data_ptr(),
                taps.data_ptr(), y.data_ptr(), R, S, k, tile, min(rows, R),
                DTYPES[x.dtype])
    return y

