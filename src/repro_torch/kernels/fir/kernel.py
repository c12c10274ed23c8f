"""The causal FIR kernel (`csrc/fir.cu`) and its plain version.

`fir_cuda` launches the hand-written kernel for Hopper on CUDA tensors;
`fir_plain` is `core.fir.fir_direct` accumulated in float32, the CPU path
and what the kernel is held to on the card. Both filter each row of an
(R, S) array as one causal FIR over the whole row (zero history only
before sample 0), widen each sample to float32, accumulate in float32 and
return the input's dtype: an integer output truncated toward zero and
saturated at its range (`cast_output`, the reference's ``astype``).

Both take any tap count and the reference's real dtypes: float64 and
int64 become float32 and int32 first (`staged_signal`), as the
reference's arrays are with 64-bit types off. The kernel takes float32,
bfloat16, float16, int8, uint8, int16 and int32 rows (`DTYPES`). Up to
`TAP_CHUNK` taps each thread computes one output at a time; past them
each owns `OUTPUTS` consecutive outputs, their sums in registers over the
whole tap loop, on tiles of at most `REGISTER_TILE` samples
(`register_layout`: the taps that fit in shared memory beside the tile
stay there, all of them up to 27,872 at a 2048-sample tile, more are
staged a chunk at a time). Shared memory bounds k at 55,824 taps at a
2048-sample tile. The kernel repeats the plain version's float32
operations in its order without FMA, so the two agree bitwise.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.fir import fir_direct
from repro_torch.kernels import _cuda, cast_output, staged_signal

__all__ = ["fir_plain", "fir_cuda", "default_block_rows", "DTYPES",
           "TAP_CHUNK", "OUTPUTS", "REGISTER_TILE", "register_layout"]

# the row dtypes the kernel takes, and their codes in the source
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.int8: 3, torch.uint8: 4, torch.int16: 5, torch.int32: 6}
TAP_CHUNK = 64          # the one-output loop's taps (kTapChunk)
OUTPUTS = 16            # outputs a thread owns past them (kOutputs)
THREADS = 256           # the kernel's launch bound (kThreads)
REGISTER_TILE = THREADS * OUTPUTS   # the most samples a tile takes there
BLOCK_SAMPLES = 4096    # default samples per block: rows of one tile

_p, _i = ctypes.c_void_p, ctypes.c_int
_cuda.declare("fir", Path(__file__).resolve().parent / "csrc" / "fir.cu",
              ("rows",), {
    # x, taps, y, R, S, k, tile, rows per block, dtype, stream
    "fir_launch": ([_p, _p, _p, _i, _i, _i, _i, _i, _i, _p], _i),
    "fir_smem_bytes": ([_i, _i], ctypes.c_size_t),
})


def register_layout(tile: int, k: int) -> dict:
    """The register path's shared layout for a ``tile`` and k > `TAP_CHUNK`
    taps, as `fir.cu` computes it: the tile it takes (at most
    `REGISTER_TILE`), the lead that puts every window on a row boundary,
    the pitch of the (`OUTPUTS`, pitch) interleaved tile, the taps kept in
    shared memory at once (0: not one step fits) and the block's bytes."""
    t = min(tile, REGISTER_TILE)
    lead = OUTPUTS + (OUTPUTS - k % OUTPUTS) % OUTPUTS
    pitch = -(-t // OUTPUTS) + (k + lead) // OUTPUTS
    pitch += (2 - pitch) % 32
    window = 4 * OUTPUTS * pitch
    room = (_cuda.MAX_SMEM_BYTES - window) // 4 // OUTPUTS * OUTPUTS
    want = -(-k // OUTPUTS) * OUTPUTS
    capacity = 0 if room < OUTPUTS else min(want, room)
    smem = window + 4 * (capacity or OUTPUTS) + \
        (0 if capacity else _cuda.MAX_SMEM_BYTES)
    return {"tile": t, "lead": lead, "pitch": pitch, "capacity": capacity,
            "smem": smem}


def _check(x: torch.Tensor, taps) -> tuple:
    """(``x`` narrowed as the reference stages it, the taps as a float32
    (k,) tensor on ``x``'s device)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (R, S), got {tuple(x.shape)}")
    if x.is_complex() or x.dtype == torch.bool:
        raise ValueError(f"the FIR takes a real input, got {x.dtype}")
    taps = torch.as_tensor(taps, dtype=torch.float32, device=x.device)
    if taps.ndim != 1 or taps.shape[0] < 1:
        raise ValueError(f"taps must be (k,) with k >= 1, got "
                         f"{tuple(taps.shape)}")
    return staged_signal(x), taps.contiguous()


def fir_plain(x: torch.Tensor, taps) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device, for any tap
    count. Returns the input's dtype (float64 and int64 narrowed; an
    integer one saturated, as `cast_output` stores it)."""
    x, taps = _check(x, taps)
    return cast_output(fir_direct(x.float(), taps), x.dtype)


def default_block_rows(S: int, seq_block: int = 2048) -> int:
    """Rows a block filters by default: as many ``min(seq_block, S)``
    tiles as fill `BLOCK_SAMPLES`."""
    return max(1, BLOCK_SAMPLES // max(1, min(seq_block, S)))


def fir_cuda(x: torch.Tensor, taps, *, seq_block: int = 2048,
             block_rows: int | None = None) -> torch.Tensor:
    """Launch the FIR kernel over the rows of a CUDA (R, S) array of one
    of `DTYPES` (float64 and int64 narrowed first). A block filters
    ``block_rows`` rows of one ``seq_block``-sample tile (default: as many
    rows as fill `BLOCK_SAMPLES`); past `TAP_CHUNK` taps a tile is at most
    `REGISTER_TILE` samples."""
    x, taps = _check(x, taps)
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
    rows = block_rows or default_block_rows(S, seq_block)
    k = taps.shape[0]
    _cuda.check_smem("fir", _cuda.library("fir").fir_smem_bytes(tile, k),
                    f"seq_block {tile} and {k} taps")
    _cuda.launch("fir", "rows", x, "fir_launch", x.data_ptr(),
                taps.data_ptr(), y.data_ptr(), R, S, k, tile, min(rows, R),
                DTYPES[x.dtype])
    return y

