"""Public API of the standalone FIR kernel.

Dispatches on the device of its input: a CUDA tensor launches the kernel
(`kernel.fir_cuda`), a CPU tensor runs its plain version.
``autotune=True`` comes with the port of `core/autotune.py`, a later
slice, and raises `NotImplementedError`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import not_in_slice, on_cuda
from repro_torch.kernels.fir.kernel import fir_cuda, fir_plain

__all__ = ["fir"]


def fir(x: torch.Tensor, taps, *, seq_block: int = 2048,
        block_rows: int | None = None,
        autotune: bool = False) -> torch.Tensor:
    """Causal FIR along the last axis of a real (R, S) or (S,) ``x``:
    y[t] = sum_i taps[i] * x[t - i] over the whole row, accumulated in
    float32, returned in ``x``'s dtype (float64 and int64 narrowed). The
    kernel takes float32 and bfloat16 with at most 64 taps."""
    not_in_slice(autotune)
    rows = x[None, :] if x.ndim == 1 else x
    y = fir_cuda(rows, taps, seq_block=seq_block, block_rows=block_rows) \
        if on_cuda(x) else fir_plain(rows, taps)
    return y[0] if x.ndim == 1 else y
