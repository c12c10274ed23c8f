"""Public API of the standalone FIR kernel.

Dispatches on the device of its input: a CUDA tensor launches the kernel
(`kernel.fir_cuda`), a CPU tensor runs its plain version.
``autotune=True`` measures the kernel's ``block_rows`` at the given
``seq_block`` (`core.autotune`, key ``("fir", R, S, seq_block, dtype,
k)`` as in the reference), which changes the speed, never the result.
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import (candidate_block_rows, dtype_name,
                                       tuned_block_rows)
from repro_torch.kernels import on_cuda
from repro_torch.kernels.fir.kernel import (default_block_rows, fir_cuda,
                                            fir_plain)

__all__ = ["fir"]


def fir(x: torch.Tensor, taps, *, seq_block: int = 2048,
        block_rows: int | None = None,
        autotune: bool = False) -> torch.Tensor:
    """Causal FIR along the last axis of a real (R, S) or (S,) ``x``:
    y[t] = sum_i taps[i] * x[t - i] over the whole row, accumulated in
    float32, returned in ``x``'s dtype (float64 and int64 narrowed; an
    integer output truncated and saturated, as the reference's ``astype``).
    The kernel takes any tap count its shared memory holds and the
    reference's real dtypes but uint16 and uint32."""
    rows = x[None, :] if x.ndim == 1 else x

    def run(rb):
        return fir_cuda(rows, taps, seq_block=seq_block, block_rows=rb) \
            if on_cuda(x) else fir_plain(rows, taps)
    if autotune and block_rows is None:
        R, S = rows.shape
        block_rows = tuned_block_rows(
            "fir", R, (S, seq_block, dtype_name(rows.dtype), len(taps)), run,
            candidates=candidate_block_rows(
                R, default=default_block_rows(S, seq_block)))
    y = run(block_rows)
    return y[0] if x.ndim == 1 else y
