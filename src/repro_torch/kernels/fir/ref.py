"""Oracles for the FIR kernel: the plain shifted multiply-adds of
`core.fir` and a float64 ``np.convolve`` reference."""
from __future__ import annotations

import numpy as np

from repro_torch.core.fir import fir_direct as fir_ref  # noqa: F401


def fir_reference(x, taps) -> np.ndarray:
    """Causal FIR via ``np.convolve`` ('full' truncated to causal) in
    float64, cast back to ``x``'s numpy dtype."""
    x_np = np.asarray(x, np.float64)
    t_np = np.asarray(taps, np.float64)
    out = np.apply_along_axis(
        lambda row: np.convolve(row, t_np)[: row.shape[0]], -1, x_np)
    return out.astype(np.asarray(x).dtype)
