"""Causal FIR filtering (paper §4.4.1: 11-tap FIR), plain PyTorch.

The taps unroll to k shifted multiply-adds in a fixed order — the order the
fused CUDA kernel (`kernels/pipeline/csrc/biosignal_graph.cu`) repeats, so
the two agree to the last bit on the same input.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def fir_direct(x: torch.Tensor, taps) -> torch.Tensor:
    """Causal FIR: y[t] = sum_i taps[i] * x[t - i]. x: (..., S)."""
    taps = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    k = taps.shape[-1]
    S = x.shape[-1]
    xp = F.pad(x, (k - 1, 0))
    y = torch.zeros_like(x)
    for i in range(k):  # unrolled taps == VWR circular shifts
        y = y + taps[i] * xp[..., k - 1 - i: k - 1 - i + S]
    return y


def lowpass_taps(n_taps: int = 11, cutoff: float = 0.15) -> np.ndarray:
    """Hamming-windowed sinc low-pass — the biosignal preprocessing filter
    (the paper's MBioTracker preprocess step uses an 11-tap FIR)."""
    m = n_taps - 1
    t = np.arange(n_taps) - m / 2
    h = np.sinc(2 * cutoff * t) * 2 * cutoff
    w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n_taps) / m)
    h = h * w
    return (h / h.sum()).astype(np.float32)
