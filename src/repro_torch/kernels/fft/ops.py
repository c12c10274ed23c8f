"""Public API of the standalone FFT kernel and the packed real FFT.

Both dispatch on the device of their input: a CUDA tensor launches the
kernel (`kernel.fft_cuda`), a CPU tensor runs its plain version.
``autotune=True`` comes with the port of `core/autotune.py`, a later
slice, and raises `NotImplementedError`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fft import untangle_rfft
from repro_torch.kernels import not_in_slice, on_cuda
from repro_torch.kernels.fft.kernel import fft_cuda, fft_plain

__all__ = ["fft", "rfft"]


def fft(re: torch.Tensor, im: torch.Tensor | None = None, *,
        inverse: bool = False, block_rows: int | None = None,
        autotune: bool = False) -> tuple:
    """Batched complex FFT over the rows of (R, N) float32 or bfloat16
    planes, N a power of two; computed in float32, returned in the input's
    dtype. ``inverse=True`` divides by N. ``block_rows`` is the rows one
    CUDA block takes (default 128 threads' worth; a block has block_rows x
    max(1, N/16) threads, at most 512); the CPU path ignores it."""
    not_in_slice(autotune)
    if im is None:
        im = torch.zeros_like(re)
    if on_cuda(re):
        return fft_cuda(re, im, inverse=inverse, block_rows=block_rows)
    return fft_plain(re, im, inverse=inverse)


def rfft(x: torch.Tensor) -> tuple:
    """Real FFT via the paper's N-real -> N/2-complex packing: evens + i*odds
    through the FFT kernel, then the untangle epilogue in plain PyTorch.
    x: (R, N) real. Returns (re, im) of length N//2 + 1."""
    n = x.shape[-1]
    zr, zi = x[..., 0::2].contiguous(), x[..., 1::2].contiguous()
    Zr, Zi = fft(zr, zi)
    m = n // 2
    ang = -2.0 * np.pi * np.arange(m) / n
    wr = torch.as_tensor(np.cos(ang), dtype=Zr.dtype, device=Zr.device)
    wi = torch.as_tensor(np.sin(ang), dtype=Zr.dtype, device=Zr.device)
    return untangle_rfft(Zr, Zi, wr, wi)
