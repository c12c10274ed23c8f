"""Oracles for the FFT kernel: `core.fft`'s Stockham path, which computes
its twiddles per stage instead of reading the kernel's table."""
from __future__ import annotations

from repro_torch.core.fft import fft as fft_ref            # noqa: F401
from repro_torch.core.fft import rfft_packed as rfft_ref   # noqa: F401
