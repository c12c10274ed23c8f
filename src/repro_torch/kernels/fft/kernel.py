"""The batched complex FFT kernel (`csrc/fft.cu`) and its plain version.

`fft_cuda` launches the hand-written Stockham kernel for Hopper on CUDA
tensors; `fft_plain` is the same Stockham chain in plain PyTorch
(`core.fft.fft_stages` given the kernel's twiddle table), the CPU path
and what the kernel is held to on the card. Both compute in float32 and
return the input's type (float32 or bfloat16); the inverse transform
takes the inverse table and divides by N before the cast.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.fft import fft_stages
from repro_torch.kernels import _cuda

__all__ = ["twiddle_table", "device_twiddles", "fft_plain", "fft_cuda",
           "MAX_N"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 8192            # four float32 planes of N per row in shared memory

_p, _i = ctypes.c_void_p, ctypes.c_int
_cuda.declare("fft", Path(__file__).resolve().parent / "csrc" / "fft.cu",
              ("rows",), {
    # re, im, twiddle re/im, out re/im, R, N, rows per block, inverse,
    # dtype, stream
    "fft_launch": ([_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p], _i),
    "fft_smem_bytes": ([_i, _i], ctypes.c_size_t),
})


def twiddle_table(n: int, inverse: bool = False) -> tuple:
    """(stages, n//2) packed twiddles; stage s covers group length n >> s
    (row s holds cos/sin(-+2*pi*j/(n >> s)) tiled across the groups)."""
    stages = int(np.log2(n))
    wr = np.zeros((stages, n // 2), np.float32)
    wi = np.zeros((stages, n // 2), np.float32)
    for s in range(stages):
        m = n >> s               # current group length
        j = np.arange(m // 2)
        ang = -2.0 * np.pi * j / m
        if inverse:
            ang = -ang
        wr[s] = np.tile(np.cos(ang), n // m).astype(np.float32)
        wi[s] = np.tile(np.sin(ang), n // m).astype(np.float32)
    return wr, wi


@functools.lru_cache(maxsize=None)
def device_twiddles(n: int, inverse: bool, device: torch.device) -> tuple:
    """`twiddle_table` as float32 tensors on ``device``, built once."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in twiddle_table(n, inverse))


def _check(re: torch.Tensor, im: torch.Tensor) -> int:
    if re.ndim != 2 or re.shape != im.shape:
        raise ValueError(f"re/im must be two (R, N) arrays of one shape, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if re.dtype not in DTYPES or im.dtype != re.dtype:
        raise ValueError(f"the FFT takes float32 or bfloat16 re/im of one "
                         f"dtype, got {re.dtype} and {im.dtype}")
    n = re.shape[-1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"N={n} not a power of 2 >= 2")
    return n


def fft_plain(re: torch.Tensor, im: torch.Tensor, *,
              inverse: bool = False) -> tuple:
    """The kernel's function in plain PyTorch, on any device."""
    n = _check(re, im)
    table = device_twiddles(n, inverse, re.device)
    rr, ri = fft_stages(re.float(), im.float(), table=table)
    if inverse:
        rr, ri = rr / n, ri / n
    return rr.to(re.dtype), ri.to(re.dtype)


def default_block_rows(n: int) -> int:
    """Rows per block: ~2048 points, so each stage has ~1024 butterflies
    for the block's 256 threads."""
    return max(1, 2048 // n)


def fft_cuda(re: torch.Tensor, im: torch.Tensor, *, inverse: bool = False,
             block_rows: int | None = None) -> tuple:
    """Launch the FFT kernel over the rows of CUDA (R, N) re/im planes;
    returns new (re, im) planes of the input's dtype."""
    n = _check(re, im)
    _cuda.check_cuda_input(re, tuple(DTYPES))
    if im.device != re.device:
        raise ValueError(f"re on {re.device}, im on {im.device}")
    if n > MAX_N:
        raise ValueError(f"N={n} > {MAX_N}: the kernel keeps four float32 "
                         f"planes of N per row in shared memory")
    re, im = re.contiguous(), im.contiguous()
    R = re.shape[0]
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    if R == 0:
        return out_re, out_im
    rpb = min(block_rows or default_block_rows(n), R)
    if rpb < 1:
        raise ValueError(f"block_rows {block_rows} must be positive")
    _cuda.check_smem("fft", _cuda.library("fft").fft_smem_bytes(n, rpb),
                    f"{rpb} rows of N={n}")
    wr, wi = device_twiddles(n, inverse, re.device)
    _cuda.launch("fft", "rows", re, "fft_launch", re.data_ptr(),
                im.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                out_re.data_ptr(), out_im.data_ptr(), R, n, rpb,
                int(inverse), DTYPES[re.dtype])
    return out_re, out_im

