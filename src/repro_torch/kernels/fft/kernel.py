"""The batched complex FFT kernel (`csrc/fft.cu`) and its plain version.

`fft_cuda` launches the hand-written kernel for Hopper on CUDA tensors:
radix-16 Stockham passes held in registers, one exchange through shared
memory between passes, 16-byte global loads and stores, twiddles from
`stockham_table` (see the source's header). `fft_plain` is the radix-2
Stockham chain in plain PyTorch (`core.fft.fft_stages` given
`twiddle_table`), the CPU path and what the kernel is held to on the card
within `FFT_TOL`. Both compute in float32 and return the input's type
(float32 or bfloat16); the inverse transform divides by N.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.fft import fft_stages
from repro_torch.kernels import _cuda

__all__ = ["FFT_TOL", "MAX_N", "twiddle_table", "device_twiddles",
           "stockham_plan", "stockham_table", "device_stockham_table",
           "threads_per_row", "default_block_rows", "fft_plain", "fft_cuda"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 8192            # a block keeps its rows in shared memory
MAX_THREADS = 512       # the kernel's launch bound
# What the kernel is held to against `fft_plain`: max |kernel - plain| <=
# tol x max |plain|, per dtype. The two compute in float32 in another order
# (radix 16 with FMA against radix 2 without): ~1e-6 of the largest output
# at N <= 8192, so 1e-4 in float32. In bfloat16 both round float32 values
# that close once each, so they differ by at most one bfloat16 step, <=
# 2^-7 x max |plain| ~ 7.8e-3: 1e-2.
FFT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_cuda.declare("fft", Path(__file__).resolve().parent / "csrc" / "fft.cu",
              ("rows",), {
    # re, im, twiddle table, out re/im, R, N, rows per block, inverse,
    # dtype, stream
    "fft_launch": ([_p, _p, _p, _p, _p, _ll, _i, _i, _i, _i, _p], _i),
    "fft_smem_bytes": ([_i, _i], ctypes.c_size_t),
    "fft_threads_per_row": ([_i], _i),
    "fft_table_size": ([_i], _i),
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


def stockham_plan(n: int) -> tuple:
    """The kernel's passes for N = n: ((radix, span), ...), span the
    product of the earlier radices. N <= 16 is one pass of radix N; larger
    N is radix-16 passes and, where log2 N is not a multiple of 4, one
    last pass of the rest."""
    lg = n.bit_length() - 1
    if lg <= 4:
        return ((n, 1),)
    radices = [16] * (lg // 4) + ([1 << lg % 4] if lg % 4 else [])
    spans = np.cumprod([1] + radices[:-1])
    return tuple((r, int(s)) for r, s in zip(radices, spans))


def threads_per_row(n: int) -> int:
    """Threads the kernel gives a row: each holds min(n, 16) points."""
    return max(1, n // 16)


def stockham_table(n: int) -> np.ndarray:
    """The kernel's (M, 2) float32 twiddle table for N = n: pass by pass
    (those of span Ns > 1), entry j * Ns + k holds (cos, sin) of -2 pi j k
    / (Ns R) for j < R, k < Ns, R the pass's radix; computed in float64,
    cast once."""
    blocks = []
    for radix, span in stockham_plan(n):
        if span > 1:
            jk = np.outer(np.arange(radix), np.arange(span)).ravel()
            ang = -2.0 * np.pi * jk / (span * radix)
            blocks.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
    if not blocks:
        return np.zeros((0, 2), np.float32)
    return np.concatenate(blocks).astype(np.float32)


@functools.lru_cache(maxsize=None)
def device_stockham_table(n: int, device: torch.device) -> torch.Tensor:
    """`stockham_table` as a float32 tensor on ``device``, built once."""
    return torch.as_tensor(stockham_table(n), device=device)


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
    """Rows per block: 128 threads' worth (one row of N/16 threads from N =
    2048). At N = 256, 4 and 8 rows ran as fast as 16 and 32 over 359,997
    rows and 2-4% faster over 10,797 (tools/fft_variants.py on an H100)."""
    return max(1, 128 // threads_per_row(n))


def _aligned(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` contiguous, its base on the kernel's vector width (16 bytes,
    or the row's bytes if fewer): a view that is not is copied."""
    x = x.contiguous()
    if x.data_ptr() % min(16, n * x.element_size()):
        x = x.clone()
    return x


def fft_cuda(re: torch.Tensor, im: torch.Tensor, *, inverse: bool = False,
             block_rows: int | None = None) -> tuple:
    """Launch the FFT kernel over the rows of CUDA (R, N) re/im planes;
    returns new (re, im) planes of the input's dtype. ``block_rows`` is the
    rows one CUDA block takes (default `default_block_rows`); a block has
    ``block_rows x threads_per_row(N)`` threads, at most 512."""
    n = _check(re, im)
    _cuda.check_cuda_input(re, tuple(DTYPES))
    if im.device != re.device:
        raise ValueError(f"re on {re.device}, im on {im.device}")
    if n > MAX_N:
        raise ValueError(f"N={n} > {MAX_N}: a block keeps its rows in "
                         f"shared memory")
    if block_rows is not None and block_rows < 1:
        raise ValueError(f"block_rows {block_rows} must be positive")
    if block_rows is not None and \
            block_rows * threads_per_row(n) > MAX_THREADS:
        raise ValueError(f"block_rows {block_rows} of N={n} take "
                         f"{block_rows * threads_per_row(n)} threads, more "
                         f"than {MAX_THREADS}")
    re, im = _aligned(re, n), _aligned(im, n)
    R = re.shape[0]
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    if R == 0:
        return out_re, out_im
    rows = min(block_rows or default_block_rows(n), R)
    _cuda.check_smem("fft", _cuda.library("fft").fft_smem_bytes(n, rows),
                     f"{rows} rows of N={n}")
    tw = device_stockham_table(n, re.device)
    _cuda.launch("fft", "rows", re, "fft_launch", re.data_ptr(),
                 im.data_ptr(), tw.data_ptr(), out_re.data_ptr(),
                 out_im.data_ptr(), R, n, rows, int(inverse),
                 DTYPES[re.dtype])
    return out_re, out_im
