"""The batched complex FFT kernel (`csrc/fft.cu`) and its plain version.

`fft_cuda` launches the hand-written kernel for Hopper on CUDA tensors:
radix-16 Stockham passes held in registers, one exchange through shared
memory between passes, 16-byte global loads and stores, twiddles from
`stockham_table` (see the source's header), for N up to `ROW_MAX_N`; past
it, up to `MAX_N`, the four-step transform in two launches
(`four_step_plan`, `four_step_table`, `four_step_model`), each counted as
its own entry: tiles of `FOUR_STEP_LINES` lines, a line shared by a
thread-block cluster of up to `MAX_CLUSTER` blocks. `fft_plain` is the radix-2 Stockham chain in plain PyTorch
(`core.fft.fft_stages` given `twiddle_table`), the CPU path and what the
kernel is held to on the card within `FFT_TOL`. Both take float32,
bfloat16 and float16 (float64 narrowed to float32 first, as the
reference stages it), compute in float32 and return the input's type;
the inverse transform divides by N.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.fft import fft_stages
from repro_torch.kernels import _cuda, staged_signal

__all__ = ["FFT_TOL", "ROW_MAX_N", "MAX_N", "ENTRIES", "FOUR_STEP_LINES",
           "FOUR_STEP_BLOCK_POINTS", "MAX_CLUSTER", "FourStepPass",
           "twiddle_table", "device_twiddles", "stockham_plan",
           "stockham_table", "device_stockham_table", "four_step_pass",
           "four_step_plan", "four_step_twiddles", "four_step_split",
           "four_step_table", "device_four_step_table", "four_step_model",
           "threads_per_row", "default_block_rows", "fft_plain", "fft_cuda"]

# the dtypes the kernel takes, and their codes in the source
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
ROW_MAX_N = 8192        # one launch: a block keeps its rows in shared memory
MAX_N = 1 << 26         # four-step: N1 x N2 lines of at most ROW_MAX_N
MAX_THREADS = 512       # the kernel's launch bound
FOUR_STEP_LINES = 16    # lines of a four-step tile (kFourStepLines)
FOUR_STEP_BLOCK_POINTS = 4096   # a four-step block's least points
MAX_CLUSTER = 8         # blocks of a cluster sharing a tile's lines
# the counted entries: the one-launch kernel, the four-step's two passes
ENTRIES = ("rows", "four_step_columns", "four_step_rows")
# What the kernel is held to against `fft_plain`: max |kernel - plain| <=
# tol x max |plain|, per dtype. The two compute in float32 in another order
# (radix 16 with FMA, and past ROW_MAX_N the four-step's twiddle product,
# against radix 2 without): ~1e-6 of the largest output, so 1e-4 in
# float32. In bfloat16 both round float32 values that close once each, so
# they differ by at most one bfloat16 step, <= 2^-7 x max |plain| ~ 7.8e-3:
# 1e-2. In float16 the same with one float16 step, <= 2^-10 x max |plain|
# ~ 9.8e-4, plus the float32 difference: 2e-3 (float16's range, 65504,
# bounds the outputs: unit-scale inputs of N points reach ~4 sqrt(N)).
FFT_TOL = {"float32": 1e-4, "bfloat16": 1e-2, "float16": 2e-3}

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_cuda.declare("fft", Path(__file__).resolve().parent / "csrc" / "fft.cu",
              ENTRIES, {
    # re, im, twiddle table, out re/im, R, N, rows per block, inverse,
    # dtype, stream
    "fft_launch": ([_p, _p, _p, _p, _p, _ll, _i, _i, _i, _i, _p], _i),
    "fft_smem_bytes": ([_i, _i], ctypes.c_size_t),
    "fft_threads_per_row": ([_i], _i),
    "fft_table_size": ([_i], _i),
    # re, im, tables, scratch re/im, out re/im, R, N, pass, inverse, dtype,
    # stream
    "fft_four_step_launch": ([_p, _p, _p, _p, _p, _p, _p, _ll, _i, _i, _i,
                              _i, _p], _i),
    "fft_four_step_smem_bytes": ([_i, _i], ctypes.c_size_t),
    "fft_four_step_table_size": ([_i], _i),
    "fft_four_step_cluster": ([_i, _i], _i),
    "fft_four_step_threads": ([_i, _i], _i),
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


def _check(re: torch.Tensor, im: torch.Tensor) -> tuple:
    """(re, im, N), float64 planes narrowed to float32 (`staged_signal`)."""
    if re.ndim != 2 or re.shape != im.shape:
        raise ValueError(f"re/im must be two (R, N) arrays of one shape, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    re, im = staged_signal(re), staged_signal(im)
    if re.dtype not in DTYPES or im.dtype != re.dtype:
        raise ValueError(f"the FFT takes float32, bfloat16 or float16 re/im "
                         f"(float64 narrowed) of one dtype, got {re.dtype} "
                         f"and {im.dtype}")
    n = re.shape[-1]
    if n < 2 or n & (n - 1):
        raise ValueError(f"N={n} not a power of 2 >= 2")
    return re, im, n


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


class FourStepPass(NamedTuple):
    """One pass of the four-step transform: its lines of ``line`` points,
    ``FOUR_STEP_LINES`` a tile, shared by a cluster of ``cluster`` blocks
    that each load ``sub`` = line / cluster points of every line and
    transform that many; ``threads`` a block."""
    line: int
    cluster: int
    sub: int
    threads: int


def four_step_pass(line: int) -> FourStepPass:
    """The pass over lines of ``line`` points: the tile's points over
    `FOUR_STEP_BLOCK_POINTS` blocks, at most `MAX_CLUSTER` (`fft.cu`'s
    ``log_cluster``), 16 points a thread up to `MAX_THREADS`."""
    cluster = max(1, min(MAX_CLUSTER, FOUR_STEP_LINES * line //
                         FOUR_STEP_BLOCK_POINTS))
    sub = line // cluster
    return FourStepPass(line, cluster, sub,
                        min(MAX_THREADS, FOUR_STEP_LINES * sub // 16))


def four_step_plan(n: int) -> tuple:
    """The two passes of the four-step transform of N = n > `ROW_MAX_N`
    points: over columns of N1 = 2^ceil(lg/2) points, then rows of N2 =
    2^floor(lg/2) (`four_step_pass` each)."""
    lg = n.bit_length() - 1
    return four_step_pass(1 << (lg + 1) // 2), four_step_pass(1 << lg // 2)


def _unit(j: np.ndarray, m: int) -> np.ndarray:
    """(cos, sin) of -2 pi j / m as (len(j), 2) float32, computed in
    float64 and cast once."""
    ang = -2.0 * np.pi * j / m
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def four_step_twiddles(n: int) -> tuple:
    """The four-step's inter-pass factors for N = n, (N1, 2) and (N2, 2)
    float32 (cos, sin) tables computed in float64 and cast once: ``fine[j]
    = W_N^j`` for j < N1 and ``coarse[j] = W_N^(j N1)`` for j < N2, so
    that W_N^e = coarse[e // N1] fine[e % N1] for any e = n2 k1 < N."""
    p1, p2 = four_step_plan(n)
    n1, n2 = p1.line, p2.line
    return _unit(np.arange(n1), n), _unit(np.arange(n2) * n1, n)


def four_step_split(line: int) -> np.ndarray:
    """W_L^j for j < L = ``line``, (L, 2) float32 from float64: the
    cluster's radix-K step takes W_K^(j h) = W_L^(j h L / K) and the
    twiddle W_L^(n h) of its share's point n from it."""
    return _unit(np.arange(line), line)


def four_step_table(n: int) -> np.ndarray:
    """The four-step kernel's (M, 2) float32 table for N = n: the
    sub-lines' `stockham_table` of pass 1 and of pass 2, the radix-K
    steps' `four_step_split` of N1 and of N2 points, then
    `four_step_twiddles`' fine and coarse factors."""
    p1, p2 = four_step_plan(n)
    return np.concatenate([stockham_table(p1.sub), stockham_table(p2.sub),
                           four_step_split(p1.line),
                           four_step_split(p2.line),
                           *four_step_twiddles(n)])


@functools.lru_cache(maxsize=None)
def device_four_step_table(n: int, device: torch.device) -> torch.Tensor:
    """`four_step_table` as a float32 tensor on ``device``, built once."""
    return torch.as_tensor(four_step_table(n), device=device)


def _cmul(ar, ai, br, bi) -> tuple:
    return ar * br - ai * bi, ar * bi + ai * br


def _line_transform(xr: torch.Tensor, xi: torch.Tensor,
                    p: FourStepPass) -> tuple:
    """The kernel's transform of the rows of (rows, L) float32 planes
    over a cluster of K = ``p.cluster``: the radix-K step y_h[n] = W_L^(n
    h) sum_j x[n + j M] W_K^(j h) from `four_step_split`, the M-point
    transform of each y_h (`fft_plain`), point k' of y_h at K k' + h."""
    K, M = p.cluster, p.sub
    if K == 1:
        return fft_plain(xr, xi)
    rows = xr.shape[0]
    split = torch.as_tensor(four_step_split(p.line), device=xr.device)
    xr, xi = xr.reshape(rows, K, M), xi.reshape(rows, K, M)
    out_r = torch.empty(rows, M, K, device=xr.device)
    out_i = torch.empty(rows, M, K, device=xr.device)
    n = torch.arange(M, device=xr.device)
    for h in range(K):
        yr, yi = xr[:, 0].clone(), xi[:, 0].clone()
        for j in range(1, K):
            w = split[((j * h) % K) * M]
            tr, ti = _cmul(xr[:, j], xi[:, j], w[0], w[1])
            yr, yi = yr + tr, yi + ti
        if h:
            w = split[n * h]
            yr, yi = _cmul(yr, yi, w[:, 0], w[:, 1])
        out_r[..., h], out_i[..., h] = fft_plain(yr, yi)
    return out_r.reshape(rows, -1), out_i.reshape(rows, -1)


def _inter_pass_twiddle(n: int, device) -> tuple:
    """W_N^(n2 k1) as (N2, N1) float32 planes, as the kernel forms it: the
    product coarse[e // N1] fine[e % N1] (e = n2 k1) at each column n2 a
    multiple of 4, times fine[k1] = W_N^k1 once for each column after it
    (the 4 columns of a 16-byte vector of the scratch)."""
    p1, p2 = four_step_plan(n)
    n1, n2 = p1.line, p2.line
    fine, coarse = (torch.as_tensor(t, device=device)
                    for t in four_step_twiddles(n))
    k1 = torch.arange(n1, device=device)
    e = (torch.arange(0, n2, 4, device=device)[:, None] * k1[None, :])
    f, c = fine[e % n1], coarse[e // n1]
    wr = c[..., 0] * f[..., 0] - c[..., 1] * f[..., 1]
    wi = c[..., 0] * f[..., 1] + c[..., 1] * f[..., 0]
    sr, si = fine[k1, 0], fine[k1, 1]
    cols_r, cols_i = [wr], [wi]
    for _ in range(3):
        wr, wi = _cmul(wr, wi, sr, si)
        cols_r.append(wr)
        cols_i.append(wi)
    return (torch.stack(cols_r, 1).reshape(n2, n1),
            torch.stack(cols_i, 1).reshape(n2, n1))


def four_step_model(re: torch.Tensor, im: torch.Tensor, *,
                    inverse: bool = False, twiddle: bool = True) -> tuple:
    """The four-step decomposition the kernel runs past `ROW_MAX_N`, in
    plain PyTorch on float32 planes of any device: column transforms of N1
    points and row transforms of N2 (each as `_line_transform`: the
    cluster's radix-K step, then its M-point transforms), the inter-pass
    factor W_N^(n2 k1) between them as the kernel forms it from
    `four_step_twiddles` (`_inter_pass_twiddle`; left out with
    ``twiddle=False``, a wrong
    transform the checks must flag), and the transposed store; the
    inverse through the swap ifft(x) = swap(fft(swap(x))) / N, as in the
    kernel."""
    R, n = re.shape
    p1, p2 = four_step_plan(n)
    n1, n2 = p1.line, p2.line
    a, b = (im, re) if inverse else (re, im)
    # pass 1: column n2 holds x[N2 n1 + n2]
    cr, ci = _line_transform(a.float().reshape(R, n1, n2).transpose(1, 2)
                             .reshape(R * n2, n1),
                             b.float().reshape(R, n1, n2).transpose(1, 2)
                             .reshape(R * n2, n1), p1)
    if twiddle:
        wr, wi = _inter_pass_twiddle(n, re.device)
        cr, ci = cr.reshape(R, n2, n1), ci.reshape(R, n2, n1)
        cr, ci = cr * wr - ci * wi, cr * wi + ci * wr
    # pass 2: row k1 holds scratch[k1 N2 + n2]; point k2 goes to k1 + N1 k2
    rr, ri = _line_transform(cr.reshape(R, n2, n1).transpose(1, 2)
                             .reshape(R * n1, n2),
                             ci.reshape(R, n2, n1).transpose(1, 2)
                             .reshape(R * n1, n2), p2)
    rr = rr.reshape(R, n1, n2).transpose(1, 2).reshape(R, n)
    ri = ri.reshape(R, n1, n2).transpose(1, 2).reshape(R, n)
    if inverse:
        rr, ri = ri / n, rr / n
    return rr, ri


def fft_plain(re: torch.Tensor, im: torch.Tensor, *,
              inverse: bool = False) -> tuple:
    """The kernel's function in plain PyTorch, on any device."""
    re, im, n = _check(re, im)
    table = device_twiddles(n, inverse, re.device)
    rr, ri = fft_stages(re.float(), im.float(), table=table)
    if inverse:
        rr, ri = rr / n, ri / n
    return rr.to(re.dtype), ri.to(re.dtype)


def default_block_rows(n: int) -> int:
    """Rows per block: 128 threads' worth (one row of N/16 threads from N =
    2048; 1 past `ROW_MAX_N`, where the four-step's blocks take tiles of
    lines of their own). At N = 256, 4 and 8 rows ran as fast as 16 and 32 over
    359,997 rows and 2-4% faster over 10,797 (tools/fft_variants.py on an
    H100)."""
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
    returns new (re, im) planes of the input's dtype. Up to `ROW_MAX_N`
    one launch: ``block_rows`` is the rows one CUDA block takes (default
    `default_block_rows`); a block has ``block_rows x threads_per_row(N)``
    threads, at most 512. Past it, up to `MAX_N`, the four-step transform
    in two launches through a float32 scratch of the planes' size, whose
    blocks take tiles of lines (`four_step_plan`) whatever ``block_rows``
    says."""
    re, im, n = _check(re, im)
    _cuda.check_cuda_input(re, tuple(DTYPES))
    if im.device != re.device:
        raise ValueError(f"re on {re.device}, im on {im.device}")
    if n > MAX_N:
        raise ValueError(f"N={n} > {MAX_N}: the four-step transform's "
                         f"lines hold at most {ROW_MAX_N} points each")
    if block_rows is not None and block_rows < 1:
        raise ValueError(f"block_rows {block_rows} must be positive")
    if n > ROW_MAX_N:
        return _four_step(_aligned(re, n), _aligned(im, n), inverse)
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


def _four_step(re: torch.Tensor, im: torch.Tensor, inverse: bool) -> tuple:
    """The two launches of the four-step transform over contiguous CUDA
    planes, N past `ROW_MAX_N`: the columns into a float32 scratch, then
    the rows out of it, each counted as its own entry."""
    R, n = re.shape
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    if R == 0:
        return out_re, out_im
    lib = _cuda.library("fft")
    for p in (0, 1):
        _cuda.check_smem("fft", lib.fft_four_step_smem_bytes(n, p),
                         f"four-step pass {p} of N={n}")
    tables = device_four_step_table(n, re.device)
    scratch = torch.empty((2, R, n), dtype=torch.float32, device=re.device)
    for p, entry in enumerate(ENTRIES[1:]):
        _cuda.launch("fft", entry, re, "fft_four_step_launch",
                     re.data_ptr(), im.data_ptr(), tables.data_ptr(),
                     scratch[0].data_ptr(), scratch[1].data_ptr(),
                     out_re.data_ptr(), out_im.data_ptr(), R, n, p,
                     int(inverse), DTYPES[re.dtype])
    return out_re, out_im
