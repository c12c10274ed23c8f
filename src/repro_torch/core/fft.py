"""Radix-2 FFT on the VWR2A shuffle-unit dataflow (paper §3.4), plain
PyTorch.

Decimation-in-frequency butterflies with the shuffle unit's *words
interleaving* regroup between stages: the regroup is self-sorting
(Stockham), so the output comes out in natural order. Real input uses the
paper's packing trick: N reals -> N/2 complex (evens + i*odds), one N/2
FFT, then an untangle pass.

Arrays are separate (re, im) float planes, the layout the fused kernel
keeps in shared memory; complex dtypes appear only in tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.shuffle import bit_reverse_indices


def _twiddle(n: int, dtype=np.float32):
    """w_n^j = exp(-2*pi*i*j/n), j < n/2, in f64 then cast (precision)."""
    j = np.arange(n // 2)
    ang = -2.0 * np.pi * j / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def fft_stages(re: torch.Tensor, im: torch.Tensor, *, inverse: bool = False,
               table=None):
    """Stockham DIF stages; natural-order output. re/im: (..., N).

    ``table`` = (wr, wi), the packed (log2 N, N/2) twiddle table the
    kernels read (stage s uses row s's first n/2 entries; for the inverse
    transform, the inverse table); ``None`` computes each stage's
    twiddles here. Both give the same float32 values."""
    n_total = re.shape[-1]
    if n_total & (n_total - 1):
        raise ValueError(f"N={n_total} not a power of 2")
    lead = re.shape[:-1]
    g = 1
    re = re[..., None, :]
    im = im[..., None, :]
    n = n_total
    stage = 0
    while n > 1:
        ar, ai = re[..., :, : n // 2], im[..., :, : n // 2]
        br, bi = re[..., :, n // 2:], im[..., :, n // 2:]
        if table is not None:
            wr, wi = table[0][stage, : n // 2], table[1][stage, : n // 2]
        else:
            wr_np, wi_np = _twiddle(n, np.float32)
            wr = torch.as_tensor(wr_np, device=re.device)
            wi = torch.as_tensor(-wi_np if inverse else wi_np,
                                 device=re.device)
        stage += 1
        t0r, t0i = ar + br, ai + bi
        dr, di = ar - br, ai - bi
        t1r = dr * wr - di * wi
        t1i = dr * wi + di * wr
        # regroup == shuffle-unit interleave to the next stage's layout
        re = torch.stack([t0r, t1r], dim=-3).reshape(*lead, 2 * g, n // 2)
        im = torch.stack([t0i, t1i], dim=-3).reshape(*lead, 2 * g, n // 2)
        g *= 2
        n //= 2
    return re.reshape(*lead, n_total), im.reshape(*lead, n_total)


def fft(re: torch.Tensor, im: torch.Tensor | None = None, *,
        inverse: bool = False):
    """Complex radix-2 FFT. re/im: (..., N) float. Returns (re, im)."""
    if im is None:
        im = torch.zeros_like(re)
    rr, ri = fft_stages(re, im, inverse=inverse)
    if inverse:
        rr = rr / rr.shape[-1]
        ri = ri / ri.shape[-1]
    return rr, ri


def fft_bitrev(re: torch.Tensor, im: torch.Tensor | None = None, *,
               inverse: bool = False):
    """The paper's in-place mapping: DIT butterflies on bit-reversed input
    (the shuffle unit's explicit `bit_reverse` pass), natural-order
    output. The same transform as `fft`, in another order of operations;
    archsim and the tests exercise it."""
    if im is None:
        im = torch.zeros_like(re)
    n_total = re.shape[-1]
    rev = torch.as_tensor(bit_reverse_indices(n_total), device=re.device)
    re, im = re[..., rev], im[..., rev]            # shuffle-unit bit-reversal
    lead = re.shape[:-1]
    n = 2
    while n <= n_total:
        rr = re.reshape(*lead, n_total // n, n)
        ri = im.reshape(*lead, n_total // n, n)
        ar, ai = rr[..., : n // 2], ri[..., : n // 2]
        br, bi = rr[..., n // 2:], ri[..., n // 2:]
        wr_np, wi_np = _twiddle(n, np.float32)
        wr = torch.as_tensor(wr_np, device=re.device)
        wi = torch.as_tensor(-wi_np if inverse else wi_np, device=re.device)
        tbr = br * wr - bi * wi
        tbi = br * wi + bi * wr
        re = torch.cat([ar + tbr, ar - tbr], dim=-1).reshape(re.shape)
        im = torch.cat([ai + tbi, ai - tbi], dim=-1).reshape(im.shape)
        n *= 2
    if inverse:
        re = re / n_total
        im = im / n_total
    return re, im


def untangle_rfft(Zr, Zi, wr, wi):
    """Untangle the packed N/2 spectrum Z into the length-(N/2 + 1) rfft:
    X[k] = (Z[k]+conj(Z[-k]))/2 - i/2 * e^{-2pi i k/N} (Z[k]-conj(Z[-k])),
    Nyquist bin X[N/2] = Re(Z[0]) - Im(Z[0]).

    wr/wi: the (m,) cos/sin of -2*pi*k/N. The single source of the epilogue
    arithmetic, shared with the graph's plain version (`kernels/pipeline`)."""
    m = Zr.shape[-1]
    idx = (-torch.arange(m, device=Zr.device)) % m  # Z[N/2 - k] with wrap
    Zcr, Zci = Zr[..., idx], -Zi[..., idx]          # conj(Z[-k])
    er, ei = (Zr + Zcr) * 0.5, (Zi + Zci) * 0.5
    or_, oi = (Zr - Zcr) * 0.5, (Zi - Zci) * 0.5
    # prod = w * o; then (-i*prod).re = prod.im, (-i*prod).im = -prod.re
    pr = wr * or_ - wi * oi
    pi = wr * oi + wi * or_
    nyq = Zr[..., :1] - Zi[..., :1]
    Xr = torch.cat([er + pi, nyq], dim=-1)
    Xi = torch.cat([ei - pr, torch.zeros_like(nyq)], dim=-1)
    return Xr, Xi


def rfft_packed(x: torch.Tensor):
    """Real-valued FFT via the paper's N-real -> N/2-complex packing.

    x: (..., N) real. Returns (re, im) of length N//2 + 1 (like np.fft.rfft).
    """
    n = x.shape[-1]
    zr, zi = x[..., 0::2], x[..., 1::2]             # pack: z = even + i*odd
    Zr, Zi = fft(zr, zi)
    m = n // 2
    ang = -2.0 * np.pi * np.arange(m) / n
    wr = torch.as_tensor(np.cos(ang), dtype=x.dtype, device=x.device)
    wi = torch.as_tensor(np.sin(ang), dtype=x.dtype, device=x.device)
    return untangle_rfft(Zr, Zi, wr, wi)


def fft_reference(x_complex: torch.Tensor):
    """Oracle via `torch.fft.fft` (tests only)."""
    X = torch.fft.fft(x_complex)
    return X.real, X.imag
