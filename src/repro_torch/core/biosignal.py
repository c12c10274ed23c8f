"""The MBioTracker biosignal application (paper §4.4.2), plain PyTorch:
preprocessing -> delineation -> feature extraction -> SVM.

  1. *Preprocessing*: 11-tap FIR low-pass over the raw signal.
  2. *Delineation*: maxima/minima of the filtered signal as mask algebra
     (the paper's predicated RC code).
  3. *Feature extraction*: mean, median and RMS of the inspiration and
     expiration intervals + 6 log-band powers of a 512-point packed real
     FFT of the filtered window.
  4. *Prediction*: linear SVM.

Every function is a plain function on tensors; `BiosignalApp` is an
`nn.Module` holding the FIR taps and SVM weights as buffers. These are the
semantics the fused kernel (`kernels/pipeline/`) is held to.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.core.fft import rfft_packed
from repro_torch.core.fir import fir_direct, lowpass_taps
from repro_torch.device import resolve_device

# delineation defaults: the fused kernel receives the same two numbers
MIN_PROMINENCE = 0.3
MIN_DISTANCE = 15


# ---------------------------------------------------------------------------
# Delineation
# ---------------------------------------------------------------------------

def _dilate(x: torch.Tensor, reduce, d: int) -> torch.Tensor:
    """Running reduce (max/min) over [t - d, t + d], edge-replicated, in
    log-steps of shifts — the morphological dilation behind the
    delineation refractory window. Equal to the reduce over the clamped
    window x[max(0, t-d) : min(S, t+d+1)], which is what the kernel does."""
    steps, span, s = [], 0, 1
    while span < d:
        steps.append(min(s, d - span))
        span += steps[-1]
        s *= 2
    fwd = bwd = x
    for s in steps:
        fwd = reduce(fwd, torch.cat(
            [fwd[..., s:], fwd[..., -1:].expand(*fwd.shape[:-1], s)], dim=-1))
        bwd = reduce(bwd, torch.cat(
            [bwd[..., :1].expand(*bwd.shape[:-1], s), bwd[..., :-s]], dim=-1))
    return reduce(fwd, bwd)


def delineate(x: torch.Tensor, *, min_prominence: float = MIN_PROMINENCE,
              min_distance: int = MIN_DISTANCE):
    """Detect local maxima/minima: strict neighbour extremum (wrap-around
    neighbours; the edges are masked anyway) + amplitude gate (x must rise
    above mean + prominence*(max-mean), resp. below) + a
    +-`min_distance`-sample refractory window.

    Returns (is_max, is_min): boolean masks over the window."""
    prev = torch.roll(x, 1, dims=-1)
    nxt = torch.roll(x, -1, dims=-1)
    mu = x.mean(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    lo = x.amin(dim=-1, keepdim=True)
    is_max = (x > prev) & (x >= nxt) & (x > mu + min_prominence * (hi - mu))
    is_min = (x < prev) & (x <= nxt) & (x < mu - min_prominence * (mu - lo))
    if min_distance > 0:
        is_max &= x >= _dilate(x, torch.maximum, min_distance)
        is_min &= x <= _dilate(x, torch.minimum, min_distance)
    # edges are never extrema
    is_max[..., 0] = is_max[..., -1] = False
    is_min[..., 0] = is_min[..., -1] = False
    return is_max, is_min


def _interval_gaps(mask: torch.Tensor):
    """Gaps between consecutive True positions as mask algebra: a running
    cummax of the last-seen True index. Returns (gaps, valid) full-window
    int64/bool tensors — position i carries the gap to its predecessor
    extremum iff valid[i]."""
    S = mask.shape[-1]
    pos = torch.arange(S, device=mask.device)
    prev = torch.cummax(torch.where(mask, pos, -1), dim=-1).values
    prev_excl = torch.cat(
        [torch.full_like(prev[..., :1], -1), prev[..., :-1]], dim=-1)
    valid = mask & (prev_excl >= 0)
    gaps = torch.where(valid, pos - prev_excl, 0)
    return gaps, valid


def _masked_intervals(mask: torch.Tensor):
    """Mean, lower median and RMS of the gaps between consecutive True
    positions. The gaps are small integers, so the f32 sums are exact in
    any order; the median is the exact k-th smallest gap, k = (n-1)//2,
    the value the reference's sorting networks return on both their
    branches."""
    gaps, valid = _interval_gaps(mask)
    nv = valid.sum(dim=-1)
    n = nv.clamp(min=1)
    g = torch.where(valid, gaps, 0).to(torch.float32)
    mean = g.sum(dim=-1) / n
    rms = torch.sqrt((g * g).sum(dim=-1) / n)
    big = mask.shape[-1] + 1
    ordered = torch.where(valid, gaps, big).sort(dim=-1).values
    med = ordered.gather(-1, ((n - 1) // 2)[..., None])[..., 0]
    med = torch.where(nv > 0, med, 0).to(torch.float32)
    return mean, med, rms


def interval_time_features(is_max: torch.Tensor, is_min: torch.Tensor
                           ) -> list:
    """The 6 time features: mean/median/RMS of the inspiration and
    expiration interval lengths."""
    return [*_masked_intervals(is_max), *_masked_intervals(is_min)]


def band_edges(fft_size: int) -> np.ndarray:
    """The 7 edges of the 6 log-ish bands over the fft/2+1 power bins."""
    return np.linspace(1, fft_size // 2 + 1, 7, dtype=int)


def band_power_features(power: torch.Tensor, fft_size: int) -> list:
    """The 6 log-band powers over a (B, fft/2+1) power spectrum."""
    bands = band_edges(fft_size)
    return [torch.log1p(power[..., a:b].sum(dim=-1))
            for a, b in zip(bands[:-1], bands[1:])]


def extract_features(filtered: torch.Tensor, fft_size: int = 512
                     ) -> torch.Tensor:
    """(B, S) filtered window -> (B, F) feature matrix (F = 12)."""
    is_max, is_min = delineate(filtered)
    f_time = interval_time_features(is_max, is_min)
    seg = filtered[..., :fft_size]
    seg = seg - seg.mean(dim=-1, keepdim=True)
    Xr, Xi = rfft_packed(seg)
    power = Xr * Xr + Xi * Xi                        # (B, fft/2+1)
    return torch.stack(f_time + band_power_features(power, fft_size), dim=-1)


def svm_predict(features: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Linear SVM margin + class. w: (F, C), b: (C,). The product is an
    explicit sum over features in index order — each row's margin is then
    independent of the batch it rides in, and the kernel sums in the same
    order. The class is the first index of the largest margin (int32)."""
    margin = features[..., 0:1] * w[0]
    for f in range(1, w.shape[0]):
        margin = margin + features[..., f:f + 1] * w[f]
    margin = margin + b
    return margin, torch.argmax(margin, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Full application
# ---------------------------------------------------------------------------

class BiosignalApp(nn.Module):
    """The staged application; its tables are buffers, so `.to(device)`
    moves the whole app."""

    def __init__(self, fir_taps, svm_w, svm_b, fft_size: int = 512):
        super().__init__()
        self.register_buffer("fir_taps",
                             torch.as_tensor(fir_taps, dtype=torch.float32))
        self.register_buffer("svm_w",
                             torch.as_tensor(svm_w, dtype=torch.float32))
        self.register_buffer("svm_b",
                             torch.as_tensor(svm_b, dtype=torch.float32))
        self.fft_size = int(fft_size)

    @property
    def device(self) -> torch.device:
        return self.fir_taps.device

    def forward(self, signal: torch.Tensor) -> dict:
        filtered = fir_direct(signal, self.fir_taps)
        feats = extract_features(filtered, self.fft_size)
        margin, cls = svm_predict(feats, self.svm_w, self.svm_b)
        return {"filtered": filtered, "features": feats,
                "margin": margin, "class": cls}


def app_from_numpy(fir_taps, svm_w, svm_b, fft_size: int = 512, *,
                   device="cuda") -> BiosignalApp:
    """The port's app from another app's parameters as numpy arrays (the
    JAX `BiosignalApp`'s ``fir_taps``/``svm_w``/``svm_b``)."""
    dev = resolve_device(device)
    return BiosignalApp(np.asarray(fir_taps, np.float32),
                        np.asarray(svm_w, np.float32),
                        np.asarray(svm_b, np.float32), fft_size).to(dev)


def make_app(cfg=None, seed: int = 0, *, device="cuda") -> BiosignalApp:
    """The default app: low-pass taps and SVM weights drawn from
    ``np.random.default_rng(seed)`` — the same draw as the reference, so
    one seed gives one set of weights in both packages."""
    from repro_torch.configs.vwr2a_biosignal import CONFIG as BIO

    cfg = cfg or BIO
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(12, cfg.svm_classes)).astype(np.float32)
    b = np.zeros((cfg.svm_classes,), np.float32)
    return app_from_numpy(lowpass_taps(cfg.fir_taps), w, b, cfg.fft_size,
                          device=device)


def synthetic_respiration(batch: int, samples: int, *, rate_hz: float = 0.3,
                          fs: float = 64.0, noise: float = 0.15,
                          seed: int = 0, device="cuda"):
    """Synthetic respiration-like signal: slow sinusoid + drift + noise.
    Drawn in numpy (the reference's draw), then moved to ``device``.
    Returns ((batch, samples) float32 signal, (batch,) int32 labels)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / fs
    rates = rate_hz * (1 + 0.3 * rng.standard_normal((batch, 1)))
    phase = rng.uniform(0, 2 * np.pi, (batch, 1))
    sig = np.sin(2 * np.pi * rates * t[None, :] + phase)
    sig += 0.2 * np.sin(2 * np.pi * 1.1 * t[None, :])     # cardiac bleed
    sig += noise * rng.standard_normal((batch, samples))
    return (torch.as_tensor(sig.astype(np.float32), device=dev),
            torch.as_tensor((rates[:, 0] > rate_hz).astype(np.int32),
                            device=dev))
