"""Streaming ASR feature front-end: the second registered stage graph.

A log-mel filterbank front-end (what feeds a Whisper-style encoder) has
the biosignal pipeline's shape: framing -> causal FIR (pre-emphasis) ->
rFFT -> matrix-product epilogue. It is three more registered stages over
the same graph machinery (`graph.py`), run by the same three entries:

    fir (pre-emphasis, taps [1, -preemph])
      -> hann  (periodic Hann on the first fft_size samples)
      -> power_spectrum (the packed rFFT of `kernel._packed_rfft`, |X|^2,
                         with NO mean subtraction, unlike the biosignal
                         band-power stage: the DC bin stays)
      -> logmel (log1p(power @ mel_w), a slaney-style mel filterbank)

The stage bodies are the plain PyTorch version (the CPU path, and what
the kernel is held to on the card within `ASR_LOGMEL_TOL`). On a CUDA
tensor the graph entries launch one hand-written kernel for the whole
chain, `csrc/asr_graph.cu` (bound in `cuda.py`), which reads the mel
filterbank as `mel_spans`: each column's run of bins from its first
nonzero weight to its last.

`asr_reference` is the independent numpy oracle (frame-local FIR,
``np.fft.rfft`` with float64 twiddles, the mel product, log1p);
`asr_staged` is the kernel-at-a-time baseline: device framing gather,
the standalone FIR kernel (`kernels/fir`), Hann in plain PyTorch, the
standalone FFT kernel under the packed rFFT (`kernels/fft`), then the mel
product and log1p in plain PyTorch.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref

import numpy as np
import torch
from torch import nn

from repro_torch.core.fft import rfft_packed
from repro_torch.core.fir import fir_direct
from repro_torch.device import resolve_device
from repro_torch.kernels.fft.kernel import device_stockham_table
from repro_torch.kernels.pipeline import cuda
from repro_torch.kernels.pipeline.graph import (OutputSpec, build_graph,
                                                cast_output,
                                                register_graph_factory,
                                                stream_frame_count)
from repro_torch.kernels.pipeline.kernel import _fft_tables, _packed_rfft
from repro_torch.kernels.pipeline.stages import register_stage

__all__ = ["AsrFrontendApp", "make_asr_frontend", "mel_filterbank",
           "hann_window", "MelSpans", "span_table", "mel_spans",
           "asr_graph", "asr_reference", "asr_reference_frames",
           "asr_oracle64", "host_frames", "asr_staged", "ASR_LOGMEL_TOL",
           "ASR_ORACLE_UNITS"]

ASR_BLOCK_FRAMES = 8    # frames per CUDA block by default
# What the kernel's logmel is held to against the plain version's: max
# |kernel - plain| <= tol x max(1, max |plain|) over the compared rows. The
# two compute in float32 in another order (radix-16 passes with FMA against
# the radix-2 chain, the mel sums over each column's span against a
# row-wise reduction over every bin): 4.8e-7 at most over an hour of
# speech-band audio, whose logmel reaches ~2 (an H100). The plain stage
# bodies with the FFT's second pass conjugated, or every mel span one bin
# short, read 0.2-1 of max |logmel| (chip_smoke.py measures both on every
# run and fails unless this tolerance flags them).
ASR_LOGMEL_TOL = 1e-5
# What logmel is held to at any signal scale (16-bit PCM included), per
# element, against the float64 oracle `asr_oracle64`: float32's eps times
# ASR_ORACLE_UNITS x (M / (1 + m) + 1 + |logmel|), m the bin's mel power
# and M the frame's largest. Rounding the frame's spectrum in float32 moves
# every mel power by about eps x M, which log1p turns into eps x M / (1 + m)
# on a weak bin of a loud frame; the rest is logmel's own rounding.
# `tests/test_torch_kernel.py` measures the plain version against it at
# int16 and int32 full scale and a mel product with 2^-11 relative error
# above it.
ASR_ORACLE_UNITS = 16.0


# ---------------------------------------------------------------------------
# Constant tables (numpy, computed once per app)
# ---------------------------------------------------------------------------

def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (the STFT convention for ``sym=False``):
    0.5 * (1 - cos(2*pi*k/n))."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))
            ).astype(np.float32)


def _hz_to_mel(f):
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3.0)
    log_step = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10)
                                               / 1000.0) / log_step, mel)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    log_step = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(log_step * (m - 15.0)),
                    m * (200.0 / 3.0))


def mel_filterbank(fft_size: int = 512, n_mels: int = 64,
                   sample_rate: float = 16000.0, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Slaney-style triangular mel filterbank, area-normalised (the
    ``norm="slaney"`` construction), returned TRANSPOSED as
    ``(fft_size//2 + 1, n_mels)`` so the epilogue is ``power @ mel_w``."""
    fmax = sample_rate / 2.0 if fmax is None else fmax
    n_bins = fft_size // 2 + 1
    fft_hz = np.arange(n_bins) * (sample_rate / fft_size)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                     n_mels + 2))
    fb = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lo, mid, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_hz - lo) / max(mid - lo, 1e-10)
        down = (hi - fft_hz) / max(hi - mid, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)                      # slaney area norm
    return fb.T.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MelSpans:
    """The mel filterbank as the kernel reads it: column j's weights from
    its first nonzero bin ``first[j]`` to its last, at ``weights[offset[j]:
    offset[j + 1]]`` (interior zeros kept; an all-zero column is empty).
    ``power @ mel_w`` column j is then ``sum(power[first[j] + s] *
    weights[offset[j] + s])``: the same sum without its zero terms."""
    first: torch.Tensor     # (n_mels,) int32
    offset: torch.Tensor    # (n_mels + 1,) int32
    weights: torch.Tensor   # (offset[-1],) float32

    def __post_init__(self):
        n = self.first.shape[0]
        for name, t, dt, shape in (
                ("first", self.first, torch.int32, (n,)),
                ("offset", self.offset, torch.int32, (n + 1,)),
                ("weights", self.weights, torch.float32,
                 (self.weights.shape[0],))):
            if t.dtype != dt or tuple(t.shape) != shape or \
                    not t.is_contiguous() or t.device != self.first.device:
                raise ValueError(f"MelSpans.{name}: need a contiguous {dt} "
                                 f"{shape} tensor on {self.first.device}, "
                                 f"got {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")


def span_table(mel_w) -> tuple:
    """(first, offset, weights) numpy arrays of `MelSpans` for a (bins,
    n_mels) filterbank."""
    w = np.asarray(mel_w, np.float32)
    first, offset, packed = [], [0], []
    for col in w.T:
        nz = np.flatnonzero(col)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        first.append(lo)
        packed.append(col[lo:hi])
        offset.append(offset[-1] + hi - lo)
    return (np.asarray(first, np.int32), np.asarray(offset, np.int32),
            np.concatenate(packed).astype(np.float32))


# id(mel_w) -> (weak reference to mel_w, its _version, spans); an entry
# leaves when its tensor is freed, before the id can be reused
_SPANS: dict = {}


def mel_spans(mel_w: torch.Tensor) -> MelSpans:
    """`span_table` of ``mel_w`` on its device, built once per tensor and
    version: later calls add no copy and no sync (a dispatch pays a dict
    lookup), and an in-place edit of ``mel_w`` (which bumps its
    ``_version``) rebuilds it."""
    key = id(mel_w)
    hit = _SPANS.get(key)
    if hit is not None and hit[0]() is mel_w and hit[1] == mel_w._version:
        return hit[2]
    spans = MelSpans(*(torch.as_tensor(a, device=mel_w.device)
                       for a in span_table(mel_w.detach().cpu().numpy())))
    ref = weakref.ref(mel_w, lambda _, key=key: _SPANS.pop(key, None))
    _SPANS[key] = (ref, mel_w._version, spans)
    return spans


# ---------------------------------------------------------------------------
# The three ASR map stages (the "fir" stage is shared — graph.py)
# ---------------------------------------------------------------------------

@register_stage("hann", operands=("hann",), requires=("filtered",),
                produces=("windowed",))
def _hann_body(state, tables, params):
    """Periodic Hann on the first fft_size samples of each pre-emphasised
    frame (the full frame stays in ``filtered``), so the stage holds for
    any window >= fft_size."""
    return {"windowed":
            state["filtered"][:, :params["fft_size"]] * tables["hann"][0]}


@register_stage("power_spectrum",
                operands=("twiddle_re", "twiddle_im", "untangle"),
                requires=("windowed",), produces=("power",))
def _power_body(state, tables, params):
    """|rFFT|^2 of the windowed segment through the shared packed rFFT,
    without mean subtraction."""
    Xr, Xi = _packed_rfft(state["windowed"], tables["twiddle_re"],
                          tables["twiddle_im"], tables["untangle"])
    return {"power": Xr * Xr + Xi * Xi}


@register_stage("logmel", operands=("mel_w",), requires=("power",),
                produces=("logmel",))
def _logmel_body(state, tables, params):
    """log1p(power @ mel_w): ``log1p`` keeps silent frames finite. Each
    mel sum reduces its own row's products, so a frame's result does not
    depend on which other frames share the call (a matrix product may
    block its sums by the number of rows)."""
    mel_t = tables["mel_w"].t().contiguous()       # (n_mels, bins)
    return {"logmel": torch.log1p(
        (state["power"].unsqueeze(-2) * mel_t).sum(-1))}


@functools.lru_cache(maxsize=None)
def asr_graph(n_taps: int, fft_size: int, n_mels: int):
    """The ASR front-end `StageGraph`: outputs ``filtered`` (the
    pre-emphasised frames, the big elidable write) and ``logmel`` (the
    (n, n_mels) features an encoder consumes)."""
    return build_graph(
        "asr",
        ("fir", "hann", "power_spectrum", "logmel"),
        (("filtered", OutputSpec(("window",), "input")),
         ("logmel", OutputSpec(("n_mels",), "float32"))),
        ("fir_taps", "hann", "twiddle_re", "twiddle_im", "untangle",
         "mel_w"),
        (("n_taps", int(n_taps)), ("fft_size", int(fft_size)),
         ("n_mels", int(n_mels))))


# ---------------------------------------------------------------------------
# The application
# ---------------------------------------------------------------------------

class AsrFrontendApp(nn.Module):
    """Streaming ASR front-end parameters and tables; the tables are
    buffers, so `.to(device)` moves the whole app.

    ``fir_taps`` is the pre-emphasis ``[1, -preemph]`` (`core.fir`
    convention ``y[t] = sum taps[i] * x[t-i]``); ``hann`` the periodic
    window of ``fft_size``; ``mel_weights`` the (fft_size//2 + 1, n_mels)
    filterbank. `forward` is the staged front-end in plain PyTorch."""

    def __init__(self, preemph: float = 0.97, fft_size: int = 512,
                 n_mels: int = 64, sample_rate: float = 16000.0,
                 fmin: float = 0.0, fmax: float | None = None):
        super().__init__()
        self.preemph = float(preemph)
        self.fft_size = int(fft_size)
        self.n_mels = int(n_mels)
        self.sample_rate = float(sample_rate)
        self.fmin = float(fmin)
        self.fmax = fmax
        self.register_buffer("fir_taps", torch.as_tensor(
            np.array([1.0, -self.preemph], np.float32)))
        self.register_buffer("hann", torch.as_tensor(
            hann_window(self.fft_size)))
        self.register_buffer("mel_weights", torch.as_tensor(
            np.ascontiguousarray(mel_filterbank(
                self.fft_size, self.n_mels, self.sample_rate, self.fmin,
                self.fmax))))

    @property
    def device(self) -> torch.device:
        return self.fir_taps.device

    def forward(self, frames: torch.Tensor) -> dict:
        """The front-end on pre-framed (n, window) windows, stage by
        stage in plain PyTorch (core FIR, Hann, `core.fft.rfft_packed`,
        mel product, log1p)."""
        filtered = fir_direct(frames.float(), self.fir_taps)
        Xr, Xi = rfft_packed(filtered[:, :self.fft_size] * self.hann)
        logmel = torch.log1p(torch.matmul(Xr * Xr + Xi * Xi,
                                          self.mel_weights))
        return {"filtered": cast_output(filtered, frames.dtype),
                "logmel": logmel}


def make_asr_frontend(device="cuda", **kw) -> AsrFrontendApp:
    """Default ASR front-end on ``device``: 16 kHz, 512-point FFT, 64
    slaney mel bands (the whisper-style configuration of
    `examples/asr_frontend.py`)."""
    return AsrFrontendApp(**kw).to(resolve_device(device))


def _asr_factory(app: AsrFrontendApp):
    """Graph factory: bind the app's buffers (on the app's device) to the
    graph's operands, with the biosignal graph's twiddle/untangle tables."""
    wr, wi, u = _fft_tables(app.fft_size, app.device)
    operands = (app.fir_taps, app.hann.reshape(1, app.fft_size), wr, wi, u,
                app.mel_weights)
    return asr_graph(int(app.fir_taps.shape[0]), app.fft_size,
                     app.n_mels), operands


def _asr_kernel(x, operands, *, graph, entry, window, n_frames,
                frame_stride, n_slots, slot_stride, outputs, block_frames,
                out, retired, valid_rows):
    """The graph's CUDA launcher (`graph.py:_launch` calls it): the
    kernel takes the FFT's radix-16 twiddle table (`kernels/fft`'s
    `stockham_table`) in place of the radix-2 one and the mel filterbank
    as its cached `mel_spans`."""
    taps, hann, _, _, u, mel_w = operands
    fft_size = graph.fft_size
    if mel_w.ndim != 2 or mel_w.shape[0] != fft_size // 2 + 1:
        raise ValueError(f"mel_w: need ({fft_size // 2 + 1}, n_mels) for "
                         f"fft_size {fft_size}, got {tuple(mel_w.shape)}")
    cuda.launch_asr_graph(
        x, entry=entry, window=window, n_frames=n_frames,
        frame_stride=frame_stride, n_slots=n_slots, slot_stride=slot_stride,
        taps=taps, hann=hann,
        twiddles=device_stockham_table(fft_size // 2, x.device),
        untangle=u, spans=mel_spans(mel_w), fft_size=fft_size,
        block_frames=block_frames or ASR_BLOCK_FRAMES, out=out,
        retired=retired, valid_rows=valid_rows)


def asr_block_pool(graph) -> tuple:
    """(default, largest useful) frames a block of the ASR kernel: a
    frame takes fft_size / 32 threads and a block at most 512
    (`asr_graph.cu`'s ``kMaxThreads``); more frames a block only loop."""
    return ASR_BLOCK_FRAMES, max(1, 512 // max(1, graph.fft_size // 32))


register_graph_factory("asr", _asr_factory, default_app=make_asr_frontend,
                       kernel=_asr_kernel, block_pool=asr_block_pool)


# ---------------------------------------------------------------------------
# Numpy oracle (independent numerics: float64 np.fft) + staged baseline
# ---------------------------------------------------------------------------

def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def asr_reference_frames(app: AsrFrontendApp, frames) -> dict:
    """Host oracle on pre-framed (n, window) windows: frame-local
    pre-emphasis (zero history per frame), periodic Hann, ``np.fft.rfft``
    (float64 twiddles, independent of the kernels' packed Stockham path),
    the slaney mel product, log1p. Numpy in, numpy out."""
    x = np.asarray(frames, np.float32)
    n, window = x.shape
    taps = _np(app.fir_taps)
    k = len(taps)
    xp = np.pad(x, ((0, 0), (k - 1, 0)))
    filt = np.zeros_like(x)
    for i in range(k):
        filt += taps[i] * xp[:, k - 1 - i: k - 1 - i + window]
    windowed = filt[:, :app.fft_size] * _np(app.hann)
    power = np.abs(np.fft.rfft(windowed, axis=-1)) ** 2
    logmel = np.log1p(power.astype(np.float32) @ _np(app.mel_weights))
    return {"filtered": filt, "logmel": logmel.astype(np.float32)}


def asr_oracle64(app: AsrFrontendApp, signal, *, window: int,
                 hop: int) -> tuple:
    """(logmel, limit): the front-end over a raw 1-D signal in float64
    (the signal widened to float32, as the kernels read it, then every
    step in float64), and the per-element limit of `ASR_ORACLE_UNITS`
    that a float32 logmel is held to. Numpy in, numpy out."""
    x = host_frames(np.asarray(_np(signal), np.float32).astype(np.float64),
                    window, hop)
    taps = _np(app.fir_taps).astype(np.float64)
    k = len(taps)
    xp = np.pad(x, ((0, 0), (k - 1, 0)))
    filt = sum(taps[i] * xp[:, k - 1 - i: k - 1 - i + window]
               for i in range(k))
    windowed = filt[:, :app.fft_size] * _np(app.hann).astype(np.float64)
    power = np.abs(np.fft.rfft(windowed, axis=-1)) ** 2
    mel = power @ _np(app.mel_weights).astype(np.float64)
    logmel = np.log1p(mel)
    top = mel.max(axis=-1, keepdims=True) if mel.size else mel
    eps = float(np.finfo(np.float32).eps)
    limit = ASR_ORACLE_UNITS * eps * (top / (1.0 + mel) + 1.0 +
                                      np.abs(logmel))
    return logmel, limit


def host_frames(signal, window: int, hop: int) -> np.ndarray:
    """Host-side (window, hop) framing gather of a numpy signal (each
    sample duplicated ~window/hop times)."""
    sig = np.asarray(signal)
    n = stream_frame_count(sig.shape[0], window, hop)
    idx = np.arange(n)[:, None] * hop + np.arange(window)[None, :]
    return sig[idx] if n else np.zeros((0, window), sig.dtype)


def asr_reference(app: AsrFrontendApp, signal, *, window: int,
                  hop: int) -> dict:
    """Host oracle over a raw 1-D signal: frame on the host, then
    `asr_reference_frames`. A zero-frame signal gives empty (0, ...)
    results."""
    return asr_reference_frames(app, host_frames(signal, window, hop))


def asr_staged(app: AsrFrontendApp, signal: torch.Tensor, *, window: int,
               hop: int) -> dict:
    """The kernel-at-a-time baseline, on the signal's device: framing
    gather -> standalone FIR kernel -> Hann -> standalone FFT kernel under
    the packed rFFT -> mel product and log1p. Every arrow is a round trip
    through device memory; the fused graph is one launch over the raw
    signal. The mel product is `torch.matmul`, in full float32 unless the
    caller turned on TF32 (`torch.backends.cuda.matmul.allow_tf32`, off by
    default)."""
    from repro_torch.kernels.fft.ops import rfft
    from repro_torch.kernels.fir.ops import fir

    signal = torch.as_tensor(signal)
    if signal.ndim != 1:
        raise ValueError(f"signal must be 1-D, got {tuple(signal.shape)}")
    n = stream_frame_count(signal.shape[0], window, hop)
    if n == 0:
        return {"filtered": signal.new_zeros((0, window)),
                "logmel": torch.zeros((0, app.n_mels), device=signal.device)}
    frames = signal.unfold(0, window, hop).contiguous()
    filt = fir(frames, app.fir_taps)
    Xr, Xi = rfft(filt[:, :app.fft_size] * app.hann)
    logmel = torch.log1p(torch.matmul(Xr * Xr + Xi * Xi, app.mel_weights))
    return {"filtered": filt, "logmel": logmel}
