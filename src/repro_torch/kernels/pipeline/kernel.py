"""The MBioTracker pipeline as the ``"biosignal"`` stage graph.

    1. 11-tap FIR          — causal, zero history before each frame,
    2. delineation         — the mask algebra of `core.biosignal.delineate`,
    3. time features       — mean/median/RMS of the extrema intervals,
    4. 512-pt packed rFFT  — Stockham stages from a twiddle table + the
                             untangle epilogue, reduced to 6 log-band powers,
    5. linear SVM          — margin + argmax class,

and one write of the requested outputs (filtered, features, margin, class).

The stage bodies below are the plain PyTorch version (the CPU path, and
what the kernel is held to on the card). On a CUDA tensor the graph
entries launch one hand-written kernel for the whole chain,
`csrc/biosignal_graph.cu` (bound in `cuda.py`). The three
legacy-signature entries (`pipeline_frames`, `pipeline_stream`,
`pipeline_ring`) take (taps, w, b) and route through the graph entries.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.biosignal import (MIN_DISTANCE, MIN_PROMINENCE,
                                        band_edges, band_power_features,
                                        delineate, interval_time_features,
                                        make_app, svm_predict)
from repro_torch.core.fft import fft_stages, untangle_rfft
from repro_torch.kernels.fft.kernel import twiddle_table
from repro_torch.kernels.pipeline import cuda
from repro_torch.kernels.pipeline.graph import (OutputSpec, build_graph,
                                                canonical_graph_outputs,
                                                graph_empty_outputs,
                                                graph_frames_call,
                                                graph_ring_call,
                                                graph_stream_call,
                                                register_graph_factory)
from repro_torch.kernels.pipeline.stages import register_stage

OUTPUTS = ("filtered", "features", "margin", "class")
N_FEATURES = 12


def untangle_table(fft_size: int) -> np.ndarray:
    """(2, m) packed untangle factors e^{-2*pi*i*k/N} for the real-FFT
    epilogue."""
    m = fft_size // 2
    ang = -2.0 * np.pi * np.arange(m) / fft_size
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fft_tables(fft_size: int, device: torch.device) -> tuple:
    """(twiddle_re, twiddle_im, untangle) on ``device``, built once."""
    m = fft_size // 2
    if fft_size < 4 or m & (m - 1):
        raise ValueError(f"fft_size={fft_size} must be a power of 2 >= 4")
    wr, wi = twiddle_table(m)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (wr, wi, untangle_table(fft_size)))


def _packed_rfft(seg, wr, wi, u):
    """Packed real FFT of (rb, fft_size) rows from the twiddle table: N
    real -> N/2+1 complex via Stockham stages on the packed half-length
    signal + the untangle epilogue — the stage order the kernels run."""
    zr, zi = seg[:, 0::2], seg[:, 1::2]            # pack: z = even + i*odd
    re, im = fft_stages(zr, zi, table=(wr, wi))
    return untangle_rfft(re, im, u[0], u[1])


def _rfft_band_powers(seg, wr, wi, u, *, fft_size: int) -> list:
    """Mean-subtracted `_packed_rfft` power reduced to the 6 log-band
    powers of `core.biosignal.extract_features`."""
    seg = seg - seg.mean(dim=-1, keepdim=True)
    Xr, Xi = _packed_rfft(seg, wr, wi, u)
    return band_power_features(Xr * Xr + Xi * Xi, fft_size)


def canonical_outputs(outputs) -> tuple:
    """Validate + canonically order an output selection. `None` means all
    four app outputs; any subset elides the unrequested writes (the
    (R, S) `filtered` write is by far the largest)."""
    return canonical_graph_outputs(biosignal_graph(11, N_FEATURES, 2, 512),
                                   outputs)


def empty_outputs(window: int, F: int, C: int, dtype, outputs=None,
                  device="cuda") -> dict:
    """The zero-frame result, with the SAME keys/shapes/dtypes as a
    non-empty call, on ``device`` (raises for the default ``"cuda"`` on a
    host without a card)."""
    return graph_empty_outputs(biosignal_graph(11, F, C, 512), window, dtype,
                               outputs, device)


# ---------------------------------------------------------------------------
# The biosignal app as a registered stage graph
# ---------------------------------------------------------------------------

@register_stage("delineate", requires=("filtered",),
                produces=("is_max", "is_min"))
def _delineate_body(state, tables, params):
    """Delineation mask algebra (`core.biosignal.delineate`)."""
    is_max, is_min = delineate(state["filtered"])
    return {"is_max": is_max, "is_min": is_min}


@register_stage("biosignal_features",
                operands=("twiddle_re", "twiddle_im", "untangle"),
                requires=("filtered", "is_max", "is_min"),
                produces=("features",))
def _features_body(state, tables, params):
    """Interval time features (exact lower median) + packed-rFFT band
    powers, stacked to (rb, 12)."""
    f_time = interval_time_features(state["is_max"], state["is_min"])
    f_freq = _rfft_band_powers(
        state["filtered"][:, :params["fft_size"]], tables["twiddle_re"],
        tables["twiddle_im"], tables["untangle"],
        fft_size=params["fft_size"])
    return {"features": torch.stack(f_time + f_freq, dim=-1)}


@register_stage("svm", operands=("svm_w", "svm_b"), requires=("features",),
                produces=("margin", "class"))
def _svm_body(state, tables, params):
    """Linear SVM margin + argmax class — the epilogue stage."""
    margin, cls = svm_predict(state["features"], tables["svm_w"],
                              tables["svm_b"])
    return {"margin": margin, "class": cls}


@functools.lru_cache(maxsize=None)
def biosignal_graph(n_taps: int, n_features: int, n_classes: int,
                    fft_size: int):
    """The biosignal app as a `StageGraph`, cached per signature."""
    return build_graph(
        "biosignal",
        ("fir", "delineate", "biosignal_features", "svm"),
        (("filtered", OutputSpec(("window",), "input")),
         ("features", OutputSpec(("n_features",), "float32")),
         ("margin", OutputSpec(("n_classes",), "float32")),
         ("class", OutputSpec((), "int32"))),
        ("fir_taps", "twiddle_re", "twiddle_im", "untangle",
         "svm_w", "svm_b"),
        (("n_taps", int(n_taps)), ("fft_size", int(fft_size)),
         ("n_features", int(n_features)), ("n_classes", int(n_classes))))


def _biosignal_graph_operands(taps, w, b, fft_size: int, device):
    """(graph, operand tensors on ``device``) for a (taps, w, b) app."""
    taps, w, b = (torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in (taps, w, b))
    F, C = w.shape
    graph = biosignal_graph(int(taps.shape[0]), int(F), int(C),
                            int(fft_size))
    tw_re, tw_im, u = _fft_tables(int(fft_size), torch.device(device))
    return graph, (taps, tw_re, tw_im, u, w, b)


def _biosignal_factory(app):
    """Graph factory: bind a `core.biosignal.BiosignalApp`'s buffers (on
    the app's device) to the graph operands."""
    return _biosignal_graph_operands(app.fir_taps, app.svm_w, app.svm_b,
                                     app.fft_size, app.device)


def _biosignal_kernel(x, operands, *, graph, entry, window, n_frames,
                      frame_stride, n_slots, slot_stride, outputs,
                      block_frames, out, retired, valid_rows):
    """The graph's CUDA launcher (`graph.py:_launch` calls it)."""
    taps, tw_re, tw_im, u, w, b = operands
    if w.shape[0] != N_FEATURES:
        raise ValueError(f"the kernel computes {N_FEATURES} features, "
                         f"svm_w has {w.shape[0]} rows")
    cuda.launch_biosignal_graph(
        x, entry=entry, window=window, n_frames=n_frames,
        frame_stride=frame_stride, n_slots=n_slots, slot_stride=slot_stride,
        taps=taps, twiddle_re=tw_re, twiddle_im=tw_im, untangle=u, svm_w=w,
        svm_b=b, fft_size=graph.fft_size,
        bands=tuple(int(e) for e in band_edges(graph.fft_size)),
        prominence=MIN_PROMINENCE, min_distance=MIN_DISTANCE,
        block_frames=block_frames or 1, out=out, retired=retired,
        valid_rows=valid_rows)


register_graph_factory("biosignal", _biosignal_factory,
                       default_app=make_app, kernel=_biosignal_kernel)


# ---------------------------------------------------------------------------
# Legacy-signature entries: (taps, w, b) instead of an app
# ---------------------------------------------------------------------------

def pipeline_frames(signal, taps, w, b, *, fft_size: int = 512,
                    block_rows: int | None = None, outputs=OUTPUTS) -> dict:
    """Fused MBioTracker pipeline on (R, S) windows, S >= fft_size.
    Returns {"filtered": (R,S), "features": (R,F), "margin": (R,C),
    "class": (R,)} restricted to ``outputs``."""
    graph, operands = _biosignal_graph_operands(taps, w, b, fft_size,
                                                signal.device)
    return graph_frames_call(signal, operands, graph=graph,
                             block_rows=block_rows, outputs=outputs)


def pipeline_stream(signal, taps, w, b, *, window: int, hop: int,
                    fft_size: int = 512, block_frames: int | None = None,
                    outputs=OUTPUTS) -> dict:
    """Fused pipeline over a RAW 1-D signal with (window, hop) framing;
    equals `pipeline_frames` on the host-framed windows."""
    graph, operands = _biosignal_graph_operands(taps, w, b, fft_size,
                                                signal.device)
    return graph_stream_call(signal, operands, graph=graph, window=window,
                             hop=hop, block_frames=block_frames,
                             outputs=outputs)


def pipeline_ring(ring, taps, w, b, *, window: int, hop: int,
                  fft_size: int = 512, block_frames: int | None = None,
                  outputs=OUTPUTS) -> dict:
    """Fused pipeline over a (ring_depth, span) RING of raw chunks in one
    launch; row r equals `pipeline_stream(ring[r], ...)`."""
    graph, operands = _biosignal_graph_operands(taps, w, b, fft_size,
                                                ring.device)
    return graph_ring_call(ring, operands, graph=graph, window=window,
                           hop=hop, block_frames=block_frames,
                           outputs=outputs)
