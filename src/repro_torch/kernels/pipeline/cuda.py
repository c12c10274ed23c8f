"""The fused graph kernels and their launchers.

  biosignal_graph — `csrc/biosignal_graph.cu`, the fused biosignal graph;
  asr_graph       — `csrc/asr_graph.cu`, the fused ASR front-end graph.

Both are declared with `kernels._cuda`, which builds, loads, launches and
counts them (``LAUNCHES[kernel][entry]``). Their entries are
``"frames"``, ``"stream"`` and ``"ring"``.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels._cuda import (check_cuda_input, check_frames,
                                       check_out, check_retired, check_smem,
                                       check_table, launch, library)
from repro_torch.kernels.fft.kernel import stockham_plan

CSRC = Path(__file__).resolve().parent / "csrc"
ENTRIES = ("frames", "stream", "ring")

# output selection bits, as in the graph sources
OUT_BITS = {
    "biosignal_graph": {"filtered": 1, "features": 2, "margin": 4,
                        "class": 8},
    "asr_graph": {"filtered": 1, "logmel": 2},
}

_p, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_cuda.declare("biosignal_graph", CSRC / "biosignal_graph.cu", ENTRIES, {
    "biosignal_graph_launch": ([
        _p, _ll, _ll, _i, _i, _i, _i,              # x, framing
        _p, _i, _p, _p, _p, _i,                    # taps, fft tables
        _p, _p, _i, _i, ctypes.POINTER(_i),        # svm, sizes, bands
        _f, _i,                                    # delineation
        _p, _p, _p, _p,                            # outputs
        _p, _i, _i, _p], _i),                      # retire, flags, stream
    "biosignal_graph_smem_bytes": ([_i, _i], ctypes.c_size_t),
})
_cuda.declare("asr_graph", CSRC / "asr_graph.cu", ENTRIES, {
    "asr_graph_launch": ([
        _p, _ll, _ll, _i, _i, _i, _i,              # x, framing
        _p, _i, _p, _p, _p, _i,                    # taps, hann, fft
        _p, _p, _p, _i, _i,                        # mel spans, n_mels
        _p, _p,                                    # outputs
        _p, _i, _i, _p], _i),                      # retire, flags, stream
    "asr_graph_smem_bytes": ([_i, _i, _i, _i], ctypes.c_size_t),
})
# the longest window the biosignal kernel takes (kMaxWindow in the source:
# sample positions and gaps are 15-bit there)
BIOSIGNAL_MAX_WINDOW = 32767
# the largest fft_size the ASR kernel takes (2 << kMaxLog in the source): a
# frame of m = fft_size / 2 points on m / 16 threads, at most 512
ASR_MAX_FFT_SIZE = 16384


def _graph_outputs(kernel: str, out: dict, want: dict, device) -> tuple:
    """(flags, {name: pointer}) of the requested graph outputs."""
    flags, ptrs = 0, {}
    for name, t in out.items():
        shape, dt = want[name]
        check_out(name, t, device, shape, dt)
        flags |= OUT_BITS[kernel][name]
        ptrs[name] = t.data_ptr()
    if not flags:
        raise ValueError("no outputs requested")
    return flags, ptrs


def _graph_common(x, entry, framing: dict, retired) -> None:
    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}")
    check_cuda_input(x)
    check_frames(x, **framing)
    check_retired(retired, x.device)


# ---------------------------------------------------------------------------
# The graph launchers
# ---------------------------------------------------------------------------

def launch_biosignal_graph(x: torch.Tensor, *, entry: str, window: int,
                           n_frames: int, frame_stride: int, n_slots: int,
                           slot_stride: int, taps, twiddle_re, twiddle_im,
                           untangle, svm_w, svm_b, fft_size: int,
                           bands: tuple, prominence: float,
                           min_distance: int, block_frames: int,
                           out: dict, retired: torch.Tensor | None = None,
                           valid_rows: int | None = None) -> None:
    """Run the biosignal graph on ``n_slots * n_frames`` frames of ``x``
    (frame f of slot r starts ``r*slot_stride + f*frame_stride`` elements
    past ``x``'s first element) and write the outputs present in ``out``
    (flat (n_slots * n_frames, ...) tensors) in place. ``retired``, a
    one-element int32 tensor on the card, receives from the kernel the
    number of frames it wrote among the first ``valid_rows`` (default:
    all)."""
    if window > BIOSIGNAL_MAX_WINDOW:
        raise ValueError(f"biosignal_graph: window {window} is longer than "
                         f"{BIOSIGNAL_MAX_WINDOW}")
    framing = dict(window=window, n_frames=n_frames,
                   frame_stride=frame_stride, n_slots=n_slots,
                   slot_stride=slot_stride, block_frames=block_frames)
    _graph_common(x, entry, framing, retired)
    dev = x.device
    m = fft_size // 2
    C = svm_w.shape[-1]
    check_table("taps", taps, dev, (taps.shape[0],))
    check_table("twiddle_re", twiddle_re, dev, (m.bit_length() - 1, m // 2))
    check_table("twiddle_im", twiddle_im, dev, (m.bit_length() - 1, m // 2))
    check_table("untangle", untangle, dev, (2, m))
    check_table("svm_w", svm_w, dev, (12, C))
    check_table("svm_b", svm_b, dev, (C,))
    rows = n_slots * n_frames
    flags, ptrs = _graph_outputs("biosignal_graph", out, {
        "filtered": ((rows, window), torch.float32),
        "features": ((rows, 12), torch.float32),
        "margin": ((rows, C), torch.float32),
        "class": ((rows,), torch.int32)}, dev)
    valid_rows = rows if valid_rows is None else valid_rows
    lib = library("biosignal_graph")
    check_smem("biosignal_graph", lib.biosignal_graph_smem_bytes(
        window, fft_size), f"window {window}")
    launch("biosignal_graph", entry, x, "biosignal_graph_launch",
           x.data_ptr(), slot_stride, frame_stride, n_slots, n_frames,
           window, block_frames, taps.data_ptr(), taps.shape[0],
           twiddle_re.data_ptr(), twiddle_im.data_ptr(), untangle.data_ptr(),
           fft_size, svm_w.data_ptr(), svm_b.data_ptr(), svm_w.shape[0], C,
           (ctypes.c_int * 7)(*bands), prominence, min_distance,
           ptrs.get("filtered"), ptrs.get("features"), ptrs.get("margin"),
           ptrs.get("class"), None if retired is None else retired.data_ptr(),
           min(max(valid_rows, 0), rows), flags)


@functools.lru_cache(maxsize=None)
def _twiddle_entries(m: int) -> int:
    """Complex entries of `stockham_table(m)`, the ASR kernel's table."""
    return sum(r * span for r, span in stockham_plan(m) if span > 1)


def check_asr_fft_size(fft_size: int) -> None:
    """The ASR kernel takes power-of-two fft sizes from 4 to
    `ASR_MAX_FFT_SIZE`."""
    if not 4 <= fft_size <= ASR_MAX_FFT_SIZE or fft_size & (fft_size - 1):
        raise ValueError(f"asr_graph: fft_size {fft_size} is not a power "
                         f"of 2 from 4 to {ASR_MAX_FFT_SIZE}")


def launch_asr_graph(x: torch.Tensor, *, entry: str, window: int,
                     n_frames: int, frame_stride: int, n_slots: int,
                     slot_stride: int, taps, hann, twiddles, untangle, spans,
                     fft_size: int, block_frames: int, out: dict,
                     retired: torch.Tensor | None = None,
                     valid_rows: int | None = None) -> None:
    """Run the ASR front-end graph (pre-emphasis FIR, periodic Hann,
    |packed rFFT|^2, log1p(power @ mel_w)) on ``n_slots * n_frames``
    frames of ``x``, with the framing, output and ``retired`` contract of
    `launch_biosignal_graph`. ``twiddles`` is `kernels.fft`'s
    `stockham_table(fft_size // 2)` on the card and ``spans`` the
    filterbank's `asr.MelSpans`."""
    check_asr_fft_size(fft_size)
    framing = dict(window=window, n_frames=n_frames,
                   frame_stride=frame_stride, n_slots=n_slots,
                   slot_stride=slot_stride, block_frames=block_frames)
    _graph_common(x, entry, framing, retired)
    dev = x.device
    m = fft_size // 2
    n_mels = spans.first.shape[0]
    check_table("taps", taps, dev, (taps.shape[0],))
    check_table("hann", hann, dev, (1, fft_size))
    check_table("twiddles", twiddles, dev, (_twiddle_entries(m), 2))
    check_table("untangle", untangle, dev, (2, m))
    if spans.first.device != dev:      # MelSpans checks the rest when built
        raise ValueError(f"mel spans on {spans.first.device}, frames on "
                         f"{dev}")
    rows = n_slots * n_frames
    flags, ptrs = _graph_outputs("asr_graph", out, {
        "filtered": ((rows, window), torch.float32),
        "logmel": ((rows, n_mels), torch.float32)}, dev)
    valid_rows = rows if valid_rows is None else valid_rows
    lib = library("asr_graph")
    check_smem("asr_graph", lib.asr_graph_smem_bytes(
        fft_size, block_frames, n_mels, spans.weights.shape[0]),
        f"fft_size {fft_size}")
    launch("asr_graph", entry, x, "asr_graph_launch",
           x.data_ptr(), slot_stride, frame_stride, n_slots, n_frames,
           window, block_frames, taps.data_ptr(), taps.shape[0],
           hann.data_ptr(), twiddles.data_ptr(), untangle.data_ptr(),
           fft_size, spans.first.data_ptr(), spans.offset.data_ptr(),
           spans.weights.data_ptr(), spans.weights.shape[0], n_mels,
           ptrs.get("filtered"), ptrs.get("logmel"),
           None if retired is None else retired.data_ptr(),
           min(max(valid_rows, 0), rows), flags)

