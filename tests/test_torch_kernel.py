"""The port's CUDA kernels against their plain PyTorch versions: the fused
biosignal graph (`csrc/biosignal_graph.cu`), the fused ASR graph
(`csrc/asr_graph.cu`), the standalone FIR (`kernels/fir/csrc/fir.cu`) and
FFT (`kernels/fft/csrc/fft.cu`). This file imports torch and the port
only, so it also runs on a machine with the card and no jax:

    python -m pytest -q -m cuda tests/test_torch_kernel.py

The `cuda`-marked tests skip without a card. Tolerances on the card:

* biosignal: class, filtered and the interval time features exact (same
  comparisons, integer arithmetic, and the FIR in the same order without
  FMA on both sides); band powers rtol/atol 1e-5 and margin rtol 1e-5
  atol 1e-4 (the delineation mean, the segment mean and the band sums
  reduce in another order);
* ASR: filtered exact (the same FIR); logmel within `ASR_LOGMEL_TOL` of
  max(1, its largest magnitude) (the FFT passes and the mel sums run in
  another order than the plain version's);
* FIR: within 1e-5 in float32 and 2e-2 in bfloat16 (the kernel repeats
  the plain version's operations in its order, so they usually agree to
  the last bit);
* FFT: max |kernel - plain| <= `FFT_TOL` x max |plain| (1e-4 in float32,
  1e-2 in bfloat16): radix-16 passes with FMA against the plain radix-2
  chain agree to float32 rounding, not bitwise."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.biosignal import make_app, synthetic_respiration
from repro_torch.core.fir import lowpass_taps
from repro_torch.kernels import _cuda
from repro_torch.kernels.fft.kernel import (FFT_TOL, fft_cuda, fft_plain,
                                            stockham_plan, stockham_table,
                                            threads_per_row)
from repro_torch.kernels.fir.kernel import fir_cuda, fir_plain
from repro_torch.kernels.flash_attention import kernel as _flash  # noqa
from repro_torch.kernels.pipeline import cuda
from repro_torch.kernels.rope import kernel as _rope  # noqa: F401
from repro_torch.kernels.shuffle import kernel as _shuffle  # noqa: F401
from repro_torch.kernels.pipeline.asr import (ASR_LOGMEL_TOL, MelSpans,
                                              make_asr_frontend,
                                              mel_filterbank, mel_spans,
                                              span_table)
from repro_torch.kernels.pipeline.graph import (
    get_graph_factory, graph_frames_call, graph_frames_plain,
    graph_ring_call, graph_ring_plain, graph_stream_call,
    graph_stream_plain, ring_chunk_samples)
from repro_torch.kernels.pipeline.kernel import OUTPUTS
from repro_torch.serve.stream import frame_signal


def test_binding_matches_the_source():
    """The C symbols and output bits the ctypes binding relies on are the
    ones each source defines."""
    for kernel, spec in _cuda.KERNELS.items():
        text = spec.source.read_text()
        for sym in (*spec.signatures, f"{kernel}_error_string"):
            assert re.search(rf"\b{sym}\(", text), (kernel, sym)
        # the note each source opens with
        assert re.search(r"Replaces\b[\s\S]{0,120}src/repro/kernels/", text)
        assert "What bounds it on this card" in text, kernel
        # each C function takes as many parameters as its ctypes binding
        for sym, (argtypes, _) in spec.signatures.items():
            params = re.search(rf"\b{sym}\(([^)]*)\)\s*\{{", text).group(1)
            assert len([a for a in params.split(",") if a.strip()]) == \
                len(argtypes), (kernel, sym)
    for kernel, bits in cuda.OUT_BITS.items():
        text = _cuda.KERNELS[kernel].source.read_text()
        for name, bit in bits.items():
            const = "kOut" + name.capitalize()
            assert re.search(rf"constexpr int {const} = {bit};", text), name
    assert "-use_fast_math" not in _cuda.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


def test_launch_counts_reset():
    _cuda.LAUNCHES["biosignal_graph"]["ring"] += 2
    _cuda.LAUNCHES["asr_graph"]["stream"] += 1
    _cuda.LAUNCHES["fft"]["rows"] += 3
    _cuda.reset_launches()
    assert _cuda.LAUNCHES == {k: dict.fromkeys(v.entries, 0)
                              for k, v in _cuda.KERNELS.items()}
    assert set(_cuda.LAUNCHES) == \
        {"biosignal_graph", "asr_graph", "fir", "fft", "shuffle", "rope",
         "flash_attention"}
    assert _cuda.KERNELS["asr_graph"].entries == ("frames", "stream", "ring")
    assert _cuda.KERNELS["fir"].entries == _cuda.KERNELS["fft"].entries == \
        ("rows",)
    assert _cuda.KERNELS["shuffle"].entries == (
        "interleave", "prune_even", "prune_odd", "bit_reverse",
        "circular_shift")
    assert _cuda.KERNELS["rope"].entries == ("interleaved", "neox")
    assert _cuda.KERNELS["flash_attention"].entries == ("attention",)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in ("class", "filtered"):
            assert torch.equal(g, w), k
        elif k == "features":
            assert torch.equal(g[..., :6], w[..., :6])
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", [OUTPUTS, ("filtered",), ("features",),
                                     ("margin", "class")])
@pytest.mark.parametrize("window,hop", [(512, 128), (2048, 512),
                                        (4096, 1024)])   # > 48 KB smem
def test_kernel_matches_plain_on_card(card, outputs, window, hop):
    app = make_app(device=card)
    graph, operands = get_graph_factory("biosignal")(app)
    sig = synthetic_respiration(1, 11 * hop + window + 5, seed=window,
                                device=card)[0][0]
    kw = dict(graph=graph, outputs=outputs)
    _cuda.reset_launches()
    stream = graph_stream_call(sig, operands, window=window, hop=hop, **kw)
    frames = frame_signal(sig, window, hop)
    framed = graph_frames_call(frames, operands, block_rows=3, **kw)
    bw, depth = 4, 3
    span, stride = ring_chunk_samples(window, hop, bw), bw * hop
    ring = sig[: (depth - 1) * stride + span].as_strided(
        (depth, span), (stride, 1))
    ringed = graph_ring_call(ring, operands, window=window, hop=hop, **kw)
    assert _cuda.LAUNCHES["biosignal_graph"] == {"frames": 1, "stream": 1,
                                                "ring": 1}
    _close(stream, graph_stream_plain(sig, operands, window=window, hop=hop,
                                      **kw))
    _close(framed, graph_frames_plain(frames, operands, **kw))
    _close(ringed, graph_ring_plain(ring, operands, window=window, hop=hop,
                                    **kw))
    for k in stream:                          # one per-frame code path
        assert torch.equal(stream[k], framed[k]), k
        for r in range(depth):
            assert torch.equal(ringed[k][r],
                               stream[k][r * bw: r * bw + bw]), k


@pytest.mark.cuda
@pytest.mark.parametrize("block_frames", [1, 3])
@pytest.mark.parametrize("valid_frames", [None, 10, 0])
def test_kernel_counts_the_frames_it_retires(card, block_frames,
                                             valid_frames):
    """The ring kernel adds the valid frames it wrote to the resident
    loop's device counter; the plain version adds the same number."""
    app = make_app(device=card)
    graph, operands = get_graph_factory("biosignal")(app)
    bw, depth, window, hop = 4, 3, 2048, 512
    span, stride = ring_chunk_samples(window, hop, bw), bw * hop
    sig = synthetic_respiration(1, (depth - 1) * stride + span, seed=2,
                                device=card)[0][0]
    ring = sig.as_strided((depth, span), (stride, 1))
    counts = torch.full((2,), 5, dtype=torch.int32, device=card)
    kw = dict(graph=graph, window=window, hop=hop, outputs=("class",),
              valid_frames=valid_frames)
    graph_ring_call(ring, operands, block_frames=block_frames,
                    retired=counts[1], **kw)
    plain = torch.full((2,), 5, dtype=torch.int32)
    graph_ring_call(ring.cpu(), tuple(t.cpu() for t in operands),
                    retired=plain[1], **kw)
    want = depth * bw if valid_frames is None else valid_frames
    assert counts.tolist() == plain.tolist() == [5, 5 + want]


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    app = make_app(device=card)
    graph, operands = get_graph_factory("biosignal")(app)
    sig = torch.zeros(4096, device=card)
    with pytest.raises(ValueError, match="float32"):
        graph_stream_call(sig.double(), operands, graph=graph, window=2048,
                          hop=512)
    with pytest.raises(ValueError, match="contiguous"):
        graph_frames_call(sig.reshape(2, 2048).t().contiguous().t(),
                          operands, graph=graph)
    cpu_ops = tuple(t.cpu() for t in operands)
    with pytest.raises(ValueError, match="taps"):
        graph_stream_call(sig, cpu_ops, graph=graph, window=2048, hop=512)


@pytest.mark.cuda
def test_kernel_result_does_not_depend_on_block_frames(card):
    """Frames are computed by their own threads: any number of frames a
    block, up to more than a block holds at once, gives the same bits."""
    app = make_app(device=card)
    graph, operands = get_graph_factory("biosignal")(app)
    sig = synthetic_respiration(1, 40 * 512 + 2048, seed=7, device=card)[0][0]
    kw = dict(graph=graph, window=2048, hop=512, outputs=OUTPUTS)
    runs = [graph_stream_call(sig, operands, block_frames=b, **kw)
            for b in (1, 2, 3, 8, 13)]
    _close(runs[0], graph_stream_plain(sig, operands, **kw))
    for other in runs[1:]:
        for k in runs[0]:
            assert torch.equal(other[k], runs[0][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [512, 509])
def test_kernel_reads_unaligned_frames_on_card(card, hop):
    """Frames off a 16-byte boundary (hop 509; a ring of odd slot stride on
    a base one sample in) take the scalar loads and agree bitwise with the
    aligned path of the same frames."""
    app = make_app(device=card)
    graph, operands = get_graph_factory("biosignal")(app)
    bw, depth = 5, 3
    span = ring_chunk_samples(2048, hop, bw)
    buf = synthetic_respiration(1, depth * (span + 1) + 3, seed=hop,
                                device=card)[0][0]
    ring = buf[1:].as_strided((depth, span), (span + 1, 1))
    kw = dict(graph=graph, window=2048, hop=hop, outputs=OUTPUTS)
    ringed = graph_ring_call(ring, operands, **kw)
    _close(ringed, graph_ring_plain(ring, operands, **kw))
    for r in range(depth):
        one = graph_stream_call(ring[r].clone(), operands, **kw)
        framed = graph_frames_call(frame_signal(ring[r].clone(), 2048, hop),
                                   operands, graph=graph, outputs=OUTPUTS)
        for k in one:
            assert torch.equal(ringed[k][r], one[k]), k
            assert torch.equal(framed[k], one[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("n_taps", [1, 2, 64])
def test_kernel_takes_any_tap_count_on_card(card, n_taps):
    """One tap, two and the most the kernel takes (the wide-history
    instantiation): `filtered` stays bitwise."""
    from repro_torch.core.biosignal import app_from_numpy

    base = make_app(device="cpu")
    taps = [1.0] if n_taps == 1 else lowpass_taps(n_taps)
    app = app_from_numpy(taps, base.svm_w.numpy(), base.svm_b.numpy(),
                         device=card)
    graph, operands = get_graph_factory("biosignal")(app)
    sig = synthetic_respiration(1, 9 * 512 + 2048, seed=n_taps,
                                device=card)[0][0]
    kw = dict(graph=graph, window=2048, hop=512, outputs=OUTPUTS)
    _close(graph_stream_call(sig, operands, **kw),
           graph_stream_plain(sig, operands, **kw))


@pytest.mark.cuda
def test_kernel_median_worst_case_on_card(card):
    """An alternating 0/1 signal through a one-tap identity FIR: ~1,024
    extrema a mask, so the median is taken past the rank-counting cap."""
    from repro_torch.core.biosignal import app_from_numpy

    base = make_app(device="cpu")
    app = app_from_numpy([1.0], base.svm_w.numpy(), base.svm_b.numpy(),
                         device=card)
    graph, operands = get_graph_factory("biosignal")(app)
    sig = torch.tensor([0.0, 1.0] * (2048 + 3 * 256), device=card)
    kw = dict(graph=graph, window=2048, hop=512, outputs=OUTPUTS)
    got = graph_stream_call(sig, operands, **kw)
    _close(got, graph_stream_plain(sig, operands, **kw))
    assert torch.equal(got["features"][:, :6],
                       torch.full_like(got["features"][:, :6], 2.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dips", [(700,), (300, 1400)])
def test_kernel_median_mixed_lists_on_card(card, dips):
    """A 1.0/0.9 alternation with one or two deep dips, through a one-tap
    identity FIR: ~1,000 maxima (bisection) beside 0 or 2 minimum gaps,
    so the two medians take different paths in one frame."""
    from repro_torch.core.biosignal import app_from_numpy

    base = make_app(device="cpu")
    app = app_from_numpy([1.0], base.svm_w.numpy(), base.svm_b.numpy(),
                         device=card)
    graph, operands = get_graph_factory("biosignal")(app)
    sig = torch.tensor([1.0, 0.9] * (1024 + 256), device=card)
    for d in dips:
        sig[d] = -10.0
    kw = dict(graph=graph, window=2048, hop=512, outputs=OUTPUTS)
    _close(graph_stream_call(sig, operands, **kw),
           graph_stream_plain(sig, operands, **kw))


def test_kernel_refuses_windows_past_its_cap():
    """Positions and gaps are 15-bit in the kernel: the launcher refuses
    longer windows with a ValueError before it builds anything."""
    assert cuda.BIOSIGNAL_MAX_WINDOW == _bio_cu_const("kMaxWindow")
    with pytest.raises(ValueError, match="window"):
        cuda.launch_biosignal_graph(
            torch.zeros(40000), entry="stream",
            window=cuda.BIOSIGNAL_MAX_WINDOW + 1, n_frames=1,
            frame_stride=512, n_slots=1, slot_stride=0, taps=None,
            twiddle_re=None, twiddle_im=None, untangle=None, svm_w=None,
            svm_b=None, fft_size=512, bands=(), prominence=0.3,
            min_distance=15, block_frames=1, out={})


# ------------------------------------------------------------- ASR graph

def _audio(n: int, seed: int, device) -> torch.Tensor:
    """A chirp plus noise at 16 kHz, drawn in numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = np.sin(2 * np.pi * (200 + 40 * t) * t) + \
        0.1 * rng.standard_normal(n)
    return torch.as_tensor(x.astype(np.float32), device=device)


def _close_asr(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "filtered":
            assert torch.equal(g, w), k
        else:
            scale = max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) / scale < ASR_LOGMEL_TOL, k


@pytest.mark.cuda
@pytest.mark.parametrize("outputs", [("filtered", "logmel"), ("logmel",),
                                     ("filtered",)])
@pytest.mark.parametrize("window,hop", [(512, 160), (1024, 256)])
def test_asr_kernel_matches_plain_on_card(card, outputs, window, hop):
    app = make_asr_frontend(device=card)
    graph, operands = get_graph_factory("asr")(app)
    sig = _audio(21 * hop + window + 5, seed=window, device=card)
    kw = dict(graph=graph, outputs=outputs)
    _cuda.reset_launches()
    stream = graph_stream_call(sig, operands, window=window, hop=hop, **kw)
    frames = frame_signal(sig, window, hop)
    framed = graph_frames_call(frames, operands, block_rows=3, **kw)
    bw, depth = 6, 3
    span, stride = ring_chunk_samples(window, hop, bw), bw * hop
    ring = sig[: (depth - 1) * stride + span].as_strided(
        (depth, span), (stride, 1))
    ringed = graph_ring_call(ring, operands, window=window, hop=hop, **kw)
    assert _cuda.LAUNCHES["asr_graph"] == {"frames": 1, "stream": 1,
                                          "ring": 1}
    _close_asr(stream, graph_stream_plain(sig, operands, window=window,
                                          hop=hop, **kw))
    _close_asr(framed, graph_frames_plain(frames, operands, **kw))
    _close_asr(ringed, graph_ring_plain(ring, operands, window=window,
                                        hop=hop, **kw))
    for k in stream:                          # one per-frame code path
        assert torch.equal(stream[k], framed[k]), k
        for r in range(depth):
            assert torch.equal(ringed[k][r],
                               stream[k][r * bw: r * bw + bw]), k


@pytest.mark.cuda
@pytest.mark.parametrize("block_frames", [1, 8, 13])
@pytest.mark.parametrize("valid_frames", [None, 10, 0])
def test_asr_kernel_counts_the_frames_it_retires(card, block_frames,
                                                 valid_frames):
    app = make_asr_frontend(device=card)
    graph, operands = get_graph_factory("asr")(app)
    bw, depth, window, hop = 6, 3, 512, 160
    span, stride = ring_chunk_samples(window, hop, bw), bw * hop
    sig = _audio((depth - 1) * stride + span, seed=2, device=card)
    ring = sig.as_strided((depth, span), (stride, 1))
    counts = torch.full((2,), 5, dtype=torch.int32, device=card)
    kw = dict(graph=graph, window=window, hop=hop, outputs=("logmel",),
              valid_frames=valid_frames)
    graph_ring_call(ring, operands, block_frames=block_frames,
                    retired=counts[1], **kw)
    want = depth * bw if valid_frames is None else valid_frames
    assert counts.tolist() == [5, 5 + want]


@pytest.mark.cuda
@pytest.mark.parametrize("fft_size,n_mels", [(256, 64), (1024, 64),
                                             (2048, 64), (512, 40),
                                             (512, 128)])
def test_asr_kernel_takes_other_sizes_on_card(card, fft_size, n_mels):
    """fft sizes whose last pass is radix 8, 2 and 4 (frames of 8, 32 and
    64 threads), and narrower and wider filterbanks."""
    app = make_asr_frontend(device=card, fft_size=fft_size, n_mels=n_mels)
    graph, operands = get_graph_factory("asr")(app)
    window, hop = max(512, fft_size), 160
    sig = _audio(21 * hop + window + 5, seed=fft_size + n_mels, device=card)
    for outputs in (("filtered", "logmel"), ("logmel",)):
        kw = dict(graph=graph, outputs=outputs)
        stream = graph_stream_call(sig, operands, window=window, hop=hop,
                                   **kw)
        _close_asr(stream, graph_stream_plain(sig, operands, window=window,
                                              hop=hop, **kw))
        framed = graph_frames_call(frame_signal(sig, window, hop), operands,
                                   block_rows=3, **kw)
        for k in stream:
            assert torch.equal(stream[k], framed[k]), k


@pytest.mark.cuda
def test_asr_kernel_result_does_not_depend_on_block_frames(card):
    app = make_asr_frontend(device=card)
    graph, operands = get_graph_factory("asr")(app)
    sig = _audio(40 * 160 + 512, seed=7, device=card)
    kw = dict(graph=graph, window=512, hop=160, outputs=("filtered",
                                                         "logmel"))
    runs = [graph_stream_call(sig, operands, block_frames=b, **kw)
            for b in (1, 2, 3, 8, 13)]
    _close_asr(runs[0], graph_stream_plain(sig, operands, **kw))
    for other in runs[1:]:
        for k in runs[0]:
            assert torch.equal(other[k], runs[0][k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [160, 161])
def test_asr_kernel_reads_unaligned_frames_on_card(card, hop):
    """Frames off a 16-byte boundary (hop 161; a ring of odd slot stride
    on a base one sample in) take the scalar loads and agree bitwise with
    the aligned path."""
    app = make_asr_frontend(device=card)
    graph, operands = get_graph_factory("asr")(app)
    bw, depth = 5, 3
    span = ring_chunk_samples(512, hop, bw)
    buf = _audio(depth * (span + 1) + 3, seed=hop, device=card)
    ring = buf[1:].as_strided((depth, span), (span + 1, 1))
    kw = dict(graph=graph, window=512, hop=hop, outputs=("filtered",
                                                         "logmel"))
    ringed = graph_ring_call(ring, operands, **kw)
    _close_asr(ringed, graph_ring_plain(ring, operands, **kw))
    for r in range(depth):
        one = graph_stream_call(ring[r].clone(), operands, **kw)
        for k in one:
            assert torch.equal(ringed[k][r], one[k]), k


# ------------------------------------- the ASR kernel's map, on the CPU

_ASR_CU = Path(cuda.__file__).resolve().parent / "csrc" / "asr_graph.cu"


def _asr_cu_table(name: str) -> list:
    """A ``constexpr int name[kMaxLog + 1] = {...};`` table of the source."""
    body = re.search(rf"constexpr int {name}\[kMaxLog \+ 1\] = "
                     rf"\{{([\d,\s]+)\}};", _ASR_CU.read_text()).group(1)
    return [int(v) for v in body.split(",")]


def _asr_cu_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _ASR_CU.read_text()).group(1))


def asr_walk_through(app, frames: np.ndarray) -> dict:
    """The ASR kernel's per-frame map in numpy, thread by thread, on (R,
    S) float32 frames (one frame slot of the exchange buffer each): the
    FIR and Hann of thread i's vectors v = i + T j into the packed halves;
    each pass's reads of points i + T mm and Stockham writes; the untangle
    of bins k and m - k by one thread, the powers then written unpadded;
    the mel product of columns i + T q over their spans. Checks on the way
    that every write lands once inside the frame's planes and every bin is
    untangled once."""
    R, S = frames.shape
    N = app.fft_size
    m = N // 2
    lg = m.bit_length() - 1
    E = min(m, 16)
    T = m // E
    SH = _asr_cu_table("kPadShift")[lg]
    P = m + (m >> SH)
    FS = 2 * P + _asr_cu_table("kFrameGap")[lg]

    def pad(q):
        return q + (q >> SH)

    taps = app.fir_taps.numpy()
    hann = app.hann.numpy()
    u = np.stack([np.cos(-2 * np.pi * np.arange(m) / N),
                  np.sin(-2 * np.pi * np.arange(m) / N)]).astype(np.float32)
    buf = np.full((R, FS), np.nan, np.float32)
    filt = np.zeros((R, S), np.float32)
    for t in range(S):              # the FIR, in the plain version's order
        for i, tap in enumerate(taps):
            xv = frames[:, t - i] if t >= i else np.float32(0)
            filt[:, t] = filt[:, t] + np.float32(tap) * xv

    # in-stage: thread i, vectors v = i + T j of the FFT segment
    writes = np.zeros(FS, int)
    for i in range(T):
        for v in range(i, N // 4, T):
            w = filt[:, 4 * v:4 * v + 4] * hann[4 * v:4 * v + 4]
            for word, c in ((pad(2 * v), 0), (P + pad(2 * v), 1),
                            (pad(2 * v + 1), 2), (P + pad(2 * v + 1), 3)):
                buf[:, word] = w[:, c]
                writes[word] += 1
    planes = np.concatenate([pad(np.arange(m)), P + pad(np.arange(m))])
    assert (writes[planes] == 1).all() and writes.sum() == 2 * m

    # the passes
    tw = stockham_table(m)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    offset = 0
    for radix, span in stockham_plan(m):
        lr = radix.bit_length() - 1
        held = {i: [buf[:, pad(i + T * mm)] + 1j * buf[:, P + pad(i + T * mm)]
                    for mm in range(E)] for i in range(T)}
        written = np.zeros(m, int)
        for i in range(T):
            for u_ in range(E // radix):
                b = i + T * u_
                k = b & (span - 1)
                y = np.stack([held[i][u_ + j * (E // radix)]
                              for j in range(radix)], -1).astype(np.complex64)
                if span > 1:
                    y = y * tw[offset + np.arange(radix) * span + k]
                y = np.fft.fft(y, axis=-1).astype(np.complex64)
                first = ((b - k) << lr) + k
                for r in range(radix):
                    q = first + r * span
                    buf[:, pad(q)], buf[:, P + pad(q)] = y[:, r].real, \
                        y[:, r].imag
                    written[q] += 1
        assert (written == 1).all(), "a pass writes every point once"
        if span > 1:
            offset += radix * span
    assert offset == len(tw)

    # untangle: one thread takes bins k and m - k; every Z read, then the
    # powers written unpadded to words 0 .. m of the re plane
    power = {}
    for i in range(T):
        for k in [i + T * q for q in range(E // 2)] + ([m // 2] if i == 0
                                                      else []):
            kc = (m - k) & (m - 1)
            a = buf[:, pad(k)] + 1j * buf[:, P + pad(k)]
            b = buf[:, pad(kc)] + 1j * buf[:, P + pad(kc)]
            bins = [k] + ([m - k] if k != m // 2 else [])
            for q, (zk, zc) in zip(bins, ((a, b), (b, a))):
                if q == m:
                    pw = (a.real - a.imag) ** 2
                else:
                    e = (zk + np.conj(zc)) / 2
                    o = (zk - np.conj(zc)) / 2
                    x = e - 1j * (u[0, q] + 1j * u[1, q]) * o
                    pw = x.real ** 2 + x.imag ** 2
                assert q not in power, "a bin is taken once"
                power[q] = pw.astype(np.float32)
    assert sorted(power) == list(range(m + 1))
    assert m + 1 <= P                 # the powers stay in the re plane
    for q, pw in power.items():
        buf[:, q] = pw

    # mel product: thread i takes columns i + T q, each over its span
    first, offs, weights = span_table(app.mel_weights.numpy())
    taken = []
    logmel = np.zeros((R, app.n_mels), np.float32)
    for i in range(T):
        for j in range(i, app.n_mels, T):
            taken.append(j)
            acc = np.zeros(R, np.float32)
            for o in range(offs[j], offs[j + 1]):
                acc = acc + buf[:, first[j] + o - offs[j]] * weights[o]
            logmel[:, j] = np.log1p(acc)
    assert sorted(taken) == list(range(app.n_mels))
    return {"filtered": filt, "logmel": logmel}


@pytest.mark.parametrize("fft_size", [256, 512, 1024, 2048])
def test_asr_walk_through_gives_the_plain_logmel(fft_size):
    """fft 256, 512, 1024 and 2048: last passes of radix 8, 16, 2 and 4,
    frames of 8 to 64 threads."""
    app = make_asr_frontend(device="cpu", fft_size=fft_size)
    graph, operands = get_graph_factory("asr")(app)
    window = max(512, fft_size)
    sig = _audio(5 * 160 + window, seed=fft_size, device="cpu")
    frames = frame_signal(sig, window, 160)
    got = asr_walk_through(app, frames.numpy())
    want = graph_frames_plain(frames, operands, graph=graph)
    np.testing.assert_array_equal(got["filtered"], want["filtered"].numpy())
    scale = max(1.0, float(want["logmel"].abs().max()))
    assert np.abs(got["logmel"] - want["logmel"].numpy()).max() <= \
        ASR_LOGMEL_TOL * scale


def _with_interior_zero() -> np.ndarray:
    w = mel_filterbank(512, 64)
    for j in (10, 30):
        nz = np.flatnonzero(w[:, j])
        assert len(nz) >= 3
        w[nz[len(nz) // 2], j] = 0.0           # inside column j's span
    return w


def _with_zero_column() -> np.ndarray:
    w = mel_filterbank(512, 64)
    w[:, 0] = 0.0
    w[:, 63] = 0.0
    return w


@pytest.mark.parametrize("mel_w", [
    mel_filterbank(512, 64), mel_filterbank(512, 40),
    mel_filterbank(512, 128), mel_filterbank(512, 64, 16000.0, 300.0),
    mel_filterbank(512, 64, 16000.0, 0.0, 4000.0),
    mel_filterbank(1024, 80, 16000.0, 20.0, 7600.0), _with_interior_zero(),
    _with_zero_column()], ids=["default", "n_mels40", "n_mels128", "fmin300",
                               "fmax4000", "fft1024_80", "interior_zero",
                               "zero_column"])
def test_asr_span_table_is_exact(mel_w):
    """The band sums over the spans equal the dense product in float64;
    every weight outside the spans is zero and each span starts and ends
    on a nonzero weight."""
    first, offset, weights = span_table(mel_w)
    bins, n_mels = mel_w.shape
    power = np.random.default_rng(bins + n_mels).random((6, bins))
    bands = np.zeros((6, n_mels))
    covered = np.zeros_like(mel_w, bool)
    for j in range(n_mels):
        n = offset[j + 1] - offset[j]
        rows = slice(first[j], first[j] + n)
        np.testing.assert_array_equal(weights[offset[j]:offset[j + 1]],
                                      mel_w[rows, j])
        covered[rows, j] = True
        bands[:, j] = power[:, rows] @ weights[offset[j]:offset[j + 1]]
        if n:
            assert mel_w[first[j], j] and mel_w[first[j] + n - 1, j]
        else:
            assert not mel_w[:, j].any()
    assert not mel_w[~covered].any()
    np.testing.assert_allclose(bands, power @ mel_w.astype(np.float64),
                               rtol=1e-12, atol=0)


def test_mel_spans_rebuilds_after_an_in_place_edit():
    app = make_asr_frontend(device="cpu")
    spans = mel_spans(app.mel_weights)
    assert isinstance(spans, MelSpans) and spans.first.dtype == torch.int32
    assert mel_spans(app.mel_weights) is spans        # cached
    app.mel_weights.mul_(2.0)
    doubled = mel_spans(app.mel_weights)
    assert doubled is not spans
    torch.testing.assert_close(doubled.weights, 2 * spans.weights)
    app.mel_weights[:, 5] = 0.0
    emptied = mel_spans(app.mel_weights)
    assert int(emptied.offset[6] - emptied.offset[5]) == 0
    assert mel_spans(app.mel_weights) is emptied
    assert mel_spans(app.mel_weights.clone()) is not emptied


def test_asr_kernel_takes_fft_sizes_up_to_its_cap():
    """The kernel takes every power-of-two fft_size from 4 to 2 << kMaxLog
    (frames of up to 512 threads); the launcher refuses larger ones with
    a ValueError before it builds anything."""
    assert cuda.ASR_MAX_FFT_SIZE == 2 << _asr_cu_const("kMaxLog")
    assert (cuda.ASR_MAX_FFT_SIZE // 32) <= _asr_cu_const("kMaxThreads")
    for n in (4, 512, cuda.ASR_MAX_FFT_SIZE):
        cuda.check_asr_fft_size(n)
    for n in (2, 384, 2 * cuda.ASR_MAX_FFT_SIZE):
        with pytest.raises(ValueError, match="fft_size"):
            cuda.check_asr_fft_size(n)
    with pytest.raises(ValueError, match="fft_size"):
        cuda.launch_asr_graph(
            torch.zeros(70000), entry="stream", window=65536, n_frames=1,
            frame_stride=160, n_slots=1, slot_stride=0, taps=None,
            hann=None, twiddles=None, untangle=None, spans=None,
            fft_size=65536, block_frames=1, out={})


# ------------------------------- the biosignal kernel's map, on the CPU

_BIO_CU = Path(cuda.__file__).resolve().parent / "csrc" / "biosignal_graph.cu"


def _bio_cu_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _BIO_CU.read_text()).group(1))


def _bio_pad_shift() -> int:
    """The shift of the exchange planes' padding, pad(q) = q + (q >> k)."""
    return int(re.search(r"int pad\(int q\) \{ return q \+ \(q >> (\d+)\); \}",
                         _BIO_CU.read_text()).group(1))


def _bio_delineation_threads() -> int:
    """The threads of a frame that delineate: all but the warp that takes
    the FFT."""
    return _bio_cu_const("kFrameThreads") - _bio_cu_const("kFftThreads")


def test_bio_frame_groups_fit_the_named_barriers():
    """A block's groups each take a named barrier for the frame and one for
    its delineation threads: ids 1 + g and 1 + kMaxBlockThreads / T + g
    stay below the card's 16."""
    T = _bio_cu_const("kFrameThreads")
    groups = _bio_cu_const("kMaxBlockThreads") // T
    assert T == 128 and _bio_cu_const("kFftThreads") == 32
    assert _bio_delineation_threads() % 32 == 0
    assert 1 + groups + (groups - 1) < 16


def bio_fir_walk_through(frame: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """The biosignal kernel's FIR in numpy on one (S,) frame: the history
    vectors NH of the instantiation the launch picks for len(taps) (kAppTaps
    exactly, else the generic one); the frame
    staged in 16-byte vectors (the tail past S not a number); thread i
    filtering vectors v = i + T j from its 4 samples and the NH vectors
    before (zero before the frame), rounds from the last to the first, two
    a step, every read of a step before its writes, in place; acc = 0, then
    the taps in ascending order, each product and sum rounded in float32.
    Checks that every output sample is written once."""
    src = _BIO_CU.read_text()
    T = _bio_cu_const("kFrameThreads")
    app, long_ = _bio_cu_const("kAppTaps"), _bio_cu_const("kLongHistory")
    assert "n_taps == kAppTaps ? launch_kernel<kAppTaps>" in src
    assert "kt == 0 ? kLongHistory : (kt + 2) / 4" in src
    assert 4 * long_ + 1 >= _bio_cu_const("kMaxTaps")
    k = len(taps)
    NH = (k + 2) // 4 if k == app else long_
    assert k <= 4 * NH + 1
    S = frame.shape[0]
    nv = (S + 3) // 4
    rounds = (nv + T - 1) // T
    buf = np.full(4 * nv, np.nan, np.float32)
    buf[:S] = frame
    written = np.zeros(S, int)
    taps = taps.astype(np.float32)
    for j1 in range(rounds - 1, -1, -2):
        writes = []
        for r in range(2):
            if j1 - r < 0:
                continue
            v = np.arange(T) + T * (j1 - r)
            x = np.zeros((T, 4 * NH + 4), np.float32)
            for h in range(NH + 1):
                u = v - NH + h
                ok = (u >= 0) & (u < nv)
                x[ok, 4 * h: 4 * h + 4] = buf.reshape(nv, 4)[u[ok]]
            y = np.zeros((T, 4), np.float32)
            for i in range(k):
                for c in range(4):
                    y[:, c] = y[:, c] + taps[i] * x[:, 4 * NH + c - i]
            writes.append((v, y))
        for v, y in writes:
            for c in range(4):
                t = 4 * v + c
                ok = (v < nv) & (t < S)
                buf[t[ok]] = y[ok, c]
                written[t[ok]] += 1
    assert (written == 1).all(), "every output sample is written once"
    return buf[:S]


@pytest.mark.parametrize("window", [2048, 1001])
@pytest.mark.parametrize("n_taps", [1, 2, 10, 11, 12, 64])
def test_bio_fir_walk_through_is_bitwise_fir_direct(n_taps, window):
    """Both instantiations (11 taps exactly, the other counts on the generic
    one), a window of whole vectors and one with a ragged tail."""
    from repro_torch.core.fir import fir_direct

    rng = np.random.default_rng(n_taps * window)
    frame = rng.standard_normal(window).astype(np.float32)
    taps = rng.standard_normal(n_taps).astype(np.float32)
    got = bio_fir_walk_through(frame, taps)
    want = fir_direct(torch.as_tensor(frame), torch.as_tensor(taps)).numpy()
    np.testing.assert_array_equal(got, want)


def _bitrev(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def bio_fft_walk_through(zr: np.ndarray, zi: np.ndarray, wr: np.ndarray,
                         wi: np.ndarray, window: int) -> tuple:
    """The biosignal kernel's packed FFT in numpy, thread by thread, on (R,
    m) float32 points: the compacted twiddle rows it copies to shared
    memory; passes of L = 4 radix-2 stages (fewer in the last), group (q,
    r) reading in_pos(v) = q << (M - s0) | v << rb | r, the stages in
    constant geometry (stage i pairs slots j and j + 2^(L-1), twiddle at
    (j >> i) << rb | r, outputs to slots 2j and 2j + 1) in float32 with
    each product and sum rounded, point v written to
    out_pos(v) = bitrev(v) << (M - L) | q << rb | r of the other exchange
    buffer (words 0 and 2P of the FFT warp's buffers, planes padded), on
    the kFftThreads threads of that warp. Checks that each pass writes
    every point once."""
    R, m = zr.shape
    M = m.bit_length() - 1
    T = _bio_cu_const("kFftThreads")
    sh = _bio_pad_shift()
    P = m + (m >> sh)

    def pad(q):
        return q + (q >> sh)

    assert 2 * m <= window                       # pass 0 reads [0, 2m)
    # the compacted table: row s's m >> (s + 1) entries from m - (m >> s)
    tw = np.zeros(m - 1, np.complex64)
    for s in range(M):
        half = m >> (s + 1)
        tw[m - (m >> s): m - (m >> s) + half] = wr[s, :half] + 1j * wi[s, :half]
    assert np.count_nonzero(tw == 0) == 0
    region = np.full((R, 4 * P), np.nan, np.float32)
    src = None                                   # pass 0 reads zr, zi
    threads = min(T, max(1, m >> 4))
    s0, n_pass = 0, 0
    while s0 < M:
        L = min(4, M - s0)
        rb = M - s0 - L
        out = ((n_pass + 1) & 1) * 2 * P
        written = np.zeros(m, int)
        for i in range(threads):
            for grp in range(i, 1 << (M - L), threads):
                r, q = grp & ((1 << rb) - 1), grp >> rb
                pos = [(q << (M - s0)) | (v << rb) | r for v in range(1 << L)]
                if src is None:
                    xr = [zr[:, p_] for p_ in pos]
                    xi = [zi[:, p_] for p_ in pos]
                else:
                    xr = [region[:, src + pad(p_)] for p_ in pos]
                    xi = [region[:, src + P + pad(p_)] for p_ in pos]
                H = 1 << (L - 1)
                for st in range(L):           # constant geometry
                    row = m - (m >> (s0 + st))
                    yr, yi = [None] * (2 * H), [None] * (2 * H)
                    for j in range(H):
                        w = tw[row + (((j >> st) << rb) | r)]
                        ar, ai, br, bi = xr[j], xi[j], xr[j + H], xi[j + H]
                        dr, di = ar - br, ai - bi
                        yr[2 * j], yi[2 * j] = ar + br, ai + bi
                        yr[2 * j + 1] = dr * w.real - di * w.imag
                        yi[2 * j + 1] = dr * w.imag + di * w.real
                    xr, xi = yr, yi
                for v in range(1 << L):
                    o = (_bitrev(v, L) << (M - L)) | (q << rb) | r
                    region[:, out + pad(o)] = xr[v]
                    region[:, out + P + pad(o)] = xi[v]
                    written[o] += 1
        assert (written == 1).all(), "a pass writes every point once"
        src = out
        s0 += L
        n_pass += 1
    q = pad(np.arange(m))
    return region[:, src + q], region[:, src + P + q]


@pytest.mark.parametrize("fft_size", [256, 512, 1024, 2048])
def test_bio_fft_walk_through_is_bitwise_fft_stages(fft_size):
    """fft 256, 512, 1024 and 2048: last passes of 3, 4, 1 and 2 stages
    (m = 128 to 1024 points), 8 to 32 threads."""
    from repro_torch.core.fft import fft_stages
    from repro_torch.kernels.fft.kernel import twiddle_table

    m = fft_size // 2
    rng = np.random.default_rng(fft_size)
    zr = rng.standard_normal((3, m)).astype(np.float32)
    zi = rng.standard_normal((3, m)).astype(np.float32)
    wr, wi = twiddle_table(m)
    got = bio_fft_walk_through(zr, zi, wr, wi, window=fft_size)
    want = fft_stages(torch.as_tensor(zr), torch.as_tensor(zi),
                      table=(torch.as_tensor(wr), torch.as_tensor(wi)))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def bio_gap_lists(is_max: np.ndarray, is_min: np.ndarray) -> list:
    """The kernel's gap compaction on one frame's (S,) masks: 32-bit mask
    words, delineation thread i taking the contiguous words [i cw, (i + 1)
    cw); the exclusive scan of (last set bit, popcount) over the threads;
    the gap of extremum number b written to list[b - 1]. Returns the two
    lists."""
    T = _bio_delineation_threads()
    S = is_max.shape[0]
    W = (S + 31) // 32
    cw = (W + T - 1) // T
    lists = []
    for mask in (is_max, is_min):
        bits = np.zeros(W * 32, bool)
        bits[:S] = mask
        words = bits.reshape(W, 32)
        last = [-1] * T
        count = [0] * T
        for i in range(T):
            for w in range(min(W, i * cw), min(W, min(W, i * cw) + cw)):
                set_ = np.flatnonzero(words[w])
                if len(set_):
                    last[i] = 32 * w + int(set_[-1])
                count[i] += len(set_)
        n = max(sum(count) - 1, 0)
        out = np.full(max(S // 2, 1), -1)
        for i in range(T):
            prev = max([-1] + last[:i])
            rank = sum(count[:i])
            for w in range(min(W, i * cw), min(W, min(W, i * cw) + cw)):
                for t in 32 * w + np.flatnonzero(words[w]):
                    if prev >= 0:
                        assert out[rank - 1] == -1
                        out[rank - 1] = t - prev
                    prev, rank = t, rank + 1
        assert (out[:n] > 0).all() and (out[n:] == -1).all()
        lists.append(out[:n])
    return lists


def bio_list_medians(lists: list, S: int) -> list:
    """The kernel's lower medians of a frame's two gap lists: where both
    hold at most kRankMax gaps, rank counting, half of the T delineation
    threads a list (thread i of a half taking gaps i, i + T/2, ...; the
    first gap of the k-th value writes); else, a list after the other,
    bisection on the value with a count over all T threads a step."""
    T, cap = _bio_delineation_threads(), _bio_cu_const("kRankMax")
    ranked = all(len(g) <= cap for g in lists)
    out = []
    for gaps in lists:
        n = len(gaps)
        k = (max(n, 1) - 1) // 2
        if n == 0:
            out.append(0)
        elif ranked:
            writes = []
            for i in range(T // 2):
                for e in range(i, n, T // 2):
                    less = int((gaps < gaps[e]).sum())
                    equal = int((gaps == gaps[e]).sum())
                    before = int((gaps[:e] == gaps[e]).sum())
                    if before == 0 and less <= k < less + equal:
                        writes.append(int(gaps[e]))
            assert len(writes) == 1, "one thread writes the median"
            out.append(writes[0])
        else:
            lo, hi = 0, S
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if int((gaps <= mid).sum()) > k:
                    hi = mid
                else:
                    lo = mid
            out.append(hi)
    return out


def _hist_median(gaps: np.ndarray, S: int) -> int:
    """The parent kernel's median: the smallest gap whose running count over
    an (S + 1)-bin histogram passes k."""
    if len(gaps) == 0:
        return 0
    k = (len(gaps) - 1) // 2
    run = np.cumsum(np.bincount(gaps, minlength=S + 1))
    return int(np.flatnonzero(run > k)[0])


@pytest.mark.parametrize("case", ["n0", "n1", "n2", "n15", "n16", "ties",
                                  "ties_long", "n65", "n200"])
def test_bio_list_median_equals_the_histogram_median(case):
    """Each list beside a short one (both ranked where it is short) and
    beside a long one (both by bisection)."""
    S = 2048
    rng = np.random.default_rng(len(case))
    n = {"n0": 0, "n1": 1, "n2": 2, "n15": 15, "n16": 16, "ties": 16,
         "ties_long": 300, "n65": 65, "n200": 200}[case]
    gaps = rng.integers(1, 200, n)
    if case.startswith("ties"):
        gaps = rng.choice([3, 7, 7, 7, 9], n)
    for other in (rng.integers(1, 200, 5), rng.integers(1, 200, 500)):
        for pair in ([gaps, other], [other, gaps]):
            got = bio_list_medians(pair, S)
            assert got == [_hist_median(g, S) for g in pair]
            if n:
                mine = got[0] if pair[0] is gaps else got[1]
                assert mine == int(np.sort(gaps)[(n - 1) // 2])


def _bio_frames(kind: str) -> torch.Tensor:
    """(R, 2048) filtered frames: the app's FIR over synthetic respiration,
    an alternating 0/1 signal (~1,024 extrema per mask) or white noise."""
    from repro_torch.core.fir import fir_direct

    if kind == "alternating":
        return torch.tensor([[0.0, 1.0] * 1024, [1.0, 0.0] * 1024])
    if kind == "noise":
        rng = np.random.default_rng(3)
        return torch.as_tensor(rng.standard_normal((2, 2048)).astype(
            np.float32))
    app = make_app(device="cpu")
    sig = synthetic_respiration(1, 5 * 512 + 2048, seed=4, device="cpu")[0][0]
    return fir_direct(frame_signal(sig, 2048, 512), app.fir_taps)


@pytest.mark.parametrize("kind", ["respiration", "alternating", "noise"])
def test_bio_masks_and_gap_lists_walk_through(kind):
    """The kernel's candidate compaction (4 consecutive samples a thread,
    each delineation warp's candidates in its own segment of the list,
    round by round) and the +-d windows shared out over those threads (a
    minimum's samples negated, one max over 16 clamped reads at a time
    into 4 accumulators) give
    `delineate`'s masks (`_dilate`); its gap compaction gives the plain
    version's gaps in order, and the list median its median."""
    from repro_torch.core.biosignal import (MIN_DISTANCE, MIN_PROMINENCE,
                                            _interval_gaps, delineate)

    T = _bio_delineation_threads()
    x = _bio_frames(kind)
    want_max, want_min = delineate(x)
    for f in range(x.shape[0]):
        v = x[f].numpy()
        S = v.shape[0]
        mu, hi, lo = x[f].mean(), x[f].max(), x[f].min()
        thr_hi = float(mu + MIN_PROMINENCE * (hi - mu))
        thr_lo = float(mu - MIN_PROMINENCE * (mu - lo))
        # warp w's segment: round j's vectors 32 w .. 32 w + 31 (past T j),
        # 4 samples each; the segments one after the other
        nv = (S + 3) // 4
        order = [4 * vec + c for w in range(T // 32)
                 for j in range(0, nv, T)
                 for vec in range(j + 32 * w, min(nv, j + 32 * w + 32))
                 for c in range(4)]
        assert sorted(order) == list(range(4 * nv))
        cands = []
        for t in order:
            if 0 < t < S - 1:
                if v[t] > v[t - 1] and v[t] >= v[t + 1] and v[t] > thr_hi:
                    cands.append((t, 0))
                elif v[t] < v[t - 1] and v[t] <= v[t + 1] and v[t] < thr_lo:
                    cands.append((t, 1))
        masks = np.zeros((2, S), bool)
        taken = []
        for i in range(T):
            for c in range(i, len(cands), T):
                t, is_min = cands[c]
                sgn = np.float32(-1.0 if is_min else 1.0)
                a, b = max(0, t - MIN_DISTANCE), min(S - 1, t + MIN_DISTANCE)
                acc = [sgn * v[t]] * 4
                for j0 in range(a, b + 1, 16):
                    for u in range(16):
                        acc[u & 3] = max(acc[u & 3], sgn * v[min(j0 + u, b)])
                masks[is_min, t] |= bool(sgn * v[t] >= max(acc))
                taken.append(c)
        assert sorted(taken) == list(range(len(cands)))
        np.testing.assert_array_equal(masks[0], want_max[f].numpy())
        np.testing.assert_array_equal(masks[1], want_min[f].numpy())
        lists = bio_gap_lists(masks[0], masks[1])
        for lst, mask in zip(lists, (want_max[f], want_min[f])):
            gaps, valid = _interval_gaps(mask)
            plain = gaps[valid].numpy()
            np.testing.assert_array_equal(lst, plain)
        assert bio_list_medians(lists, S) == [_hist_median(lst, S)
                                              for lst in lists]
        if kind == "alternating":
            assert min(len(lst) for lst in lists) >= 1000


# --------------------------------------------------- standalone FIR / FFT

_TOL = {torch.float32: (1e-5, FFT_TOL["float32"]),
        torch.bfloat16: (2e-2, FFT_TOL["bfloat16"])}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 11])
@pytest.mark.parametrize("shape,seq_block,block_rows", [
    ((5, 3000), 1024, None), ((3, 512), 2048, 2), ((1, 70000), 2048, 1)])
def test_fir_kernel_matches_plain_on_card(card, dtype, k, shape, seq_block,
                                          block_rows):
    """Rows longer than one tile: each tile reads the k-1 samples before
    it, so the filter runs over the whole row."""
    g = torch.Generator(device=card).manual_seed(k)
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    taps = torch.as_tensor(lowpass_taps(k), device=card)
    _cuda.reset_launches()
    got = fir_cuda(x, taps, seq_block=seq_block, block_rows=block_rows)
    assert _cuda.LAUNCHES["fir"]["rows"] == 1
    want = fir_plain(x, taps)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), atol=_TOL[dtype][0],
                               rtol=_TOL[dtype][0])


def _fft_close(got: tuple, want: tuple, dtype) -> None:
    tol = _TOL[dtype][1]
    scale = float(torch.maximum(want[0].abs().max(),
                                want[1].abs().max()).float())
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,rows", [(2, 301), (4, 77), (8, 300), (16, 259),
                                    (32, 129), (256, 37), (512, 9),
                                    (2048, 3), (4096, 3), (8192, 2)])
def test_fft_kernel_matches_plain_on_card(card, dtype, inverse, n, rows):
    """Row counts that no block's rows divide (the default block takes
    128 threads' worth of rows)."""
    g = torch.Generator(device=card).manual_seed(n)
    re = torch.randn(rows, n, generator=g, device=card).to(dtype)
    im = torch.randn(rows, n, generator=g, device=card).to(dtype)
    _cuda.reset_launches()
    got = fft_cuda(re, im, inverse=inverse)
    assert _cuda.LAUNCHES["fft"]["rows"] == 1
    _fft_close(got, fft_plain(re, im, inverse=inverse), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n,block_rows", [(8, 1), (256, 3), (256, 32),
                                          (1024, 7), (8192, 1)])
def test_fft_kernel_takes_block_rows_on_card(card, n, block_rows):
    g = torch.Generator(device=card).manual_seed(block_rows)
    re = torch.randn(50, n, generator=g, device=card)
    im = torch.randn(50, n, generator=g, device=card)
    got = fft_cuda(re, im, block_rows=block_rows)
    _fft_close(got, fft_plain(re, im), torch.float32)
    with pytest.raises(ValueError, match="threads"):
        fft_cuda(re, im, block_rows=513 // threads_per_row(n) + 1)
    with pytest.raises(ValueError, match="positive"):
        fft_cuda(re, im, block_rows=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fft_kernel_reads_views_on_card(card, dtype):
    """A column slice (not contiguous) and a view whose base is off a
    16-byte boundary (4 bytes in bfloat16, 8 in float32)."""
    g = torch.Generator(device=card).manual_seed(5)
    wide = torch.randn(40, 600, generator=g, device=card).to(dtype)
    re, im = wide[:, 8:264], wide[:, 300:556]
    assert not re.is_contiguous()
    _fft_close(fft_cuda(re, im), fft_plain(re.contiguous(),
                                           im.contiguous()), dtype)
    flat = torch.randn(2 + 33 * 256, generator=g, device=card).to(dtype)
    off = flat[2:].view(33, 256)
    assert off.data_ptr() % 16
    _fft_close(fft_cuda(off, off, inverse=True),
               fft_plain(off, off, inverse=True), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 16, 32, 256, 512, 4096, 8192])
def test_fft_binding_agrees_with_the_host_plan(card, n):
    lib = _cuda.library("fft")
    assert lib.fft_table_size(n) == len(stockham_table(n))
    assert lib.fft_threads_per_row(n) == threads_per_row(n)


@pytest.mark.cuda
def test_fir_and_fft_refuse_what_they_do_not_take(card):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fir_cuda(torch.zeros(2, 64, device=card, dtype=torch.float64),
                 [1.0, -0.97])
    with pytest.raises(ValueError, match="taps"):
        fir_cuda(torch.zeros(2, 64, device=card), torch.ones(65))
    with pytest.raises(ValueError, match="power of 2"):
        fft_cuda(torch.zeros(2, 12, device=card),
                 torch.zeros(2, 12, device=card))
    with pytest.raises(ValueError, match="shared memory"):
        fft_cuda(torch.zeros(1, 16384, device=card),
                 torch.zeros(1, 16384, device=card))


@pytest.mark.cuda
def test_launch_knobs_do_not_change_results_on_card(card):
    """The knobs `core.autotune` measures change the speed, never the
    bits: the ASR graph's frames a block (up to past the 512 threads a
    block holds), the FIR's and the FFT's rows a block."""
    from repro_torch.kernels.fft.kernel import MAX_THREADS, threads_per_row
    from repro_torch.kernels.pipeline.asr import make_asr_frontend

    app = make_asr_frontend(device=card)
    graph, operands = get_graph_factory("asr")(app)
    g = torch.Generator().manual_seed(5)
    sig = (0.3 * torch.randn(160 * 70 + 512, generator=g)).to(card)
    runs = [graph_stream_call(sig, operands, graph=graph, window=512,
                              hop=160, block_frames=b)
            for b in (1, 2, 4, 8, 16, 32, 40)]
    for other in runs[1:]:
        for k in runs[0]:
            assert torch.equal(other[k], runs[0][k]), k
    x = torch.randn(37, 3000, generator=g).to(card)
    taps = lowpass_taps(11)
    ys = [fir_cuda(x, taps, block_rows=r) for r in (1, 2, 3, 8, 37)]
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    for n in (16, 512, 4096):
        re = torch.randn(45, n, generator=g).to(card)
        im = torch.randn(45, n, generator=g).to(card)
        top = MAX_THREADS // threads_per_row(n)
        outs = [fft_cuda(re, im, block_rows=r)
                for r in sorted({1, 2, 3, max(1, top // 2), top})
                if r <= top]
        for o in outs[1:]:
            assert torch.equal(o[0], outs[0][0])
            assert torch.equal(o[1], outs[0][1])


@pytest.mark.cuda
def test_tuned_calls_equal_untuned_on_card(card):
    """A tuned stream (raw and host-framed, biosignal and ASR), a tuned
    resident loop, FIR and FFT each equal the untuned run bitwise, and
    every search was timed with CUDA events."""
    from repro_torch.core import autotune
    from repro_torch.kernels.fft.ops import fft
    from repro_torch.kernels.fir.ops import fir
    from repro_torch.kernels.pipeline.asr import make_asr_frontend
    from repro_torch.serve.resident import ResidentConfig, ResidentStream
    from repro_torch.serve.stream import BiosignalStream, StreamConfig

    autotune.clear_cache()
    app = make_app(device=card)
    sig = synthetic_respiration(1, 60 * 512 + 2048, seed=9, device=card)[0][0]
    for framing in ("kernel", "host"):
        cfg = StreamConfig(window=2048, hop=512, batch_windows=8,
                           framing=framing)
        want = BiosignalStream(app, cfg).process(sig)
        got = BiosignalStream(app, StreamConfig(
            window=2048, hop=512, batch_windows=8, framing=framing,
            autotune=True)).process(sig)
        for k in want:
            assert torch.equal(got[k], want[k]), (framing, k)
    cfg = StreamConfig(window=2048, hop=512, batch_windows=8)
    want = ResidentStream(app, cfg).process(sig)
    got = ResidentStream(app, cfg, ResidentConfig(autotune=True)).process(sig)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    asr = make_asr_frontend(device=card)
    audio = (0.3 * torch.randn(160 * 90 + 512, generator=torch.Generator()
                               .manual_seed(1))).to(card)
    acfg = dict(window=512, hop=160, batch_windows=32, graph="asr")
    want = BiosignalStream(asr, StreamConfig(**acfg)).process(audio)
    got = BiosignalStream(asr, StreamConfig(autotune=True, **acfg)).process(
        audio)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    x = torch.randn(64, 4096, device=card)
    assert torch.equal(fir(x, lowpass_taps(11), autotune=True),
                       fir(x, lowpass_taps(11)))
    re, im = torch.randn(300, 512, device=card), torch.randn(300, 512,
                                                             device=card)
    for a, b in zip(fft(re, im, autotune=True), fft(re, im)):
        assert torch.equal(a, b)
    log = autotune.search_log()
    assert log and all(v["clock"] == "cuda" for v in log.values())
    autotune.clear_cache()
