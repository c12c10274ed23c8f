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
* ASR: filtered exact (the same FIR); logmel within 1e-5 of its largest
  magnitude (the mel sums run in another order than the plain version's);
* FIR: within 1e-5 in float32 and 2e-2 in bfloat16 (the kernel repeats
  the plain version's operations in its order, so they usually agree to
  the last bit);
* FFT: max |kernel - plain| <= `FFT_TOL` x max |plain| (1e-4 in float32,
  1e-2 in bfloat16): radix-16 passes with FMA against the plain radix-2
  chain agree to float32 rounding, not bitwise."""
import re

import pytest
import torch

from repro_torch.core.biosignal import make_app, synthetic_respiration
from repro_torch.core.fir import lowpass_taps
from repro_torch.kernels import _cuda
from repro_torch.kernels.fft.kernel import (FFT_TOL, fft_cuda, fft_plain,
                                            stockham_table, threads_per_row)
from repro_torch.kernels.fir.kernel import fir_cuda, fir_plain
from repro_torch.kernels.flash_attention import kernel as _flash  # noqa
from repro_torch.kernels.pipeline import cuda
from repro_torch.kernels.rope import kernel as _rope  # noqa: F401
from repro_torch.kernels.shuffle import kernel as _shuffle  # noqa: F401
from repro_torch.kernels.pipeline.asr import make_asr_frontend
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
            assert float((g - w).abs().max()) / scale < 1e-5, k


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
