"""The fused biosignal graph kernel (`csrc/biosignal_graph.cu`) against
its plain PyTorch version. This file imports torch and the port only, so
it also runs on a machine with the card and no jax:

    python -m pytest -q -m cuda tests/test_torch_kernel.py

The `cuda`-marked tests skip without a card. Tolerances on the card:
class, filtered and the interval time features exact (same comparisons,
integer arithmetic, and the FIR in the same order without FMA on both
sides); band powers rtol/atol 1e-5 and margin rtol 1e-5 atol 1e-4 (the
delineation mean, the segment mean and the band sums reduce in another
order)."""
import re

import pytest
import torch

from repro_torch.core.biosignal import make_app, synthetic_respiration
from repro_torch.kernels.pipeline import cuda
from repro_torch.kernels.pipeline.graph import (
    get_graph_factory, graph_frames_call, graph_frames_plain,
    graph_ring_call, graph_ring_plain, graph_stream_call,
    graph_stream_plain, ring_chunk_samples)
from repro_torch.kernels.pipeline.kernel import OUTPUTS
from repro_torch.serve.stream import frame_signal

SOURCE = cuda.SOURCE.read_text()


def test_binding_matches_the_source():
    """The C symbols and output bits the ctypes binding relies on are the
    ones the source defines."""
    for sym in ("biosignal_graph_launch", "biosignal_graph_smem_bytes",
                "biosignal_graph_error_string"):
        assert re.search(rf"\b{sym}\(", SOURCE), sym
    for name, bit in cuda._OUT_BITS.items():
        const = "kOut" + name.capitalize()
        assert re.search(rf"constexpr int {const} = {bit};", SOURCE), name
    assert "-use_fast_math" not in cuda.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda.NVCC_FLAGS


def test_launch_counts_reset():
    cuda.LAUNCHES["ring"] += 2
    cuda.reset_launches()
    assert cuda.LAUNCHES == {"frames": 0, "stream": 0, "ring": 0}


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
    cuda.reset_launches()
    stream = graph_stream_call(sig, operands, window=window, hop=hop, **kw)
    frames = frame_signal(sig, window, hop)
    framed = graph_frames_call(frames, operands, block_rows=3, **kw)
    bw, depth = 4, 3
    span, stride = ring_chunk_samples(window, hop, bw), bw * hop
    ring = sig[: (depth - 1) * stride + span].as_strided(
        (depth, span), (stride, 1))
    ringed = graph_ring_call(ring, operands, window=window, hop=hop, **kw)
    assert cuda.LAUNCHES == {"frames": 1, "stream": 1, "ring": 1}
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
