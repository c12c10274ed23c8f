"""The port's stage-graph entries (`repro_torch.kernels.pipeline`) against
the JAX package's fused Pallas entries, on the CPU, at window 512.

The JAX side runs as its own tests run it here: the `ops.py` entries, whose
`_interpret` puts every `pallas_call` in interpret mode. The port's entries
get CPU tensors, so they run the plain PyTorch version; the CUDA kernel is
held to that same plain version on the card (`tests/test_torch_kernel.py`
and `chip_smoke.py`).

Tolerances, and why:
* class, the interval time features (features[:, :6]): exact — integer
  gaps, exact f32 sums, IEEE division/sqrt, and identical masks;
* filtered: atol 1e-6 — same taps, same order; XLA may contract an FMA;
* band powers (features[:, 6:]): rtol/atol 1e-5 — the segment mean and
  the band sums reduce in another order;
* margin: rtol 1e-5, atol 1e-4 — twelve products summed in another order,
  margins of a few hundred.
Within the port, stream == framed and ring slot r == single chunk are
bitwise.
"""
import numpy as np
import pytest
import torch

from repro.core.biosignal import make_app as j_make_app
from repro.core.biosignal import synthetic_respiration as j_synth
from repro.kernels.fft.kernel import twiddle_table as j_twiddle_table
from repro.kernels.pipeline import graph as jgraph
from repro.kernels.pipeline.kernel import untangle_table as j_untangle_table
from repro.kernels.pipeline import ops as jops
from repro_torch.core.biosignal import app_from_numpy
from repro_torch.kernels.pipeline import ops
from repro_torch.kernels.pipeline import graph as tgraph
from repro_torch.kernels.pipeline.graph import (
    OutputSpec, build_graph, default_app, get_graph_factory,
    graph_frames_call, graph_frames_plain, graph_ring_call, graph_ring_plain,
    graph_stream_call, graph_stream_plain, register_graph_factory,
    registered_graphs, ring_chunk_samples, stages_to_run,
    stream_frame_count)
from repro_torch.kernels.pipeline.kernel import (OUTPUTS, biosignal_graph,
                                                 canonical_outputs,
                                                 empty_outputs,
                                                 twiddle_table,
                                                 untangle_table)
from repro_torch.kernels.pipeline.stages import (OperandMismatchError,
                                                 StageGraphError,
                                                 UnknownGraphError,
                                                 UnknownStageError,
                                                 get_stage, register_stage,
                                                 registered_stages)
from repro_torch.serve.stream import frame_signal

WINDOW = 512


@pytest.fixture(scope="module")
def apps():
    japp = j_make_app()
    app = app_from_numpy(japp.fir_taps, np.asarray(japp.svm_w),
                         np.asarray(japp.svm_b), japp.fft_size, device="cpu")
    return japp, app


def _signal(n_samples, seed=0):
    return np.asarray(j_synth(1, n_samples, seed=seed)[0][0])


def assert_matches_reference(got: dict, want: dict):
    """Port output vs JAX output, with the tolerances of the module
    docstring."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape)
        if k == "class":
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "filtered":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        elif k == "features":
            np.testing.assert_array_equal(g[..., :6], w[..., :6], err_msg=k)
            np.testing.assert_allclose(g[..., 6:], w[..., 6:], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4, err_msg=k)


def assert_identical(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# --------------------------------------------------- parity with the JAX side

@pytest.mark.parametrize("hop,n_frames", [(128, 7), (256, 5), (512, 3)])
def test_stream_matches_reference(apps, hop, n_frames):
    """Non-dividing frame counts (the reference's block is 8 frames)."""
    japp, app = apps
    sig = _signal((n_frames - 1) * hop + WINDOW + hop // 2, seed=hop)
    want = jops.app_pipeline_stream(japp, sig, window=WINDOW, hop=hop)
    got = ops.app_pipeline_stream(app, torch.as_tensor(sig), window=WINDOW,
                                  hop=hop)
    assert got["class"].shape == (n_frames,)
    assert_matches_reference(got, want)


def test_frames_matches_reference(apps):
    japp, app = apps
    frames = np.stack([_signal(WINDOW, seed=s) for s in range(6)])
    want = jops.app_pipeline(japp, frames)
    got = ops.app_pipeline(app, torch.as_tensor(frames))
    assert_matches_reference(got, want)


def test_ring_matches_reference(apps):
    japp, app = apps
    hop, bw, depth = 128, 4, 3
    span, stride = ring_chunk_samples(WINDOW, hop, bw), bw * hop
    sig = _signal((depth - 1) * stride + span, seed=11)
    ring = np.stack([sig[r * stride: r * stride + span]
                     for r in range(depth)])
    want = jops.app_pipeline_ring(japp, ring, window=WINDOW, hop=hop)
    got = ops.app_pipeline_ring(app, torch.as_tensor(ring), window=WINDOW,
                                hop=hop)
    assert got["features"].shape == (depth, bw, 12)
    assert_matches_reference(got, want)


def test_output_selection_matches_reference(apps):
    japp, app = apps
    sig = _signal(3 * 256 + WINDOW, seed=5)
    sel = ("margin", "class")
    want = jops.app_pipeline_stream(japp, sig, window=WINDOW, hop=256,
                                    outputs=sel)
    got = ops.app_pipeline_stream(app, torch.as_tensor(sig), window=WINDOW,
                                  hop=256, outputs=sel)
    assert_matches_reference(got, want)


@pytest.mark.parametrize("outputs", [None, ("class",), ("filtered",)])
def test_zero_frames_match_reference_shapes(apps, outputs):
    japp, app = apps
    sig = _signal(WINDOW - 1)
    want = jops.app_pipeline_stream(japp, sig, window=WINDOW, hop=128,
                                    outputs=outputs)
    got = ops.app_pipeline_stream(app, torch.as_tensor(sig), window=WINDOW,
                                  hop=128, outputs=outputs)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].numpy().dtype == w.dtype
    e = empty_outputs(WINDOW, 12, 2, torch.float32, outputs, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in e.items()} == \
        {k: (v.shape, v.dtype) for k, v in got.items()}


@pytest.mark.parametrize("n_samples,window,hop,override", [
    (0, 512, 128, None), (511, 512, 128, None), (512, 512, 128, None),
    (5_529_600, 2048, 512, None), (3000, 1024, 320, 2), (4096, 512, 512, 5)])
def test_framing_arithmetic_matches_reference(n_samples, window, hop,
                                              override):
    n = tgraph.stream_frame_count(n_samples, window, hop)
    assert n == jgraph.stream_frame_count(n_samples, window, hop)
    assert tgraph.min_stream_block_frames(window, hop) == \
        jgraph.min_stream_block_frames(window, hop)
    assert tgraph.resolve_stream_block_frames(n, window, hop, override) == \
        jgraph.resolve_stream_block_frames(n, window, hop, override)
    assert tgraph.ring_chunk_samples(window, hop, 8) == \
        jgraph.ring_chunk_samples(window, hop, 8)


@pytest.mark.parametrize("n", [4, 256])
def test_fft_tables_are_the_reference_tables(n):
    for mine, ref in zip(twiddle_table(n), j_twiddle_table(n)):
        np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(untangle_table(2 * n),
                                  j_untangle_table(2 * n))


# ------------------------------------------------------- within the port

@pytest.mark.parametrize("hop", [128, 200, 512])
@pytest.mark.parametrize("outputs", [OUTPUTS, ("features",), ("filtered",),
                                     ("margin", "class")])
def test_stream_equals_framed_bitwise(apps, hop, outputs):
    _, app = apps
    sig = torch.as_tensor(_signal(4 * hop + WINDOW + 7, seed=hop))
    s = ops.app_pipeline_stream(app, sig, window=WINDOW, hop=hop,
                                outputs=outputs)
    f = ops.app_pipeline(app, frame_signal(sig, WINDOW, hop),
                         outputs=outputs)
    assert_identical(s, f)
    full = ops.app_pipeline_stream(app, sig, window=WINDOW, hop=hop)
    assert_identical(s, {k: full[k] for k in canonical_outputs(outputs)})


@pytest.mark.parametrize("hop,bw,depth", [(128, 4, 3), (512, 2, 2),
                                          (320, 3, 4)])
def test_ring_slot_equals_single_chunk_bitwise(apps, hop, bw, depth):
    _, app = apps
    window = 1024 if hop == 320 else WINDOW
    span, stride = ring_chunk_samples(window, hop, bw), bw * hop
    sig = torch.as_tensor(_signal((depth - 1) * stride + span, seed=depth))
    ring = sig.as_strided((depth, span), (stride, 1))      # overlapping view
    res = ops.app_pipeline_ring(app, ring, window=window, hop=hop)
    for r in range(depth):
        one = ops.app_pipeline_stream(app, ring[r].contiguous(),
                                      window=window, hop=hop)
        assert_identical({k: v[r] for k, v in res.items()}, one)


def test_ring_writes_preallocated_outputs(apps):
    _, app = apps
    graph, operands = get_graph_factory("biosignal")(app)
    ring = torch.as_tensor(_signal(2 * 1024, seed=3)).reshape(2, 1024)
    n = stream_frame_count(1024, WINDOW, 256)
    out = {"features": torch.empty(2 * n, 12), "class":
           torch.empty(2 * n, dtype=torch.int32)}
    res = graph_ring_call(ring, operands, graph=graph, window=WINDOW,
                          hop=256, outputs=("features", "class"), out=out)
    assert torch.equal(out["features"].reshape(2, n, 12), res["features"])
    assert torch.equal(out["class"].reshape(2, n), res["class"])


@pytest.mark.parametrize("valid_frames,want", [(None, 6), (4, 4), (9, 6),
                                               (0, 0)])
def test_ring_adds_its_valid_frames_to_the_retire_counter(apps, valid_frames,
                                                          want):
    """The resident loop's retire counter: a ring call adds the frames it
    computed among the first ``valid_frames`` (2 slots x 3 frames here),
    into a view of a per-sweep count array."""
    _, app = apps
    graph, operands = get_graph_factory("biosignal")(app)
    ring = torch.as_tensor(_signal(2 * 1024, seed=3)).reshape(2, 1024)
    counts = torch.tensor([5, 7], dtype=torch.int32)
    graph_ring_call(ring, operands, graph=graph, window=WINDOW, hop=256,
                    outputs=("class",), retired=counts[1],
                    valid_frames=valid_frames)
    assert counts.tolist() == [5, 7 + want]


def test_entries_on_cpu_tensors_run_the_plain_version(apps):
    _, app = apps
    graph, operands = get_graph_factory("biosignal")(app)
    sig = torch.as_tensor(_signal(4 * 128 + WINDOW, seed=8))
    kw = dict(graph=graph, window=WINDOW, hop=128)
    assert_identical(graph_stream_call(sig, operands, **kw),
                     graph_stream_plain(sig, operands, **kw))
    frames = frame_signal(sig, WINDOW, 128)
    assert_identical(graph_frames_call(frames, operands, graph=graph),
                     graph_frames_plain(frames, operands, graph=graph))
    ring = sig[: 2 * WINDOW].reshape(2, WINDOW)
    assert_identical(graph_ring_call(ring, operands, **kw),
                     graph_ring_plain(ring, operands, **kw))


def test_elision_and_graph_introspection():
    g = biosignal_graph(11, 12, 2, 512)
    assert [s.name for s in stages_to_run(g, ("filtered",))] == []
    assert [s.name for s in stages_to_run(g, ("features",))] == \
        ["delineate", "biosignal_features"]
    assert [s.name for s in stages_to_run(g, ("class",))] == \
        ["delineate", "biosignal_features", "svm"]
    assert g.output_names == OUTPUTS
    assert {"fir", "delineate", "biosignal_features", "svm"} <= \
        set(registered_stages())
    assert "biosignal" in registered_graphs()
    app = default_app("biosignal", device="cpu")
    assert app.svm_w.shape == (12, 2) and app.device.type == "cpu"


# ------------------------------------------------------------ typed errors

def test_unknown_graph_raises_typed():
    assert callable(get_graph_factory("asr"))
    with pytest.raises(UnknownGraphError, match="registered: .*'asr'"):
        get_graph_factory("nope")
    from repro_torch.serve.stream import BiosignalStream, StreamConfig
    with pytest.raises(UnknownGraphError):
        BiosignalStream(None, StreamConfig(graph="nope"), device="cpu")


def test_graph_build_errors_are_typed():
    fir = ("filtered", OutputSpec(("window",), "input"))
    with pytest.raises(UnknownStageError):
        get_stage("no_such_stage")
    with pytest.raises(UnknownStageError):
        build_graph("g", ("fir", "no_such_stage"), (fir,), ("fir_taps",),
                    (("n_taps", 3), ("fft_size", 8)))
    with pytest.raises(StageGraphError, match="first stage"):
        build_graph("g", ("delineate",), (), (), (("n_taps", 3),
                                                  ("fft_size", 8)))
    with pytest.raises(StageGraphError, match="missing param"):
        build_graph("g", ("fir",), (fir,), ("fir_taps",), (("n_taps", 3),))
    with pytest.raises(OperandMismatchError, match="does not bind"):
        build_graph("g", ("fir",), (fir,), (), (("n_taps", 3),
                                                ("fft_size", 8)))
    with pytest.raises(OperandMismatchError, match="read by no stage"):
        build_graph("g", ("fir",), (fir,), ("fir_taps", "extra"),
                    (("n_taps", 3), ("fft_size", 8)))
    with pytest.raises(OperandMismatchError, match="requires state"):
        build_graph("g", ("fir", "svm"), (fir,), ("fir_taps", "svm_w",
                                                  "svm_b"),
                    (("n_taps", 3), ("fft_size", 8)))
    with pytest.raises(StageGraphError, match="produced by no stage"):
        build_graph("g", ("fir",), (fir, ("margin", OutputSpec((2,)))),
                    ("fir_taps",), (("n_taps", 3), ("fft_size", 8)))
    with pytest.raises(StageGraphError, match="already registered"):
        register_stage("fir")(lambda *a: {})
    with pytest.raises(StageGraphError, match="already registered"):
        register_graph_factory("biosignal", lambda app: None)
    with pytest.raises(StageGraphError):
        OutputSpec((), "float64")
    assert issubclass(StageGraphError, ValueError)


def test_output_selection_errors():
    with pytest.raises(StageGraphError, match="unknown outputs"):
        canonical_outputs(("filtered", "logits"))
    with pytest.raises(StageGraphError, match="empty"):
        canonical_outputs(())
    assert canonical_outputs(("class", "filtered")) == ("filtered", "class")


def test_later_slices_raise_not_implemented(apps):
    _, app = apps
    sig = torch.as_tensor(_signal(WINDOW))
    with pytest.raises(NotImplementedError, match="column deal"):
        ops.app_pipeline_stream(app, sig, window=WINDOW, hop=128,
                                n_columns=2)
    with pytest.raises(NotImplementedError, match="autotune"):
        ops.app_pipeline(app, sig[None], autotune=True)
    with pytest.raises(ValueError, match="window"):
        ops.app_pipeline_stream(app, sig, window=256, hop=128)
