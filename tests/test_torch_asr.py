"""The port's ASR front-end (`repro_torch.kernels.pipeline.asr`) against the
JAX package's, on the CPU.

The JAX side runs as `tests/test_asr.py` runs it here: the `ops.py` graph
entries put the fused `pallas_call` in interpret mode. The port's entries
get CPU tensors, so they run the plain PyTorch version, which the CUDA
kernel (`csrc/asr_graph.cu`) is held to on the card
(`tests/test_torch_kernel.py`, `chip_smoke.py`). Inputs are drawn with
numpy from a seed and handed to both.

Tolerances, and why:
* logmel: 1e-5 of max(1, max |reference|), the tolerance of
  `tests/test_asr.py` — the mel sums run in another order (the JAX dot,
  the port's row-wise reduction, numpy's float64 FFT in the oracle);
* filtered: atol 1e-6 — the same two taps in the same order (XLA may
  contract an FMA);
* tables (Hann, mel filterbank, twiddles, untangle): bit for bit.
Within the port, stream == framed == ring slot == `StreamConfig(graph=
"asr")` runs == one call are bitwise.
"""
import numpy as np
import pytest
import torch

from repro.kernels.pipeline import asr as jasr
from repro.kernels.pipeline import ops as jops
from repro.kernels.pipeline.graph import get_graph_factory as j_factory
from repro_torch.kernels.pipeline import asr
from repro_torch.kernels.pipeline import ops
from repro_torch.kernels.pipeline.graph import (default_app,
                                                get_graph_factory,
                                                graph_ring_call,
                                                ring_chunk_samples,
                                                stages_to_run,
                                                stream_frame_count)
from repro_torch.serve.resident import ResidentConfig, ResidentStream
from repro_torch.serve.stream import (BiosignalStream, StreamConfig,
                                      frame_signal)

SHAPES = [
    (512, 160, 512 * 10 + 37),   # whisper-style hop, ragged tail
    (512, 512, 2048),            # hop == window
    (1024, 256, 5000),           # window > fft_size: Hann on the prefix
    (512, 128, 512),             # exactly one frame
    (512, 160, 5000),            # hop does not divide window, tail pad
]


def _audio(n, seed):
    """The speech-band stand-in of `tests/test_asr.py`: a chirp + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = np.sin(2 * np.pi * (200 + 40 * t) * t) + 0.1 * rng.standard_normal(n)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def apps():
    return jasr.make_asr_frontend(), asr.make_asr_frontend(device="cpu")


def assert_close(got: dict, want: dict, tol: float = 1e-5):
    """Port output (tensors) vs a reference (arrays), with the tolerances
    of the module docstring."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape,
                                                           w.shape)
        if w.size == 0:
            continue
        if k == "filtered":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            scale = max(1.0, float(np.abs(w).max()))
            err = float(np.abs(g.astype(np.float64) - w).max()) / scale
            assert err < tol, (k, err)


def assert_identical(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# --------------------------------------------------- parity with the JAX side

@pytest.mark.parametrize("window,hop,n_samples", SHAPES)
def test_stream_matches_reference(apps, window, hop, n_samples):
    japp, app = apps
    raw = _audio(n_samples, seed=window + hop)
    want = jops.graph_pipeline_stream("asr", japp, raw, window=window,
                                      hop=hop)
    got = ops.graph_pipeline_stream("asr", app, torch.as_tensor(raw),
                                    window=window, hop=hop)
    n = stream_frame_count(n_samples, window, hop)
    assert got["logmel"].shape == (n, 64)
    assert_close(got, want)
    # both against the numpy oracle, the port's and the JAX package's
    ref = asr.asr_reference(app, raw, window=window, hop=hop)
    assert_close(got, ref)
    jref = jasr.asr_reference(japp, raw, window=window, hop=hop)
    assert_close(got, jref)
    np.testing.assert_array_equal(ref["filtered"], jref["filtered"])
    assert_close({"logmel": ref["logmel"]}, {"logmel": jref["logmel"]},
                 tol=1e-6)        # numpy products on other table layouts


def test_zero_frame_signal_matches_reference(apps):
    japp, app = apps
    raw = _audio(100, seed=1)
    want = jops.graph_pipeline_stream("asr", japp, raw, window=512, hop=160)
    got = ops.graph_pipeline_stream("asr", app, torch.as_tensor(raw),
                                    window=512, hop=160)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape == (0, 512 if k == "filtered"
                                           else 64)
        assert got[k].numpy().dtype == np.asarray(w).dtype
    ref = asr.asr_reference(app, raw, window=512, hop=160)
    assert ref["logmel"].shape == (0, 64)
    staged = asr.asr_staged(app, torch.as_tensor(raw), window=512, hop=160)
    assert {k: tuple(v.shape) for k, v in staged.items()} == \
        {"filtered": (0, 512), "logmel": (0, 64)}


def test_framed_entry_matches_reference(apps):
    japp, app = apps
    frames = asr.host_frames(_audio(512 * 8 + 91, seed=3), 512, 256)
    np.testing.assert_array_equal(
        frames, jasr.host_frames(_audio(512 * 8 + 91, seed=3), 512, 256))
    want = jops.graph_pipeline("asr", japp, frames)
    got = ops.graph_pipeline("asr", app, torch.as_tensor(frames))
    assert_close(got, want)
    assert_close(got, asr.asr_reference_frames(app, frames))
    # the app's forward is the staged front-end in plain PyTorch
    assert_close(app(torch.as_tensor(frames)), want)


def test_ring_matches_reference(apps):
    japp, app = apps
    window, hop, bw, depth = 512, 160, 6, 3
    span = ring_chunk_samples(window, hop, bw)
    ring = np.stack([_audio(span, seed=20 + r) for r in range(depth)])
    want = jops.graph_pipeline_ring("asr", japp, ring, window=window,
                                    hop=hop)
    got = ops.graph_pipeline_ring("asr", app, torch.as_tensor(ring),
                                  window=window, hop=hop)
    assert got["logmel"].shape == (depth, bw, 64)
    assert_close(got, want)


@pytest.mark.parametrize("outputs", [("logmel",), ("filtered",)])
def test_output_selection_matches_reference(apps, outputs):
    japp, app = apps
    raw = _audio(512 * 5, seed=9)
    want = jops.graph_pipeline_stream("asr", japp, raw, window=512, hop=160,
                                      outputs=outputs)
    got = ops.graph_pipeline_stream("asr", app, torch.as_tensor(raw),
                                    window=512, hop=160, outputs=outputs)
    assert sorted(got) == list(outputs)
    assert_close(got, want)


def test_staged_baseline_matches_reference(apps):
    """`asr_staged` (the standalone FIR and FFT entries) against the JAX
    package's `asr_staged` and against the fused graph."""
    japp, app = apps
    raw = _audio(512 * 6 + 17, seed=5)
    want = jasr.asr_staged(japp, raw, window=512, hop=160)
    got = asr.asr_staged(app, torch.as_tensor(raw), window=512, hop=160)
    assert_close(got, want)
    fused = ops.graph_pipeline_stream("asr", app, torch.as_tensor(raw),
                                      window=512, hop=160)
    torch.testing.assert_close(got["filtered"], fused["filtered"], rtol=0,
                               atol=0)
    assert_close(got, {k: v.numpy() for k, v in fused.items()})


@pytest.mark.parametrize("n", [64, 512])
def test_tables_are_the_reference_tables(n):
    np.testing.assert_array_equal(asr.hann_window(n), jasr.hann_window(n))
    for args in ((512, 64, 16000.0), (400, 80, 16000.0, 20.0, 7600.0),
                 (n, 40, 8000.0)):
        np.testing.assert_array_equal(asr.mel_filterbank(*args),
                                      jasr.mel_filterbank(*args))
    f = np.array([0.0, 500.0, 999.9, 1000.0, 4000.0, 8000.0])
    np.testing.assert_array_equal(asr._hz_to_mel(f), jasr._hz_to_mel(f))
    np.testing.assert_array_equal(asr._mel_to_hz(asr._hz_to_mel(f)),
                                  jasr._mel_to_hz(jasr._hz_to_mel(f)))


def test_factory_binds_the_reference_operands(apps):
    japp, app = apps
    jgraph, jops_ = j_factory("asr")(japp)
    graph, operands = get_graph_factory("asr")(app)
    assert graph.operands == jgraph.operands
    assert dict(graph.params) == dict(jgraph.params)
    assert graph.output_names == jgraph.output_names
    assert [s.name for s in graph.stages] == [s.name for s in jgraph.stages]
    for mine, ref in zip(operands, jops_):
        assert mine.is_contiguous() and mine.dtype == torch.float32
        ref = np.asarray(ref)       # the JAX taps are a (1, k) row
        assert mine.numel() == ref.size
        np.testing.assert_array_equal(mine.numpy(),
                                      ref.reshape(tuple(mine.shape)))


# ------------------------------------------------------- within the port

@pytest.mark.parametrize("hop", [128, 160, 512])
def test_stream_equals_framed_and_ring_bitwise(apps, hop):
    _, app = apps
    sig = torch.as_tensor(_audio(6 * hop + 512 + 7, seed=hop))
    s = ops.graph_pipeline_stream("asr", app, sig, window=512, hop=hop)
    f = ops.graph_pipeline("asr", app, frame_signal(sig, 512, hop))
    assert_identical(s, f)
    bw, depth = 2, 3
    span, stride = ring_chunk_samples(512, hop, bw), bw * hop
    ring = sig[: (depth - 1) * stride + span].as_strided((depth, span),
                                                          (stride, 1))
    r = ops.graph_pipeline_ring("asr", app, ring, window=512, hop=hop)
    for d in range(depth):
        assert_identical({k: v[d] for k, v in r.items()},
                         {k: v[d * bw: d * bw + bw] for k, v in s.items()})
    only = ops.graph_pipeline_stream("asr", app, sig, window=512, hop=hop,
                                     outputs=("logmel",))
    assert_identical(only, {"logmel": s["logmel"]})


@pytest.mark.parametrize("batch_windows,outputs", [(8, None),
                                                   (3, ("logmel",))])
def test_stream_config_asr_equals_one_call_bitwise(apps, batch_windows,
                                                   outputs):
    _, app = apps
    raw = torch.as_tensor(_audio(512 * 9 + 77, seed=15))
    kw = {} if outputs is None else {"outputs": outputs}
    cfg = StreamConfig(window=512, hop=160, batch_windows=batch_windows,
                       graph="asr", **kw)
    one = ops.graph_pipeline_stream("asr", app, raw, window=512, hop=160,
                                    outputs=outputs)
    assert_identical(BiosignalStream(app, cfg).process(raw), one)
    host = BiosignalStream(app, StreamConfig(
        window=512, hop=160, batch_windows=batch_windows, graph="asr",
        framing="host", **kw)).process(raw)
    assert_identical(host, one)
    rs = ResidentStream(app, cfg, ResidentConfig(ring_depth=4))
    assert_identical(rs.process(raw), one)
    n = stream_frame_count(raw.shape[0], 512, 160)
    assert rs.last_drains[-1] == n


def test_stream_default_app_and_zero_frames():
    cfg = StreamConfig(window=512, hop=160, batch_windows=4, graph="asr",
                       outputs=("logmel",))
    stream = BiosignalStream(None, cfg, device="cpu")
    assert isinstance(stream.app, asr.AsrFrontendApp)
    assert stream.cfg.outputs == ("logmel",)
    assert BiosignalStream(None, StreamConfig(graph="asr", window=512),
                           device="cpu").cfg.outputs == ("filtered",
                                                         "logmel")
    empty = stream.process(torch.as_tensor(_audio(100, seed=17)))
    assert sorted(empty) == ["logmel"]
    assert empty["logmel"].shape == (0, 64)


def test_ring_adds_its_valid_frames_to_the_retire_counter(apps):
    _, app = apps
    graph, operands = get_graph_factory("asr")(app)
    ring = torch.as_tensor(_audio(2 * 1024, seed=3)).reshape(2, 1024)
    counts = torch.tensor([5, 7], dtype=torch.int32)
    graph_ring_call(ring, operands, graph=graph, window=512, hop=256,
                    outputs=("logmel",), retired=counts[1], valid_frames=4)
    assert counts.tolist() == [5, 11]


def test_app_and_graph_introspection():
    app = default_app("asr", device="cpu")
    assert isinstance(app, asr.AsrFrontendApp) and app.device.type == "cpu"
    assert app.fft_size == 512 and app.n_mels == 64
    np.testing.assert_allclose(app.fir_taps.numpy(), [1.0, -0.97])
    for buf in (app.fir_taps, app.hann, app.mel_weights):
        assert buf.is_contiguous() and buf.dtype == torch.float32
    assert tuple(app.mel_weights.shape) == (257, 64)
    g = asr.asr_graph(2, 512, 64)
    assert [s.name for s in stages_to_run(g, ("filtered",))] == []
    assert [s.name for s in stages_to_run(g, ("logmel",))] == \
        ["hann", "power_spectrum", "logmel"]
    wide = asr.make_asr_frontend(device="cpu", n_mels=80, fmax=7600.0)
    assert tuple(wide.mel_weights.shape) == (257, 80)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            asr.make_asr_frontend()
        with pytest.raises(RuntimeError, match="cuda"):
            BiosignalStream(None, StreamConfig(graph="asr", window=512))


def test_later_slices_raise_not_implemented(apps):
    _, app = apps
    sig = torch.as_tensor(_audio(2048, seed=2))
    with pytest.raises(NotImplementedError, match="autotune"):
        ops.graph_pipeline_stream("asr", app, sig, window=512, hop=160,
                                  autotune=True)
    with pytest.raises(NotImplementedError, match="column deal"):
        BiosignalStream(app, StreamConfig(window=512, hop=160, graph="asr",
                                          n_columns=2))
