"""The port's serving runtimes (`repro_torch.serve`) against the JAX
package's, on the CPU, at window 512.

`BiosignalStream.process` is held to the reference's for both framings,
`depth` 1 and 2 and tail batches, with the tolerances of
`tests/test_torch_pipeline.py` (class and time features exact, filtered
atol 1e-6, band powers rtol/atol 1e-5, margin rtol 1e-5 atol 1e-4 — the
reductions run in another order). `StreamTelemetry` is pure host
arithmetic and must agree exactly under one injected clock. Within the
port the resident loop equals the host-driven stream bitwise, and its
drained counters add up to the host path's per-batch retire accounting.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.biosignal import make_app as j_make_app
from repro.core.biosignal import synthetic_respiration as j_synth
from repro.serve import resident as jres
from repro.serve import stream as jstream
from repro_torch.core.biosignal import app_from_numpy
from repro_torch.serve.resident import (DEFAULT_RING_DEPTH, ResidentConfig,
                                        ResidentStream)
from repro_torch.serve.stream import (BiosignalStream, ColumnStats,
                                      StreamConfig, StreamTelemetry,
                                      frame_count, frame_signal)

WINDOW, HOP, BW = 512, 128, 4


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


@pytest.fixture(scope="module")
def apps():
    japp = j_make_app()
    app = app_from_numpy(japp.fir_taps, np.asarray(japp.svm_w),
                         np.asarray(japp.svm_b), japp.fft_size, device="cpu")
    return japp, app


def _signal(n_frames, seed=0, extra=37):
    return np.asarray(j_synth(1, (n_frames - 1) * HOP + WINDOW + extra,
                              seed=seed)[0][0])


def assert_matches_reference(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "class":
            np.testing.assert_array_equal(g, w)
        elif k == "filtered":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        elif k == "features":
            np.testing.assert_array_equal(g[:, :6], w[:, :6])
            np.testing.assert_allclose(g[:, 6:], w[:, 6:], rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def assert_identical(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_stream_config_defaults_match_reference():
    mine = {f.name: f.default for f in dataclasses.fields(StreamConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jstream.StreamConfig)}
    assert mine == ref
    assert frame_count(5000, 2048, 512) == jstream.frame_count(5000, 2048, 512)


@pytest.mark.parametrize("framing", ["kernel", "host"])
@pytest.mark.parametrize("depth", [1, 2])
def test_process_matches_reference(apps, framing, depth):
    """11 frames in batches of 4: two full batches and a tail of 3."""
    japp, app = apps
    sig = _signal(11, seed=3)
    kw = dict(window=WINDOW, hop=HOP, batch_windows=BW, framing=framing,
              depth=depth)
    want = jstream.BiosignalStream(japp, jstream.StreamConfig(**kw)) \
        .process(sig)
    got = BiosignalStream(app, StreamConfig(**kw)).process(
        torch.as_tensor(sig))
    assert got["class"].shape == (11,)
    assert_matches_reference(got, want)


def test_process_output_selection_and_zero_frames(apps):
    japp, app = apps
    cfg = dict(window=WINDOW, hop=HOP, batch_windows=BW,
               outputs=("features", "class"))
    sig = _signal(6, seed=4)
    want = jstream.BiosignalStream(japp, jstream.StreamConfig(**cfg)) \
        .process(sig)
    got = BiosignalStream(app, StreamConfig(**cfg)).process(
        torch.as_tensor(sig))
    assert_matches_reference(got, want)
    short = sig[: WINDOW - 1]
    e_want = jstream.BiosignalStream(japp, jstream.StreamConfig(**cfg)) \
        .process(short)
    for rt in (BiosignalStream(app, StreamConfig(**cfg)),
               ResidentStream(app, StreamConfig(**cfg))):
        e_got = rt.process(torch.as_tensor(short))
        assert sorted(e_got) == sorted(e_want)
        for k, w in e_want.items():
            assert e_got[k].shape == w.shape
            assert e_got[k].numpy().dtype == w.dtype


@pytest.mark.parametrize("runtime", ["host", "resident"])
def test_float64_signal_runs_as_float32(apps, runtime):
    """A float64 numpy signal is cast to float32 at the entry, as the
    reference's ``jnp.asarray`` casts it: float32 outputs equal to the
    float32 call bitwise, the reference within tolerance, and float32 for
    a zero-frame call too."""
    japp, app = apps
    sig = _signal(9, seed=21).astype(np.float64)
    kw = dict(window=WINDOW, hop=HOP, batch_windows=BW)
    want = jstream.BiosignalStream(japp, jstream.StreamConfig(**kw)) \
        .process(sig)

    def run(x):
        if runtime == "host":
            return BiosignalStream(app, StreamConfig(**kw)).process(x)
        return ResidentStream(app, StreamConfig(**kw)).process(x)

    got = run(sig)
    assert got["filtered"].dtype == got["features"].dtype == torch.float32
    assert_identical(got, run(sig.astype(np.float32)))
    assert_matches_reference(got, want)
    empty = run(sig[: WINDOW - 1])
    e_want = jstream.BiosignalStream(japp, jstream.StreamConfig(**kw)) \
        .process(sig[: WINDOW - 1])
    assert sorted(empty) == sorted(e_want)
    for k, w in e_want.items():
        assert empty[k].shape == w.shape
        assert empty[k].numpy().dtype == w.dtype, k
    assert empty["filtered"].dtype == torch.float32


def test_stream_equals_one_framed_call_bitwise(apps):
    _, app = apps
    sig = torch.as_tensor(_signal(13, seed=6))
    from repro_torch.kernels.pipeline.ops import app_pipeline

    want = app_pipeline(app, frame_signal(sig, WINDOW, HOP))
    for framing in ("kernel", "host"):
        for bw in (1, 4, 13, 20):
            got = BiosignalStream(app, StreamConfig(
                window=WINDOW, hop=HOP, batch_windows=bw,
                framing=framing)).process(sig)
            assert_identical(got, want)


def test_telemetry_matches_reference_under_one_clock():
    """The same retire sequence through both telemetries, each with its
    own copy of one virtual clock: identical rates, loads and stats."""
    mine, ref = StreamTelemetry(clock=VirtualClock()), \
        jstream.StreamTelemetry(clock=VirtualClock())
    seen = []
    mine.add_retire_listener(lambda s, n: seen.append((s, n)))
    for tel in (mine, ref):
        tel.attach("a", 0)
        tel.attach("b", 1)
    assert not mine.warm and not ref.warm
    for sid, n in [("a", 4), ("b", 8), ("a", 4), ("a", 3), ("b", 8),
                   ("c", 2), ("b", 1)]:
        mine.record_retire(sid, n)
        ref.record_retire(sid, n)
    mine.attach("a", 1)
    ref.attach("a", 1)
    assert mine.warm and ref.warm
    for sid in ("a", "b", "c"):
        assert mine.stream_rate(sid) == ref.stream_rate(sid)
    for c in (0, 1):
        assert mine.column_rate(c) == ref.column_rate(c)
        assert mine.column_load(c) == ref.column_load(c)
    assert [dataclasses.astuple(s) for s in mine.column_stats()] == \
        [dataclasses.astuple(s) for s in ref.column_stats()]
    assert isinstance(mine.column_stats(2)[1], ColumnStats)
    assert seen[-1] == ("b", 1) and len(seen) == 7
    mine.detach("c")
    assert mine.stream_rate("c") == 0.0


def test_stream_telemetry_counts_every_retire(apps):
    japp, app = apps
    sig = _signal(11, seed=8)
    cfg = dict(window=WINDOW, hop=HOP, batch_windows=BW,
               outputs=("class",))
    mine = StreamTelemetry(clock=VirtualClock())
    ref = jstream.StreamTelemetry(clock=VirtualClock())
    BiosignalStream(app, StreamConfig(**cfg), telemetry=mine,
                    stream_id="s", column=2).process(torch.as_tensor(sig))
    jstream.BiosignalStream(japp, jstream.StreamConfig(**cfg), telemetry=ref,
                            stream_id="s", column=2).process(sig)
    assert [dataclasses.astuple(s) for s in mine.column_stats()] == \
        [dataclasses.astuple(s) for s in ref.column_stats()]
    assert mine.column_stats()[0].windows == 11


@pytest.mark.parametrize("n_frames,ring_depth,drain", [
    (11, 1, 1),       # one batch per sweep, tail batch
    (11, 3, 2),       # tail sweep mostly pad
    (16, 2, 1),       # dividing
    (5, None, 3),     # default ring depth, fewer sweeps than one drain
])
def test_resident_equals_host_driven_bitwise(apps, n_frames, ring_depth,
                                             drain):
    _, app = apps
    sig = torch.as_tensor(_signal(n_frames, seed=n_frames))
    cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=BW)
    tel_host, tel_res = StreamTelemetry(), StreamTelemetry()
    host = BiosignalStream(app, cfg, telemetry=tel_host, stream_id="h")
    want = host.process(sig)
    rs = ResidentStream(app, cfg, ResidentConfig(ring_depth=ring_depth,
                                                 drain_interval=drain),
                        telemetry=tel_res, stream_id="r")
    assert_identical(rs.process(sig), want)
    depth = ring_depth or DEFAULT_RING_DEPTH
    sweeps = -(-n_frames // (depth * BW))
    assert len(rs.last_drains) == -(-sweeps // drain)
    assert rs.last_drains[-1] == n_frames
    assert tel_res.column_stats()[0].windows == \
        tel_host.column_stats()[0].windows == n_frames
    assert_identical(host.process_resident(
        sig, ResidentConfig(ring_depth=ring_depth, drain_interval=drain)),
        want)


def test_resident_drains_match_reference(apps):
    japp, app = apps
    sig = _signal(11, seed=12)
    kw = dict(window=WINDOW, hop=HOP, batch_windows=BW)
    ref = jres.ResidentStream(japp, jstream.StreamConfig(**kw),
                              jres.ResidentConfig(ring_depth=2,
                                                  drain_interval=1))
    want = ref.process(sig)
    rs = ResidentStream(app, StreamConfig(**kw),
                        ResidentConfig(ring_depth=2, drain_interval=1))
    assert_matches_reference(rs.process(torch.as_tensor(sig)), want)
    assert rs.last_drains == ref.last_drains


def test_later_slices_raise_not_implemented(apps):
    _, app = apps
    with pytest.raises(NotImplementedError, match="fault"):
        BiosignalStream(app, StreamConfig(), injector=object())
    with pytest.raises(NotImplementedError, match="fault"):
        ResidentStream(app, StreamConfig(), retry=object())
    with pytest.raises(NotImplementedError, match="autotune"):
        BiosignalStream(app, StreamConfig(autotune=True))
    with pytest.raises(NotImplementedError, match="column deal"):
        BiosignalStream(app, StreamConfig(n_columns=2))
    with pytest.raises(NotImplementedError, match="autotune"):
        ResidentStream(app, StreamConfig(), ResidentConfig(autotune=True))
    with pytest.raises(ValueError, match="raw-chunk"):
        ResidentStream(app, StreamConfig(framing="host"))
    with pytest.raises(ValueError, match="hop"):
        BiosignalStream(app, StreamConfig(window=WINDOW, hop=WINDOW + 1))


def test_repin_moves_later_dispatches(apps):
    _, app = apps
    tel = StreamTelemetry()
    s = BiosignalStream(app, StreamConfig(window=WINDOW, hop=HOP,
                                          batch_windows=BW),
                        telemetry=tel, stream_id="x")
    s.repin("cpu", column=3)
    assert s.device == torch.device("cpu") and tel.column_of("x") == 3
    out = s.process(torch.as_tensor(_signal(3)))
    assert out["class"].shape == (3,)
    assert tel.column_stats()[-1].column == 3
