"""The port's column deal (`repro_torch.kernels.pipeline.shard`, the
``n_columns``/``column_weights`` paths of the pipeline entries and of
`BiosignalStream`) against the JAX package's, on the CPU.

* The deal arithmetic — `column_frames`, `column_shares`,
  `requeue_ranges`, `column_chunks` and `Deal` — is host integer
  arithmetic and must give exactly the reference's integers (and
  samples) on `tests/test_load_aware.py`'s weight grid, zero weights
  included, and on `tests/test_chaos.py`'s requeue cases. Where the
  reference asserts, the port raises `ValueError`.
* Within the port every deal — equal or weighted, raw-stream or
  pre-framed, through the entries or the stream runtime, tail batches
  included — is BITWISE the single-column run: each frame reads only its
  own window.
* Against the JAX `pipeline_stream_sharded` / `pipeline_sharded` (one
  device, so the reference takes its serial path; Pallas in interpret
  mode), ``class`` is exact and the floats hold the tolerances of
  `tests/test_torch_stream.py` (filtered atol 1e-6, time features exact,
  band powers rtol/atol 1e-5, margin rtol 1e-5 atol 1e-4).

* A column mesh (``mesh=``, a tuple of one device per column) runs
  column d on ``mesh[d]``; here ``(cpu,) * D``, one device, so the
  columns take the serial path and these cases hold the mesh's plumbing
  (its card runs are `chip_smoke.py`'s phase C). Mesh deals of the
  entries, raw and framed, equal and weighted, and of the stream runtime
  with tail batches at ``depth`` 2, are bitwise the single-column run,
  and a mesh of the wrong size raises `ValueError` (the reference
  asserts). `column_mesh` chooses as the reference's does: a mesh only
  for a CUDA stream of several columns on a host with that many cards.
* Against the reference's `shard_map` path (its ``mesh=`` over 4 forced
  host devices, in a subprocess: the device count is fixed before jax is
  imported; the mesh is built with Auto axes, as jax 0.9's defaults
  break its shard_map, ROADMAP C.2), the port's mesh path holds the
  tolerances above, ``class`` exact.

The autotune-key cases (`test_sharded_autotune_key_carries_device_count`,
`test_weighted_autotune_key_carries_share_signature`, and the key under a
mesh) run in both packages in `tests/test_torch_autotune.py`. Reference
cases not carried over: `test_shard_map_path_is_active_on_multidevice`
(it needs the outer process on several JAX devices; the subprocess case
here covers the mesh path) and the benchmark trajectory and
`diff_autotune` cases of `tests/test_load_aware.py`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.biosignal import make_app as j_make_app
from repro.core.biosignal import synthetic_respiration as j_synth
from repro.kernels.pipeline import shard as jshard
from repro.kernels.pipeline.ops import app_pipeline_stream as j_stream_entry
from repro.serve import stream as jstream
from repro_torch.core.biosignal import app_from_numpy
from repro_torch.kernels.pipeline import ops, shard
from repro_torch.serve import stream as tstream
from repro_torch.serve.stream import BiosignalStream, StreamConfig

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

# the weight grid of tests/test_load_aware.py, plus the equal deals
WEIGHTS = [
    (1, (1.0,)),
    (2, (3, 1)),
    (3, (0, 1, 0)),
    (4, (1, 1, 1, 1)),
    (4, (0.5, 2.0, 1.0, 0.25)),
    (4, (0, 1, 1, 2)),
    (8, (1, 3, 0, 1, 1, 0, 2, 1)),
]
DEALS = [(d, None) for d in (1, 2, 3, 4, 8)] + WEIGHTS
SHAPES = [(512, 128, 512 * 9),        # deep overlap
          (512, 512, 512 * 5 + 17),   # no overlap, non-dividing signal
          (1024, 320, 7001)]          # hop divides neither
# the reference runs on these deals (interpret mode, a few seconds each)
JAX_DEALS = [(1, None), (2, None), (3, None), (4, None), (8, None),
             (2, (3, 1)), (4, (0, 1, 1, 2)), (8, (1, 3, 0, 1, 1, 0, 2, 1))]
JAX_FRAMED = [(1, 2), (7, 4), (30, 4)]


@pytest.fixture(scope="module")
def apps():
    japp = j_make_app()
    app = app_from_numpy(japp.fir_taps, np.asarray(japp.svm_w),
                         np.asarray(japp.svm_b), japp.fft_size, device="cpu")
    return japp, app


def _raw(n_samples, seed):
    return np.asarray(j_synth(1, n_samples, seed=seed)[0][0])


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


# ------------------------------------------------------- deal arithmetic

@pytest.mark.parametrize("n_frames", [0, 1, 7, 16, 64, 101])
@pytest.mark.parametrize("n_columns,weights", DEALS)
def test_column_shares_equal_reference(n_frames, n_columns, weights):
    want = jshard.column_shares(n_frames, n_columns, weights)
    assert shard.column_shares(n_frames, n_columns, weights) == want
    assert shard.column_frames(n_frames, n_columns) == \
        jshard.column_frames(n_frames, n_columns)


@pytest.mark.parametrize("args", [(10, 2, (1,)), (10, 2, (-1, 2)),
                                  (10, 2, (0, 0)), (10, 2, (1, np.nan)),
                                  (10, 0, None)])
def test_column_shares_refuse_what_the_reference_refuses(args):
    with pytest.raises(AssertionError):
        jshard.column_shares(*args)
    with pytest.raises(ValueError):
        shard.column_shares(*args)


REQUEUE_CASES = [
    ([(3, 4), (10, 1), (20, 7)], 3, (1.0, 0.0, 2.0)),   # tests/test_chaos
    ([], 3, None),
    ([(5, 0)], 2, None),
    ([(7, 3)], 1, None),
    ([(0, 2), (2, 2), (4, 2), (6, 1)], 4, None),       # adjacent runs
    ([(0, 2), (2, 2), (4, 2), (6, 1)], 4, (0, 1, 0, 3)),
    ([(8, 5), (40, 13), (70, 2)], 8, (1, 3, 0, 1, 1, 0, 2, 1)),
    ([(1, 1)], 3, (0.5, 0.0, 0.25)),
]


@pytest.mark.parametrize("ranges,n_columns,weights", REQUEUE_CASES)
def test_requeue_ranges_equal_reference(ranges, n_columns, weights):
    got = shard.requeue_ranges(ranges, n_columns, weights)
    assert got == jshard.requeue_ranges(ranges, n_columns, weights)
    # coverage, order and no-overlap hold in the port's own terms too
    flat = [f for col in got for s, c in col for f in range(s, s + c)]
    assert flat == [f for s, c in ranges for f in range(s, s + c)]


@pytest.mark.parametrize("window,hop,n_samples", SHAPES)
@pytest.mark.parametrize("n_columns,weights", DEALS)
def test_column_chunks_equal_reference(window, hop, n_samples, n_columns,
                                       weights):
    sig = np.arange(n_samples, dtype=np.float32)
    want = jshard.column_chunks(sig, window, hop, n_columns, weights)
    got = shard.column_chunks(torch.as_tensor(sig), window, hop, n_columns,
                              weights)
    assert (got.n_frames, got.shares) == (want.n_frames, want.shares)
    np.testing.assert_array_equal(got.chunks.numpy(),
                                  np.asarray(want.chunks))
    chunks, n, shares = got                    # unpacks like the reference
    assert chunks is got.chunks and (n, shares) == tuple(want)[1:]
    empty = shard.column_chunks(torch.zeros(window - 1), window, hop,
                                n_columns, weights)
    assert tuple(empty) == (None, 0, (0,) * n_columns) == \
        tuple(jshard.column_chunks(np.zeros(window - 1, np.float32), window,
                                   hop, n_columns, weights))


# ------------------------------------------------ raw-stream deal, bitwise

@pytest.fixture(scope="module")
def single(apps):
    """The port's single-column outputs per SHAPES entry."""
    _, app = apps
    out = {}
    for window, hop, n_samples in SHAPES:
        raw = torch.as_tensor(_raw(n_samples, seed=n_samples))
        out[(window, hop, n_samples)] = (raw, ops.app_pipeline_stream(
            app, raw, window=window, hop=hop))
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_columns,weights", DEALS)
def test_sharded_stream_is_bitwise_one_column(apps, single, shape,
                                              n_columns, weights):
    _, app = apps
    raw, ref = single[shape]
    window, hop, _ = shape
    out = ops.app_pipeline_stream(app, raw, window=window, hop=hop,
                                  n_columns=n_columns,
                                  column_weights=weights)
    assert_identical(out, ref)
    legacy = shard.pipeline_stream_sharded(
        raw, app.fir_taps, app.svm_w, app.svm_b, window=window, hop=hop,
        n_columns=n_columns, weights=weights, outputs=("margin", "class"))
    assert_identical(legacy, {k: ref[k] for k in ("margin", "class")})


@pytest.fixture(scope="module")
def jax_sharded(apps):
    """The reference's serial sharded outputs at 512/128 over 33 frames,
    once per module."""
    japp, _ = apps
    window, hop, n_samples = SHAPES[0]
    raw = _raw(n_samples, seed=n_samples)
    return {(d, w): jshard.pipeline_stream_sharded(
        raw, japp.fir_taps, japp.svm_w, japp.svm_b, window=window, hop=hop,
        n_columns=d, weights=w) for d, w in JAX_DEALS}


@pytest.mark.parametrize("n_columns,weights", JAX_DEALS)
def test_sharded_stream_matches_reference(apps, single, jax_sharded,
                                          n_columns, weights):
    _, app = apps
    window, hop, _ = SHAPES[0]
    raw, _ = single[SHAPES[0]]
    out = shard.pipeline_stream_sharded(
        raw, app.fir_taps, app.svm_w, app.svm_b, window=window, hop=hop,
        n_columns=n_columns, weights=weights)
    assert_matches_reference(out, jax_sharded[(n_columns, weights)])


def test_a_column_launches_only_on_frames_it_owns(apps, monkeypatch):
    """One single-column call per column that owns a frame: a zero weight
    launches nothing, and so does an equal-deal column whose padded share
    lies wholly past the signal."""
    _, app = apps
    calls = []
    real = shard.graph_stream_call

    def counting(chunk, *a, **kw):
        calls.append(chunk.shape[0])
        return real(chunk, *a, **kw)

    monkeypatch.setattr(shard, "graph_stream_call", counting)
    raw = torch.as_tensor(_raw(512 + 9 * 128, seed=1))     # 10 frames
    ref = ops.app_pipeline_stream(app, raw, window=512, hop=128)
    calls.clear()
    assert_identical(ops.app_pipeline_stream(
        app, raw, window=512, hop=128, n_columns=3,
        column_weights=(0, 1, 0)), ref)
    assert calls == [raw.shape[0]]
    calls.clear()
    one = raw[:512]                                          # one frame
    assert_identical(ops.app_pipeline_stream(
        app, one, window=512, hop=128, n_columns=8),
        ops.app_pipeline_stream(app, one, window=512, hop=128))
    assert calls == [512]             # columns 1-7 own no frame
    calls.clear()
    ops.app_pipeline_stream(app, raw, window=512, hop=128, n_columns=4)
    # ceil(10/4) = 3 frames a column: 3, 3, 3 and the last frame alone
    assert calls == [512 + 2 * 128] * 3 + [512]


@pytest.mark.parametrize("n_columns", [1, 3, 8])
@pytest.mark.parametrize("n_samples", [0, 100, 511])
def test_sharded_zero_frame_paths(apps, n_samples, n_columns):
    """Signals shorter than one window: the reference's empty keys,
    shapes and dtypes at every column count."""
    japp, app = apps
    sel = ("features", "class")
    want = j_stream_entry(japp, np.zeros(n_samples, np.float32), window=512,
                          hop=256, n_columns=n_columns, outputs=sel)
    got = ops.app_pipeline_stream(app, torch.zeros(n_samples), window=512,
                                  hop=256, n_columns=n_columns, outputs=sel)
    assert_matches_reference(got, want)
    assert tuple(got["features"].shape) == (0, 12)
    assert got["class"].dtype == torch.int32
    frames = torch.zeros((0, 512))
    empty = ops.app_pipeline(app, frames, n_columns=n_columns, outputs=sel)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {"features": (0, 12), "class": (0,)}


# --------------------------------------------------- pre-framed row deal

@pytest.mark.parametrize("n_columns", [2, 3, 4, 8])
@pytest.mark.parametrize("rows", [1, 7, 8, 30])
def test_sharded_framed_is_bitwise_one_column(apps, rows, n_columns):
    _, app = apps
    frames = torch.as_tensor(np.asarray(j_synth(rows, 512, seed=rows)[0]))
    ref = ops.app_pipeline(app, frames)
    assert_identical(ops.app_pipeline(app, frames, n_columns=n_columns),
                     ref)


@pytest.mark.parametrize("rows,n_columns", JAX_FRAMED)
def test_sharded_framed_matches_reference(apps, rows, n_columns):
    japp, app = apps
    frames = np.asarray(j_synth(rows, 512, seed=rows)[0])
    want = jshard.pipeline_sharded(frames, japp.fir_taps, japp.svm_w,
                                   japp.svm_b, n_columns=n_columns)
    got = shard.pipeline_sharded(torch.as_tensor(frames), app.fir_taps,
                                 app.svm_w, app.svm_b, n_columns=n_columns)
    assert_matches_reference(got, want)


# --------------------------------------------------------- stream runtime

STREAM_RAW = 512 * 21 + 77      # 41 frames at 512/256: tail batches


@pytest.fixture(scope="module")
def stream_ref(apps):
    """The port's single-column stream and the reference's multi-column
    stream (3 columns of 2 frames, equal and weighted)."""
    japp, app = apps
    raw = _raw(STREAM_RAW, seed=13)
    one = BiosignalStream(app, StreamConfig(window=512, hop=256,
                                            batch_windows=4)).process(raw)
    want = {w: jstream.BiosignalStream(japp, jstream.StreamConfig(
        window=512, hop=256, batch_windows=2, n_columns=3,
        column_weights=w)).process(raw)
        for w in (None, (1.0, 2.5, 0.5))}
    return raw, one, want


@pytest.mark.parametrize("weights", [None, (1.0, 2.5, 0.5)])
def test_stream_runtime_columns_match_reference(apps, stream_ref, weights):
    _, app = apps
    raw, one, want = stream_ref
    cfg = StreamConfig(window=512, hop=256, batch_windows=2, n_columns=3,
                       column_weights=weights)
    stream = BiosignalStream(app, cfg)
    assert stream.dispatch_windows == 6
    out = stream.process(raw)
    assert_identical(out, one)
    assert_matches_reference(out, want[weights])


@pytest.mark.parametrize("n_columns,weights", DEALS)
@pytest.mark.parametrize("framing", ["kernel", "host"])
def test_stream_runtime_deals_are_bitwise_one_column(apps, stream_ref,
                                                     n_columns, weights,
                                                     framing):
    _, app = apps
    raw, one, _ = stream_ref
    if framing == "host":
        weights = None          # the weighted deal is a raw-chunk path
    cfg = StreamConfig(window=512, hop=256, batch_windows=3,
                       n_columns=n_columns, column_weights=weights,
                       framing=framing, depth=2)
    assert_identical(BiosignalStream(app, cfg).process(raw), one)


# ------------------------------------------------------------ column mesh

# A CPU mesh is one device, so its columns take the serial path: these
# cases hold the mesh's plumbing (entries, stream attribute, checks), not
# a second column runner; the card's runs are chip_smoke.py's phase C.
MESH_DEALS = [(2, None), (4, (0.5, 2.0, 1.0, 0.25)),
              (8, (1, 3, 0, 1, 1, 0, 2, 1))]


@pytest.mark.parametrize("shape", SHAPES[:1])
@pytest.mark.parametrize("n_columns,weights", MESH_DEALS)
def test_mesh_stream_is_bitwise_one_column(apps, single, shape, n_columns,
                                           weights):
    _, app = apps
    raw, ref = single[shape]
    window, hop, _ = shape
    mesh = (CPU,) * n_columns
    out = ops.app_pipeline_stream(app, raw, window=window, hop=hop,
                                  n_columns=n_columns, mesh=mesh,
                                  column_weights=weights)
    assert_identical(out, ref)
    legacy = shard.pipeline_stream_sharded(
        raw, app.fir_taps, app.svm_w, app.svm_b, window=window, hop=hop,
        n_columns=n_columns, mesh=mesh, weights=weights,
        outputs=("margin", "class"))
    assert_identical(legacy, {k: ref[k] for k in ("margin", "class")})


@pytest.mark.parametrize("rows,n_columns", [(7, 4), (30, 8)])
def test_mesh_framed_is_bitwise_one_column(apps, rows, n_columns):
    _, app = apps
    frames = torch.as_tensor(np.asarray(j_synth(rows, 512, seed=rows)[0]))
    ref = ops.app_pipeline(app, frames)
    mesh = (CPU,) * n_columns
    assert_identical(ops.app_pipeline(app, frames, n_columns=n_columns,
                                      mesh=mesh), ref)
    assert_identical(shard.pipeline_sharded(
        frames, app.fir_taps, app.svm_w, app.svm_b, n_columns=n_columns,
        mesh=mesh), ref)


@pytest.mark.parametrize("n_columns,weights,framing",
                         [(3, None, "host"), (4, (0, 1, 1, 2), "kernel")])
def test_mesh_stream_runtime_is_bitwise_one_column(apps, stream_ref,
                                                   n_columns, weights,
                                                   framing):
    """The stream's public ``mesh`` set after construction: every
    dispatch dealt over it, tail batches included, two in flight."""
    _, app = apps
    raw, one, _ = stream_ref
    cfg = StreamConfig(window=512, hop=256, batch_windows=3,
                       n_columns=n_columns, column_weights=weights,
                       framing=framing, depth=2)
    stream = BiosignalStream(app, cfg)
    assert stream.mesh is None              # a CPU stream: serial columns
    stream.mesh = (CPU,) * n_columns
    assert_identical(stream.process(raw), one)


def test_mesh_column_launches_only_on_frames_it_owns(apps, monkeypatch):
    """Under a mesh, as serially: one call per column that owns a frame,
    each on its own column's part."""
    _, app = apps
    calls = []
    real = shard.graph_stream_call

    def counting(chunk, *a, **kw):
        calls.append(chunk.shape[0])
        return real(chunk, *a, **kw)

    monkeypatch.setattr(shard, "graph_stream_call", counting)
    raw = torch.as_tensor(_raw(512 + 9 * 128, seed=1))     # 10 frames
    ref = ops.app_pipeline_stream(app, raw, window=512, hop=128)
    calls.clear()
    assert_identical(ops.app_pipeline_stream(
        app, raw, window=512, hop=128, n_columns=3, mesh=(CPU,) * 3,
        column_weights=(0, 1, 0)), ref)
    assert calls == [raw.shape[0]]
    calls.clear()
    ops.app_pipeline_stream(app, raw, window=512, hop=128, n_columns=4,
                            mesh=(CPU,) * 4)
    assert calls == [512 + 2 * 128] * 3 + [512]


def test_mismatched_mesh_raises(apps):
    _, app = apps
    raw = torch.as_tensor(_raw(4096, seed=2))
    frames = raw[:4 * 512].reshape(4, 512)
    for bad in ((CPU,) * 3, (CPU,) * 5, ()):
        with pytest.raises(ValueError, match="mesh"):
            ops.app_pipeline_stream(app, raw, window=512, hop=128,
                                    n_columns=4, mesh=bad)
        with pytest.raises(ValueError, match="mesh"):
            shard.pipeline_sharded(frames, app.fir_taps, app.svm_w,
                                   app.svm_b, n_columns=4, mesh=bad)
        stream = BiosignalStream(app, StreamConfig(
            window=512, hop=128, batch_windows=2, n_columns=4))
        stream.mesh = bad
        with pytest.raises(ValueError, match="mesh"):
            stream.process(raw)
    assert shard.data_mesh_size((CPU,) * 4) == 4


def test_mesh_operands_are_held_by_the_caller(apps):
    """`mesh_operands` makes one entry a device, copying nothing already
    there; the sharded entries read it, and a bare tuple serves only a
    mesh on its own device."""
    _, app = apps
    from repro_torch.kernels.pipeline.graph import get_graph_factory
    graph, operands = get_graph_factory("biosignal")(app)
    held = shard.mesh_operands(operands, (CPU,) * 3)
    assert list(held) == [CPU]
    assert all(a is b for a, b in zip(held[CPU], operands))
    raw = torch.as_tensor(_raw(512 + 9 * 128, seed=4))
    kw = dict(graph=graph, window=512, hop=128)
    ref = shard.graph_stream_sharded(raw, operands, n_columns=1, **kw)
    for ops in (held, operands):
        assert_identical(shard.graph_stream_sharded(
            raw, ops, n_columns=3, mesh=(CPU,) * 3, **kw), ref)


def test_cuda_mesh_raises_without_a_card(apps):
    """A CUDA column mesh for a CPU signal, or on a host without a card,
    raises: the columns never move to another kind of device."""
    _, app = apps
    raw = torch.as_tensor(_raw(4096, seed=2))
    with pytest.raises((ValueError, RuntimeError)):
        ops.app_pipeline_stream(app, raw, window=512, hop=128, n_columns=2,
                                mesh=(torch.device("cuda", 0),) * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tstream.column_mesh(2)


@pytest.mark.parametrize("cards", [0, 1, 3, 4, 8])
@pytest.mark.parametrize("n_columns", [1, 2, 4])
def test_column_mesh_chooses_as_the_reference(monkeypatch, cards,
                                              n_columns):
    """The reference builds a ``data`` mesh only for several columns on a
    process with that many devices; the port the same over the host's
    cards, and never for a CPU stream."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert tstream.column_mesh(n_columns, "cpu") is None
    if n_columns == 1:
        assert tstream.column_mesh(n_columns) is None
        return
    if cards == 0:
        with pytest.raises(RuntimeError, match="cuda"):
            tstream.column_mesh(n_columns)
        return
    mesh = tstream.column_mesh(n_columns)
    if cards < n_columns:
        assert mesh is None
    else:
        assert mesh == tuple(torch.device("cuda", i)
                             for i in range(n_columns))
        assert len(set(mesh)) == n_columns


def test_pinned_and_cpu_streams_have_no_mesh(apps):
    _, app = apps
    cpu4 = BiosignalStream(app, StreamConfig(window=512, hop=128,
                                             n_columns=4))
    pinned = BiosignalStream(app, StreamConfig(window=512, hop=128),
                             device="cpu")
    pinned.repin("cpu", column=1)
    assert cpu4.mesh is None and pinned.mesh is None


# the reference's shard_map path over forced host devices, and its inputs
_MESH_REF = """
import json, sys
import numpy as np
import jax
from jax.sharding import AxisType, Mesh
from repro.core.biosignal import make_app
from repro.kernels.pipeline.shard import (pipeline_sharded,
                                          pipeline_stream_sharded)
assert len(jax.devices()) == 4, jax.devices()
data = np.load(sys.argv[1])
app = make_app()
out = {}
def mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ("data",),
                axis_types=(AxisType.Auto,))
for d, w in ((2, None), (4, None), (4, (1, 2, 0, 3))):
    res = pipeline_stream_sharded(
        data["raw"], app.fir_taps, app.svm_w, app.svm_b, window=512, hop=128,
        n_columns=d, mesh=mesh(d), weights=w)
    for k, v in res.items():
        out[f"stream-{d}-{w}-{k}"] = np.asarray(v)
res = pipeline_sharded(data["frames"], app.fir_taps, app.svm_w, app.svm_b,
                       n_columns=4, mesh=mesh(4))
for k, v in res.items():
    out[f"framed-4-{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
print(json.dumps({"keys": len(out)}))
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The reference's `pipeline_stream_sharded(mesh=)` at (2, None),
    (4, None) and (4, (1, 2, 0, 3)) on a 512/128 signal of 45 frames, and
    its `pipeline_sharded(mesh=)` at 30 rows over 4, each a `shard_map`
    over forced host devices."""
    d = tmp_path_factory.mktemp("mesh_ref")
    raw = _raw(512 + 44 * 128 + 77, seed=42)
    frames = np.asarray(j_synth(30, 512, seed=30)[0])
    np.savez(d / "in.npz", raw=raw, frames=frames)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, "-c", _MESH_REF, str(d / "in.npz"),
                        str(d / "out.npz")], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["keys"] == 16
    out = dict(np.load(d / "out.npz"))
    return raw, frames, out


@pytest.mark.parametrize("n_columns,weights", [(2, None), (4, None),
                                               (4, (1, 2, 0, 3))])
def test_mesh_stream_matches_reference_shard_map(apps, jax_mesh, n_columns,
                                                 weights):
    _, app = apps
    raw, _, ref = jax_mesh
    got = shard.pipeline_stream_sharded(
        torch.as_tensor(raw), app.fir_taps, app.svm_w, app.svm_b,
        window=512, hop=128, n_columns=n_columns, mesh=(CPU,) * n_columns,
        weights=weights)
    want = {k: ref[f"stream-{n_columns}-{weights}-{k}"] for k in got}
    assert_matches_reference(got, want)


def test_mesh_framed_matches_reference_shard_map(apps, jax_mesh):
    _, app = apps
    _, frames, ref = jax_mesh
    got = shard.pipeline_sharded(torch.as_tensor(frames), app.fir_taps,
                                 app.svm_w, app.svm_b, n_columns=4,
                                 mesh=(CPU,) * 4)
    assert_matches_reference(got, {k: ref[f"framed-4-{k}"] for k in got})
