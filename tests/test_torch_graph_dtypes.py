"""bfloat16, float16, int16, int32 and float64 signals through the port's
graph entries against the JAX package's, on the CPU.

The JAX side runs as its own tests run it here: the `ops.py` graph entries
put the fused `pallas_call` in interpret mode. The port's entries get CPU
tensors and run the plain PyTorch version, which the CUDA kernels are
held to on the card (`tests/test_torch_kernel.py`, `chip_smoke.py`'s
phase D). A 16-bit signal is drawn in float32 with numpy from a seed and
rounded once by torch; JAX gets the same bits.

What is compared, and why:
* class, features[:, :6]: exact — both packages widen the 16-bit signal
  to float32 where they stage it, so the float32 arithmetic after the
  load is the float32 path's;
* filtered: in the signal's own dtype, bitwise wherever the two packages'
  float32 filters agree bitwise; XLA may contract an FMA in the FIR (the
  float32 parity tests' atol 1e-6), and where it does the 16-bit value
  may round one ulp of its dtype apart, never more;
* band powers, margin, logmel: the tolerances of
  `tests/test_torch_pipeline.py` and `tests/test_torch_asr.py`.
A float64 signal: the reference's ``jnp.asarray`` narrows it to float32
with x64 off, so every direct `graph_pipeline*` entry computes on it and
returns ``filtered`` in float32; the port's entries do the same. An int64
signal narrows to int32 the same way (its low 32 bits), and ``filtered``
comes back int32 under the integer rules below.
Within the port, a 16-bit call equals the float32 call on the widened
signal bitwise, ``filtered`` rounded to the dtype.

An integer signal (16-bit PCM, a sensor's counts) is widened to float32
where it is staged, as a 16-bit float one is. Its ``filtered`` is stored
in the signal's dtype as the reference's ``astype`` stores it: truncated
toward zero and saturated at the dtype's range. The signals here sit
near full scale with sharp edges, so the FIR's overshoot passes the range
(a wrapping cast would give the wrong sign there); ``filtered`` is exact
wherever the two packages' float32 filters agree bitwise, and elsewhere
apart by at most 1 more than those filters are (XLA's FMA contraction:
below 1 at int16's scale, a few float32 steps at int32's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.biosignal import make_app as j_make_app
from repro.core.biosignal import synthetic_respiration as j_synth
from repro.kernels.pipeline import ops as jops
from repro.kernels.pipeline.asr import make_asr_frontend as j_asr_frontend
from repro_torch.core.biosignal import app_from_numpy
from repro_torch.kernels.pipeline import ops
from repro_torch.kernels.pipeline.asr import (ASR_LOGMEL_TOL,
                                              make_asr_frontend)
from repro_torch.kernels.pipeline.graph import cast_output, staged_signal
from repro_torch.serve.resident import ResidentConfig, ResidentStream
from repro_torch.serve.stream import BiosignalStream, StreamConfig

WINDOW = 512
GRAPHS = {"biosignal": 128, "asr": 160}       # graph -> hop
N_FRAMES = 6
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
INT_DTYPES = {"int16": (torch.int16, jnp.int16),
              "int32": (torch.int32, jnp.int32)}


@pytest.fixture(scope="module")
def apps():
    japp = j_make_app()
    app = app_from_numpy(japp.fir_taps, np.asarray(japp.svm_w),
                         np.asarray(japp.svm_b), japp.fft_size, device="cpu")
    return {"biosignal": (japp, app),
            "asr": (j_asr_frontend(), make_asr_frontend(device="cpu"))}


def _signal(name: str, hop: int) -> np.ndarray:
    n = (N_FRAMES - 1) * hop + WINDOW
    if name == "biosignal":
        return np.asarray(j_synth(1, n, seed=4)[0][0])
    return np.random.default_rng(4).standard_normal(n).astype(np.float32)


def _inputs(name: str, hop: int, entry: str, x: np.ndarray):
    """One entry's input over the frames of the 1-D ``x``: the signal, its
    host-cut frames, or a 2-slot ring of its first and last 3 frames."""
    if entry == "stream":
        return x
    if entry == "frames":
        return np.stack([x[f * hop: f * hop + WINDOW]
                         for f in range(N_FRAMES)])
    span = 2 * hop + WINDOW
    return np.stack([x[:span], x[3 * hop: 3 * hop + span]])


def _call(pkg, name, app, x, hop, entry):
    if entry == "stream":
        return pkg.graph_pipeline_stream(name, app, x, window=WINDOW, hop=hop)
    if entry == "frames":
        return pkg.graph_pipeline(name, app, x)
    return pkg.graph_pipeline_ring(name, app, x, window=WINDOW, hop=hop)


def _flat(out: dict) -> dict:
    """Numpy per-frame rows, 16-bit floats widened: a ring's (D, n, ...)
    outputs as (D * n, ...)."""
    rows = {}
    for k, v in out.items():
        a = v.float().numpy() if isinstance(v, torch.Tensor) and \
            v.is_floating_point() else np.asarray(v)
        if a.dtype.kind == "V" or str(a.dtype) in ("bfloat16", "float16"):
            a = a.astype(np.float32)
        rows[k] = a.reshape((N_FRAMES,) + a.shape[a.ndim - (k != "class"):])
    return rows


def _ulp_apart(got: np.ndarray, want: np.ndarray, dtype) -> np.ndarray:
    """Elementwise distance in units of ``dtype``'s last place (same
    sign)."""
    g = torch.as_tensor(got).to(dtype).view(torch.int16).int()
    w = torch.as_tensor(want).to(dtype).view(torch.int16).int()
    return (g - w).abs().numpy()


def assert_matches(got: dict, want: dict, dtype=None, f32_agree=None):
    """The port's output ``got`` against the reference's ``want`` (both
    `_flat`), with the module docstring's rules; ``dtype`` is the 16-bit
    signal's (None: float32, ``filtered`` within atol 1e-6) and
    ``f32_agree`` marks the filtered samples where the two packages'
    float32 filters agree bitwise."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k == "class":
            np.testing.assert_array_equal(g, w)
        elif k == "filtered" and dtype is None:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        elif k == "filtered":
            far = _ulp_apart(g, w, dtype)
            assert far.max() <= 1, far.max()
            if f32_agree is not None:
                assert not (far[f32_agree] != 0).any()
        elif k == "features":
            np.testing.assert_array_equal(g[..., :6], w[..., :6])
            np.testing.assert_allclose(g[..., 6:], w[..., 6:], rtol=1e-5,
                                       atol=1e-5)
        elif k == "margin":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
        else:
            scale = max(1.0, float(np.abs(w).max()))
            assert float(np.abs(g - w).max()) <= ASR_LOGMEL_TOL * scale


@pytest.fixture(scope="module")
def widened(apps):
    """Per (graph, dtype): the 16-bit signal, and where the two packages'
    float32 filters of its widened values agree bitwise."""
    out = {}
    for name, hop in GRAPHS.items():
        japp, app = apps[name]
        x = _signal(name, hop)
        for dname, (tdt, _) in DTYPES.items():
            x16 = torch.as_tensor(x).to(tdt)
            wide = x16.float().numpy()
            jf = np.asarray(jops.graph_pipeline_stream(
                name, japp, wide, window=WINDOW, hop=hop,
                outputs=("filtered",))["filtered"])
            tf = ops.graph_pipeline_stream(
                name, app, torch.as_tensor(wide), window=WINDOW, hop=hop,
                outputs=("filtered",))["filtered"].numpy()
            np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-6)
            out[name, dname] = (x16, tf == jf)
    return out


@pytest.mark.parametrize("entry", ["stream", "frames", "ring"])
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_16bit_entry_matches_reference(apps, widened, name, dname, entry):
    japp, app = apps[name]
    hop = GRAPHS[name]
    tdt, jdt = DTYPES[dname]
    x16, agree = widened[name, dname]
    tin = torch.as_tensor(_inputs(name, hop, entry, x16.float().numpy())) \
        .to(tdt)
    jin = jnp.asarray(tin.float().numpy()).astype(jdt)
    want = _call(jops, name, japp, jin, hop, entry)
    got = _call(ops, name, app, tin, hop, entry)
    assert got["filtered"].dtype == tdt
    assert np.asarray(want["filtered"]).dtype == np.dtype(jdt)
    for k in got:
        if k != "filtered":
            assert str(got[k].dtype).replace("torch.", "") == \
                str(np.asarray(want[k]).dtype)
    # the ring's slots hold frames 0-2 and 3-5: its rows are the stream's
    assert_matches(_flat(got), _flat(want), tdt, agree)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_16bit_equals_float32_on_the_widened_signal(apps, widened, name,
                                                    dname):
    """The port computes in float32 after the load: a 16-bit call is the
    float32 call on the widened signal, `filtered` rounded to the
    dtype."""
    _, app = apps[name]
    hop = GRAPHS[name]
    tdt, _ = DTYPES[dname]
    x16, _ = widened[name, dname]
    got = ops.graph_pipeline_stream(name, app, x16, window=WINDOW, hop=hop)
    want = ops.graph_pipeline_stream(name, app, x16.float(), window=WINDOW,
                                     hop=hop)
    assert got["filtered"].dtype == tdt
    for k, v in want.items():
        assert torch.equal(got[k], v.to(tdt) if k == "filtered" else v), k


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_16bit_stream_runtimes_equal_one_call(apps, name, resident):
    """The host-driven stream (kernel- and host-framed) and the resident
    ring keep the 16-bit signal and give the one call's bits."""
    _, app = apps[name]
    hop = GRAPHS[name]
    x = torch.as_tensor(np.concatenate([_signal(name, hop)] * 3)) \
        .to(torch.bfloat16)
    want = ops.graph_pipeline_stream(name, app, x, window=WINDOW, hop=hop)
    cfg = StreamConfig(window=WINDOW, hop=hop, batch_windows=4, graph=name)
    runs = [ResidentStream(app, cfg, ResidentConfig(ring_depth=2))] \
        if resident else \
        [BiosignalStream(app, cfg), BiosignalStream(
            app, StreamConfig(window=WINDOW, hop=hop, batch_windows=4,
                              graph=name, framing="host"))]
    for run in runs:
        got = run.process(x)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_16bit_column_deal_equals_one_call(apps):
    _, app = apps["biosignal"]
    x = torch.as_tensor(np.concatenate([_signal("biosignal", 128)] * 4)) \
        .to(torch.float16)
    want = ops.app_pipeline_stream(app, x, window=WINDOW, hop=128)
    for weights in (None, (1, 1, 2, 4)):
        got = ops.app_pipeline_stream(app, x, window=WINDOW, hop=128,
                                      n_columns=4, column_weights=weights)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("entry", ["stream", "frames", "ring"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_float64_entry_narrows_as_the_reference(apps, name, entry):
    japp, app = apps[name]
    hop = GRAPHS[name]
    x = _inputs(name, hop, entry,
                _signal(name, hop).astype(np.float64) * (1 + 1e-9))
    want = _call(jops, name, japp, x, hop, entry)
    got = _call(ops, name, app, torch.as_tensor(x), hop, entry)
    assert got["filtered"].dtype == torch.float32
    assert np.asarray(want["filtered"]).dtype == np.float32
    narrowed = _call(ops, name, app, torch.as_tensor(x).float(), hop, entry)
    for k in got:
        assert torch.equal(got[k], narrowed[k]), k
    assert_matches(_flat(got), _flat(want))


def test_staged_signal_narrows_float64_only():
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int16):
        x = torch.zeros(4, dtype=dt)
        assert staged_signal(x) is x
    assert staged_signal(torch.zeros(4, dtype=torch.float64)).dtype == \
        torch.float32


# ------------------------------------------------------- integer signals

def _full_scale(name: str, hop: int, dtype) -> torch.Tensor:
    """``_signal`` plus a square wave of period 74 samples, scaled to
    twice ``dtype``'s range and clipped at its ends: the FIR overshoots
    past the range at the square's edges, in both graphs."""
    info = torch.iinfo(dtype)
    x = _signal(name, hop).astype(np.float64)
    x = 0.5 * x / np.abs(x).max()
    square = np.where((np.arange(x.shape[0]) // 37) % 2 == 0, 0.5, -0.5)
    x = np.clip(np.round((x + square) * 2.0 * info.max), info.min,
                info.max)
    return torch.as_tensor(x.astype(str(dtype).replace("torch.", "")))


@pytest.fixture(scope="module")
def integers(apps):
    """Per (graph, dtype): the full-scale signal, and the difference of
    the two packages' float32 filters of its widened values."""
    out = {}
    for name, hop in GRAPHS.items():
        japp, app = apps[name]
        for dname, (tdt, _) in INT_DTYPES.items():
            xi = _full_scale(name, hop, tdt)
            wide = xi.float().numpy()
            jf = np.asarray(jops.graph_pipeline_stream(
                name, japp, wide, window=WINDOW, hop=hop,
                outputs=("filtered",))["filtered"])
            tf = ops.graph_pipeline_stream(
                name, app, torch.as_tensor(wide), window=WINDOW, hop=hop,
                outputs=("filtered",))["filtered"].numpy()
            # float32 filters of full-scale values: XLA's FMA contraction
            # moves them by float32 rounding at the signal's scale
            np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-6 * float(
                np.abs(jf).max()))
            info = torch.iinfo(tdt)
            # the overshoot passes both ends of the dtype's range
            assert tf.max() > info.max and tf.min() < info.min, name
            out[name, dname] = (xi, np.abs(tf.astype(np.float64) - jf))
    return out


@pytest.mark.parametrize("entry", ["stream", "frames", "ring"])
@pytest.mark.parametrize("dname", list(INT_DTYPES))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_integer_entry_matches_reference(apps, integers, name, dname,
                                         entry):
    japp, app = apps[name]
    hop = GRAPHS[name]
    tdt, jdt = INT_DTYPES[dname]
    xi, gap = integers[name, dname]
    tin = torch.as_tensor(_inputs(name, hop, entry, xi.numpy()))
    assert tin.dtype == tdt
    want = _call(jops, name, japp, jnp.asarray(tin.numpy()), hop, entry)
    got = _call(ops, name, app, tin, hop, entry)
    assert got["filtered"].dtype == tdt
    assert np.asarray(want["filtered"]).dtype == np.dtype(jdt)
    g, w = _flat(got), _flat(want)
    gf, wf = g.pop("filtered"), w.pop("filtered")
    # saturated where the float32 filter passes the range
    assert (wf == torch.iinfo(tdt).max).any() and \
        (wf == torch.iinfo(tdt).min).any()
    diff = np.abs(gf.astype(np.int64) - wf.astype(np.int64))
    # truncation and the clamp move two floats' difference by less than 1
    assert (diff <= np.floor(gap) + 1).all(), diff.max()
    assert not diff[gap == 0].any()
    assert_matches(g, w)


@pytest.mark.parametrize("dname", list(INT_DTYPES))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_integer_equals_float32_on_the_widened_signal(apps, integers, name,
                                                      dname):
    """An integer call is the float32 call on the widened signal,
    ``filtered`` cast as the reference's astype casts."""
    _, app = apps[name]
    hop = GRAPHS[name]
    tdt, _ = INT_DTYPES[dname]
    xi, _ = integers[name, dname]
    got = ops.graph_pipeline_stream(name, app, xi, window=WINDOW, hop=hop)
    want = ops.graph_pipeline_stream(name, app, xi.float(), window=WINDOW,
                                     hop=hop)
    assert got["filtered"].dtype == tdt
    for k, v in want.items():
        assert torch.equal(got[k], cast_output(v, tdt) if k == "filtered"
                           else v), k
    wrapped = want["filtered"].to(tdt)
    assert not torch.equal(got["filtered"], wrapped)


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int16,
                                   torch.int32, torch.bfloat16,
                                   torch.float16])
def test_cast_output_is_the_reference_astype(dtype):
    x = np.array([40000.7, -40000.7, 1.9, -1.9, np.nan, np.inf, -np.inf,
                  32767.9, -32768.9, 127.5, -128.5, 255.9, 3e9, -3e9,
                  2147483520.0, 0.49, -0.49], np.float32)
    jdt = jnp.dtype(str(dtype).replace("torch.", ""))
    want = np.asarray(jnp.asarray(x).astype(jdt))
    got = cast_output(torch.as_tensor(x), dtype)
    assert got.dtype == dtype
    if dtype.is_floating_point:
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.astype(np.float32))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_integer_stream_runtimes_equal_one_call(apps):
    """The stream runtimes, resident ring and column deal included, keep
    the int16 signal and give the one call's bits."""
    _, app = apps["biosignal"]
    x = _full_scale("biosignal", 128, torch.int16).repeat(3)
    want = ops.app_pipeline_stream(app, x, window=WINDOW, hop=128)
    cfg = StreamConfig(window=WINDOW, hop=128, batch_windows=4)
    runs = [BiosignalStream(app, cfg),
            BiosignalStream(app, StreamConfig(window=WINDOW, hop=128,
                                              batch_windows=4,
                                              framing="host")),
            BiosignalStream(app, StreamConfig(window=WINDOW, hop=128,
                                              batch_windows=2, n_columns=3,
                                              column_weights=(1, 0, 2))),
            ResidentStream(app, cfg, ResidentConfig(ring_depth=2))]
    for run in runs:
        got = run.process(x)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


# --------------------------------------------------------- int64 signals

def _int64_signal(name: str, hop: int) -> np.ndarray:
    """A seeded int64 signal of scale 3e9, past int32's range: the
    reference's ``jnp.asarray`` keeps its low 32 bits (x64 off), so the
    graphs see an int32 signal over the whole of that range."""
    n = (N_FRAMES - 1) * hop + WINDOW
    seed = 5 if name == "biosignal" else 6
    return np.round(np.random.default_rng(seed).standard_normal(n) * 3e9) \
        .astype(np.int64)


@pytest.fixture(scope="module")
def int64s(apps):
    """Per graph: the int64 signal, and the difference of the two
    packages' float32 filters of its narrowed, widened values."""
    out = {}
    for name, hop in GRAPHS.items():
        japp, app = apps[name]
        x = _int64_signal(name, hop)
        wide = x.astype(np.int32).astype(np.float32)
        jf = np.asarray(jops.graph_pipeline_stream(
            name, japp, wide, window=WINDOW, hop=hop,
            outputs=("filtered",))["filtered"])
        tf = ops.graph_pipeline_stream(
            name, app, torch.as_tensor(wide), window=WINDOW, hop=hop,
            outputs=("filtered",))["filtered"].numpy()
        np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-6 * float(
            np.abs(jf).max()))
        out[name] = (x, np.abs(tf.astype(np.float64) - jf))
    return out


@pytest.mark.parametrize("entry", ["stream", "frames", "ring"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_int64_entry_narrows_as_the_reference(apps, int64s, name, entry):
    """int64 in, int32 ``filtered`` out, as the reference stages it: the
    port's call is its int32 call on the narrowed signal bitwise, and
    against the reference ``filtered`` follows the integer rule (exact
    wherever the float32 filters agree), class exactly, features,
    margin and logmel within the float32 tolerances."""
    japp, app = apps[name]
    hop = GRAPHS[name]
    x, gap = int64s[name]
    tin = torch.as_tensor(_inputs(name, hop, entry, x))
    assert tin.dtype == torch.int64
    want = _call(jops, name, japp, tin.numpy(), hop, entry)
    got = _call(ops, name, app, tin, hop, entry)
    assert got["filtered"].dtype == torch.int32
    assert np.asarray(want["filtered"]).dtype == np.int32
    narrowed = _call(ops, name, app, tin.to(torch.int32), hop, entry)
    for k in got:
        assert torch.equal(got[k], narrowed[k]), k
    g, w = _flat(got), _flat(want)
    gf, wf = g.pop("filtered"), w.pop("filtered")
    diff = np.abs(gf.astype(np.int64) - wf.astype(np.int64))
    assert (diff <= np.floor(gap) + 1).all(), diff.max()
    assert not diff[gap == 0].any()
    assert (gap == 0).mean() > 0.25, name
    assert_matches(g, w)


def test_int64_stream_runtimes_narrow_as_one_call(apps):
    """The stream runtimes (kernel- and host-framed, the column deal,
    the resident ring) stage an int64 signal as int32 and give the one
    int32 call's bits."""
    _, app = apps["biosignal"]
    x = torch.as_tensor(np.concatenate([_int64_signal("biosignal", 128)]
                                       * 3))
    want = ops.app_pipeline_stream(app, x.to(torch.int32), window=WINDOW,
                                   hop=128)
    assert want["filtered"].dtype == torch.int32
    cfg = StreamConfig(window=WINDOW, hop=128, batch_windows=4)
    runs = [BiosignalStream(app, cfg),
            BiosignalStream(app, StreamConfig(window=WINDOW, hop=128,
                                              batch_windows=4,
                                              framing="host")),
            BiosignalStream(app, StreamConfig(window=WINDOW, hop=128,
                                              batch_windows=2, n_columns=3,
                                              column_weights=(1, 0, 2))),
            ResidentStream(app, cfg, ResidentConfig(ring_depth=2))]
    for run in runs:
        got = run.process(x)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    got = ops.app_pipeline_stream(app, x, window=WINDOW, hop=128,
                                  n_columns=4, column_weights=(1, 1, 2, 4))
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_staged_signal_narrows_int64_to_its_low_32_bits():
    x = np.array([3_000_000_000, -3_000_000_000, 2**31, -2**31 - 1, 7],
                 np.int64)
    got = staged_signal(torch.as_tensor(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(x)))
