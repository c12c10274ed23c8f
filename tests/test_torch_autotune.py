"""The port's `core/autotune.py` against the JAX package's, on the CPU.

The reference's autotune cases (`tests/test_stream_kernel.py`,
`test_asr.py`, `test_resident.py`, `test_pipeline_kernel.py`; the
column-deal cases of `test_stream_sharded.py` and `test_load_aware.py`
are in `tests/test_torch_autotune_columns.py`) run here in both
packages on the same numpy inputs. The same call must leave the same
cache keys in both (the winners may differ: the two time different
things), a cache file written by either package must load in the other
with equal keys and winners, and a tuned call must equal the untuned one
bitwise in the port. Outputs are held to the reference with the
tolerances of `tests/test_torch_stream.py`.
"""
import contextlib
import time

import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core.biosignal import make_app as j_make_app
from repro.core.biosignal import synthetic_respiration as j_synth
from repro.kernels.fft.ops import fft as j_fft
from repro.kernels.pipeline import ops as jops
from repro.kernels.pipeline.asr import make_asr_frontend as j_asr_frontend
from repro.serve import resident as jres
from repro.serve import stream as jstream
from repro_torch.core import autotune as tat
from repro_torch.core.biosignal import app_from_numpy
from repro_torch.kernels.fft import ops as fft_ops
from repro_torch.kernels.fir import ops as fir_ops
from repro_torch.kernels.pipeline import ops
from repro_torch.kernels.pipeline.asr import make_asr_frontend
from repro_torch.serve.resident import ResidentConfig, ResidentStream
from repro_torch.serve.stream import BiosignalStream, StreamConfig


@pytest.fixture(scope="module")
def apps():
    japp = j_make_app()
    app = app_from_numpy(japp.fir_taps, np.asarray(japp.svm_w),
                         np.asarray(japp.svm_b), japp.fft_size, device="cpu")
    return japp, app


@pytest.fixture(autouse=True)
def _clean_caches():
    jat.clear_cache()
    tat.clear_cache()
    yield
    jat.clear_cache()
    tat.clear_cache()


def _raw(samples, seed):
    return np.asarray(j_synth(1, samples, seed=seed)[0][0])


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.4 * np.sin(2 * np.pi * 440.0 * t) + 0.1 * rng.normal(size=n)
    return x.astype(np.float32)


def _same_keys():
    """The two packages' caches hold the same keys; returns the port's."""
    j, t = jat.cache_snapshot(), tat.cache_snapshot()
    assert set(j) == set(t), (sorted(j, key=str), sorted(t, key=str))
    return t


def _crosses_over(tmp_path):
    """Either package's JSON loads in the other with equal keys and
    winners."""
    jcache, tcache = jat.cache_snapshot(), tat.cache_snapshot()
    jpath, tpath = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    assert jat.save_cache(jpath) == len(jcache)
    assert tat.save_cache(tpath) == len(tcache)
    jat.clear_cache()
    tat.clear_cache()
    assert tat.load_cache(jpath) == len(jcache)
    assert tat.cache_snapshot() == jcache
    assert jat.load_cache(tpath) == len(tcache)
    assert jat.cache_snapshot() == tcache
    assert tat.load_cache(str(tmp_path / "missing.json")) == 0


def _close(got: dict, want: dict):
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape, k
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                       err_msg=k)


def _identical(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_stream_autotune_key_and_persistence(apps, tmp_path):
    """`tests/test_stream_kernel.py:181`: the tuned raw-signal entry
    caches under the (window, hop, outputs) key, a second call hits the
    cache, and the winners survive a JSON round trip across packages."""
    japp, app = apps
    raw = _raw(512 * 9, seed=5)
    sel = ("features", "class")
    want = jops.app_pipeline_stream(japp, raw, window=512, hop=128,
                                    autotune=True, outputs=sel)
    got = ops.app_pipeline_stream(app, torch.as_tensor(raw), window=512,
                                  hop=128, autotune=True, outputs=sel)
    _close(got, want)
    _identical(got, ops.app_pipeline_stream(
        app, torch.as_tensor(raw), window=512, hop=128, outputs=sel))
    cache = _same_keys()
    (key, rb), = cache.items()
    assert key[0] == "biosignal_pipeline_stream"
    assert key[2:5] == (512, 128, sel)
    assert rb in tat.candidate_stream_block_frames(key[1], 512, 128)
    ops.app_pipeline_stream(app, torch.as_tensor(raw), window=512, hop=128,
                            autotune=True, outputs=sel)
    assert tat.cache_snapshot() == cache
    log = tat.search_log()[key]
    assert log["winner"] == rb and log["clock"] == "host"
    assert len(log["ms"]) == len(log["spread"]) == len(log["candidates"])
    _crosses_over(tmp_path)


def test_autotune_key_is_graph_scoped(tmp_path):
    """`tests/test_asr.py:236`: the ASR graph tunes under its own
    ``"asr_pipeline_stream"`` key, from the ASR kernel's pool."""
    raw = _audio(512 * 6, seed=21)
    jops.graph_pipeline_stream("asr", j_asr_frontend(), raw, window=512,
                               hop=160, autotune=True, outputs=("logmel",))
    app = make_asr_frontend(device="cpu")
    got = ops.graph_pipeline_stream("asr", app, torch.as_tensor(raw),
                                    window=512, hop=160, autotune=True,
                                    outputs=("logmel",))
    _identical(got, ops.graph_pipeline_stream(
        "asr", app, torch.as_tensor(raw), window=512, hop=160,
        outputs=("logmel",)))
    (key, rb), = _same_keys().items()
    assert key[0] == "asr_pipeline_stream"
    assert key[2:5] == (512, 160, ("logmel",))
    # the ASR kernel's default of 8 frames a block is among the candidates
    assert 8 in tat.search_log()[key]["candidates"]
    assert rb in tat.search_log()[key]["candidates"]
    _crosses_over(tmp_path)


def test_resident_autotune_matches_host(apps, tmp_path):
    """`tests/test_resident.py:236`: the measured ring depth is a pure
    speed knob — the outputs equal the untuned loop's and the host
    path's, the drained counts equal those of an untuned loop at the
    winning depth (the search itself drains nothing), and the winner is
    cached per shape."""
    japp, app = apps
    sig = np.asarray(j_synth(1, 256 * 15 + 512, seed=11)[0][0])
    jcfg = jstream.StreamConfig(window=512, hop=256, batch_windows=2)
    jres.ResidentStream(japp, jcfg,
                        jres.ResidentConfig(autotune=True)).process(sig)
    cfg = StreamConfig(window=512, hop=256, batch_windows=2)
    want = ResidentStream(app, cfg, ResidentConfig()).process(
        torch.as_tensor(sig))
    rs = ResidentStream(app, cfg, ResidentConfig(autotune=True))
    _identical(rs.process(torch.as_tensor(sig)), want)
    _identical(want, BiosignalStream(app, cfg).process(torch.as_tensor(sig)))
    cache = _same_keys()
    (key, depth), = cache.items()
    assert key[0] == "resident_ring"
    ref = ResidentStream(app, cfg, ResidentConfig(ring_depth=depth))
    ref.process(torch.as_tensor(sig))
    assert rs.last_drains == ref.last_drains
    rs.process(torch.as_tensor(sig))            # second call: cache hit
    assert tat.cache_snapshot() == cache
    _crosses_over(tmp_path)


def test_autotune_matches_static_and_caches(tmp_path):
    """`tests/test_pipeline_kernel.py:103`: the tuned FFT equals the
    untuned one and caches one winner among the kernel's candidates."""
    rng = np.random.default_rng(23)
    re = rng.normal(size=(8, 128)).astype(np.float32)
    im = rng.normal(size=(8, 128)).astype(np.float32)
    j_fft(re, im, autotune=True)
    tre, tim = torch.as_tensor(re), torch.as_tensor(im)
    a = fft_ops.fft(tre, tim)
    b = fft_ops.fft(tre, tim, autotune=True)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    cache = _same_keys()
    (key, rb), = cache.items()
    assert key == ("fft", 8, 128, "float32", False)
    assert rb in tat.candidate_block_rows(8, default=8, max_rows=512 // 8)
    fft_ops.fft(tre, tim, autotune=True)
    assert tat.cache_snapshot() == cache
    _crosses_over(tmp_path)


@pytest.mark.parametrize("framing", ["kernel", "host"])
@pytest.mark.parametrize("graph", ["biosignal", "asr"])
def test_stream_config_autotune_keys_match_reference(apps, graph, framing):
    """`StreamConfig(autotune=True)` keys each framing's dispatches as the
    reference's stream does — the biosignal host feed under its app entry
    (`"biosignal_pipeline"`), the ASR feeds under the graph entries — and
    its output equals the untuned stream's bitwise."""
    japp, app = apps
    if graph == "asr":
        japp, app = j_asr_frontend(), make_asr_frontend(device="cpu")
        sig, hop = _audio(512 * 6, seed=3), 160
    else:
        sig, hop = _raw(512 * 6, seed=3), 256
    kw = dict(window=512, hop=hop, batch_windows=4, framing=framing,
              graph=graph)
    jstream.BiosignalStream(japp, jstream.StreamConfig(
        autotune=True, **kw)).process(sig)
    got = BiosignalStream(app, StreamConfig(autotune=True, **kw)).process(
        torch.as_tensor(sig))
    _identical(got, BiosignalStream(app, StreamConfig(**kw)).process(
        torch.as_tensor(sig)))
    (key,) = _same_keys()
    want = {("biosignal", "kernel"): "biosignal_pipeline_stream",
            ("biosignal", "host"): "biosignal_pipeline",
            ("asr", "kernel"): "asr_pipeline_stream",
            ("asr", "host"): "asr_pipeline"}[graph, framing]
    assert key[0] == want


def test_fir_autotune_key_matches_reference():
    """The FIR tunes ``block_rows`` at the given ``seq_block`` under the
    reference's ``("fir", R, S, seq_block, dtype, k)`` key."""
    from repro.kernels.fir.ops import fir as j_fir

    x = np.random.default_rng(4).normal(size=(16, 3000)).astype(np.float32)
    taps = np.asarray([1.0, -0.97], np.float32)
    j_fir(x, taps, autotune=True)
    got = fir_ops.fir(torch.as_tensor(x), taps, autotune=True)
    assert torch.equal(got, fir_ops.fir(torch.as_tensor(x), taps))
    (key,) = _same_keys()
    assert key == ("fir", 16, 3000, 2048, "float32", 2)


def test_explicit_block_wins_over_tuning(apps):
    """An explicit block is never tuned over: the cache stays empty."""
    _, app = apps
    raw = torch.as_tensor(_raw(512 * 6, seed=2))
    ops.app_pipeline_stream(app, raw, window=512, hop=256, block_frames=2,
                            autotune=True)
    BiosignalStream(app, StreamConfig(window=512, hop=256, block_rows=1,
                                      autotune=True)).process(raw)
    ResidentStream(app, StreamConfig(window=512, hop=256, batch_windows=2),
                   ResidentConfig(ring_depth=2, autotune=True)).process(raw)
    fft_ops.fft(torch.zeros(4, 64), block_rows=2, autotune=True)
    assert tat.cache_snapshot() == {}


def test_candidate_pools_follow_the_kernels():
    """Each pool holds the kernel's default, stays within the kernel's
    bound, and has at most four members, largest first."""
    from repro_torch.kernels.fft.kernel import (MAX_THREADS,
                                                default_block_rows,
                                                threads_per_row)

    for n in (1, 2, 3, 8, 5000):
        c = tat.candidate_stream_block_frames(n, 2048, 512)
        assert c == sorted(c, reverse=True) and 1 in c and len(c) <= 4
        assert max(c) <= n
    assert tat.candidate_stream_block_frames(360000, 2048, 512) == [8, 4, 2, 1]
    for N in (2, 16, 256, 512, 4096, 8192):
        c = tat.candidate_block_rows(
            10_000, default=default_block_rows(N),
            max_rows=MAX_THREADS // threads_per_row(N))
        assert default_block_rows(N) in c and len(c) <= 4
        assert all(r * threads_per_row(N) <= MAX_THREADS for r in c)
    assert tat.candidate_ring_depths(40) == jat.candidate_ring_depths(40)
    assert tat.candidate_ring_depths(1) == [1]


class _FakeEvent:
    """A `torch.cuda.Event` stand-in that reads the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.mark.parametrize("case", ["short", "one_long", "gaps_asked",
                                  "ring_depth"])
def test_search_reads_every_candidate_on_one_clock(monkeypatch, case):
    """The card's clock without a card: a search reads all its candidates
    behind the device sleep or all as they run, never some of each. One
    candidate whose host enqueue passes `SLEEP_COVER_S` takes the sleep
    away from every candidate, and the ring depth's search never sleeps
    (its host gaps are what a deeper ring saves)."""
    sleeps = []
    monkeypatch.setattr(tat, "_cuda_output",
                        lambda out: torch.zeros(1))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "_sleep", sleeps.append)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    slow = 4 if case == "one_long" else None

    def run(rb):
        if rb == slow:
            time.sleep(2 * tat.SLEEP_COVER_S)
        return rb

    if case == "ring_depth":
        tat.tuned_ring_depth("resident_ring", 2048, 512, 8, ("class",),
                             "float32", 1, 40, run)
    else:
        tat.autotune_block_rows(("k", case), [8, 4, 2, 1],
                                lambda rb: lambda: run(rb),
                                host_gaps=case == "gaps_asked")
    (log,) = tat.search_log().values()
    assert log["clock"] == "cuda"
    if case == "short":
        assert not log["host_gaps"]
        # one sleep a rep, of one length for the whole search
        assert len(sleeps) == 3 * len(log["candidates"])
        assert len(set(sleeps)) == 1
    else:
        assert log["host_gaps"] and sleeps == []


def test_mesh_autotune_key_carries_columns_not_mesh(apps, tmp_path):
    """A call dealt over a column mesh tunes the path it serves under the
    reference's key: D is in it, the mesh is not (the reference's keys
    never name its mesh), so the serial and the mesh deal of the same
    traffic share one entry; the tuned mesh call is the untuned
    single-column one bitwise."""
    japp, app = apps
    raw = _raw(512 * 4, seed=17)
    frames = np.stack([raw[i * 512: (i + 1) * 512] for i in range(4)])
    cpu2 = (torch.device("cpu"),) * 2
    jops.app_pipeline_stream(japp, raw, window=512, hop=256, autotune=True,
                             n_columns=2, mesh=None)
    jops.app_pipeline(japp, frames, autotune=True, n_columns=2, mesh=None)
    for mesh in (cpu2, None):
        got = ops.app_pipeline_stream(app, torch.as_tensor(raw), window=512,
                                      hop=256, autotune=True, n_columns=2,
                                      mesh=mesh)
        _identical(got, ops.app_pipeline_stream(
            app, torch.as_tensor(raw), window=512, hop=256))
        got = ops.app_pipeline(app, torch.as_tensor(frames), autotune=True,
                               n_columns=2, mesh=mesh)
        _identical(got, ops.app_pipeline(app, torch.as_tensor(frames)))
    keys = _same_keys()
    assert len(keys) == 2
    assert all(k[-1] == 2 for k in keys)
    _crosses_over(tmp_path)
