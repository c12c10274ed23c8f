"""Chaos tests of the port's fault-tolerant column serving
(`repro_torch.serve.fault`) and its column scheduler
(`repro_torch.serve.engine.ColumnScheduler`), on the CPU.

THE INVARIANT, as in `tests/test_chaos.py`: for any injected fault
schedule — column deaths at any dispatch step, several deaths, deaths
among transient faults, death mid-resident-sweep, hangs, stragglers —
the recovered output is BITWISE the port's fault-free single-column run.

Every scenario also runs through the JAX package's runner (one device,
Pallas in interpret mode) on the same schedule and the same
`VirtualClock`, and the two must take the same decisions: the same
dispatch and requeue counts, the same dead columns, the same queues
after every requeue, the same per-column busy (virtual) seconds and, in
resident mode, the same drained counts; the outputs agree with `class`
exact and the floats within the tolerances of `tests/test_torch_stream.py`.
A scenario whose outcome is a typed error must raise the same error in
both.

The scheduler's placement, rebalance, retire-count trigger, deal
weights (with and without a band), drain, supervision, withdraw/restore
and stream-opening cases (`tests/test_load_aware.py`,
`tests/test_stream_sharded.py`, `tests/test_chaos.py`) are fed the same
telemetry events in both packages and must make the same decisions.
The reference's benchmark-trajectory cases have no counterpart here;
its autotune cases run in `tests/test_torch_autotune.py`.
"""
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core.biosignal import make_app as j_make_app
from repro.runtime import fault as jrt
from repro.serve import engine as jengine
from repro.serve import fault as jfault
from repro.serve import resident as jres
from repro.serve import stream as jstream
from repro_torch.core.biosignal import app_from_numpy
from repro_torch.runtime import fault as trt
from repro_torch.serve import engine as tengine
from repro_torch.serve import fault as tfault
from repro_torch.serve import resident as tres
from repro_torch.serve import stream as tstream

WINDOW, HOP, BW = 512, 256, 2
CPU = torch.device("cpu")


def _ns(rt, engine, fault, res, stream, app, device, as_signal):
    return types.SimpleNamespace(
        rt=rt, Scheduler=engine.ColumnScheduler, fault=fault,
        ResidentConfig=res.ResidentConfig, StreamConfig=stream.StreamConfig,
        Telemetry=stream.StreamTelemetry, Stream=stream.BiosignalStream,
        app=app, device=device, signal=as_signal)


@pytest.fixture(scope="module")
def pkgs():
    """One namespace per package: its classes, its app and its device."""
    japp = j_make_app()
    app = app_from_numpy(japp.fir_taps, np.asarray(japp.svm_w),
                         np.asarray(japp.svm_b), japp.fft_size, device="cpu")
    return {"jax": _ns(jrt, jengine, jfault, jres, jstream, japp,
                       jax.devices()[0], lambda x: x),
            "torch": _ns(trt, tengine, tfault, tres, tstream, app, CPU,
                         torch.as_tensor)}


def _signal(n_frames: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=WINDOW + (n_frames - 1) * HOP).astype(np.float32)


@pytest.fixture(scope="module")
def reference(pkgs):
    """The port's fault-free single-column outputs, keyed by frames."""
    cache = {}
    ns = pkgs["torch"]

    def get(n_frames: int):
        if n_frames not in cache:
            cfg = ns.StreamConfig(window=WINDOW, hop=HOP, batch_windows=BW)
            cache[n_frames] = ns.Stream(ns.app, cfg).process(
                ns.signal(_signal(n_frames)))
        return cache[n_frames]

    return get


def assert_identical(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


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


# ------------------------------------------------ the runner, both packages

def _serve(ns, n_frames, n_columns, *, injector=None, mode="batch",
           rcfg=None, straggler=None, **kw):
    """Run one schedule through ``ns``'s runner; returns what it decided
    (and its outputs, or the typed error it raised)."""
    clk = ns.fault.VirtualClock()
    inj = ns.fault.FaultInjector(clock=clk, **{"dispatch_s": 0.01,
                                               **(injector or {})})
    runner = ns.fault.FaultTolerantColumnRunner(
        ns.app, ns.StreamConfig(window=WINDOW, hop=HOP, batch_windows=BW),
        n_columns=n_columns, injector=inj, clock=clk, mode=mode,
        rcfg=None if rcfg is None else ns.ResidentConfig(**rcfg),
        straggler=None if straggler is None
        else ns.rt.StragglerDetector(**straggler),
        devices=[ns.device] * n_columns, **kw)
    log = []
    requeue = runner._requeue_from

    def logged(column, queues):         # the queues after every requeue
        requeue(column, queues)
        log.append((column, [list(q) for q in queues]))

    runner._requeue_from = logged
    try:
        out = runner.process(ns.signal(_signal(n_frames)))
    except Exception as e:              # the decision under test
        out = f"{type(e).__name__}: {e}"
    return out, dict(
        dispatches=runner.dispatches, requeues=runner.requeues,
        dead=set(runner.scheduler.dead), queues=log,
        initial=[list(q) for q in runner._initial_queues(n_frames)],
        busy=[round(b, 9) for b in runner.column_busy],
        drains=[runner.streams[d].last_drains for d in range(n_columns)]
        if mode == "resident" else None)


def serve_both(pkgs, reference, n_frames, n_columns, **kw):
    """The schedule through both packages: same decisions, outputs within
    tolerance of the reference's and bitwise the port's fault-free run.
    Returns the port's (outputs, decisions)."""
    jout, jdec = _serve(pkgs["jax"], n_frames, n_columns, **kw)
    tout, tdec = _serve(pkgs["torch"], n_frames, n_columns, **kw)
    assert tdec == jdec
    if isinstance(jout, str):
        assert tout.split(":")[0] == jout.split(":")[0]
        return tout, tdec
    assert_matches_reference(tout, jout)
    assert_identical(tout, reference(n_frames))
    return tout, tdec


@pytest.mark.parametrize("n_frames,n_columns", [(9, 2), (13, 3), (21, 4)])
@pytest.mark.parametrize("column,kill_step", [(0, 0), (0, 1), (0, 2),
                                              (-1, 1)])
def test_killed_column_recovers_bit_identical(pkgs, reference, n_frames,
                                              n_columns, column, kill_step):
    column %= n_columns
    _, dec = serve_both(pkgs, reference, n_frames, n_columns,
                        injector=dict(kill={column: kill_step}))
    assert dec["dead"] == {column}
    assert dec["requeues"] >= 1     # the killed range was never retired


@pytest.mark.parametrize("injector,n_frames,n_columns,dead", [
    (dict(kill={0: 1, 2: 0}), 21, 4, {0, 2}),
    # transients on survivors while another column dies: the retry layer
    # absorbs the former, the requeue layer the latter
    (dict(kill={1: 1}, transient={(0, 0), (2, 1), (2, 2)}), 13, 3, {1}),
    (dict(transient={(0, 0), (0, 1), (1, 2)}), 13, 3, set()),
    (dict(kill={0: 0, 1: 0, 2: 1}), 21, 4, {0, 1, 2}),
])
def test_several_faults_recover_bit_identical(pkgs, reference, injector,
                                              n_frames, n_columns, dead):
    _, dec = serve_both(pkgs, reference, n_frames, n_columns,
                        injector=injector)
    assert dec["dead"] == dead


def test_all_columns_dead_raises_typed_error(pkgs, reference):
    out, _ = serve_both(pkgs, reference, 9, 2,
                        injector=dict(kill={0: 0, 1: 1}))
    assert out.startswith("InsufficientHealthyWorkers")


@pytest.mark.parametrize("kill_drain", [0, 1])
def test_death_mid_resident_sweep(pkgs, reference, kill_drain):
    """A resident column dying at a counter drain: earlier drains already
    fed the telemetry, the sweep's outputs are lost with the column and
    its whole share requeues. ring_depth 1 + drain_interval 1 gives the
    4-frame share two drain points."""
    _, dec = serve_both(pkgs, reference, 13, 3, mode="resident",
                        rcfg=dict(ring_depth=1, drain_interval=1),
                        injector=dict(kill_drain={1: kill_drain}))
    assert dec["dead"] == {1} and dec["requeues"] == 1


@pytest.mark.parametrize("rcfg", [dict(ring_depth=2, drain_interval=1),
                                  dict(ring_depth=1, drain_interval=3)])
def test_resident_fault_free_matches_reference(pkgs, reference, rcfg):
    _, dec = serve_both(pkgs, reference, 13, 3, mode="resident", rcfg=rcfg)
    assert dec["dead"] == set() and dec["requeues"] == 0


def test_resident_transient_launches_nothing_before_retry(pkgs, reference):
    _, dec = serve_both(pkgs, reference, 13, 3, mode="resident",
                        rcfg=dict(ring_depth=2, drain_interval=1),
                        injector=dict(transient={(0, 0), (2, 0)}))
    assert dec["dead"] == set()


def test_hung_column_dies_by_heartbeat_timeout(pkgs, reference):
    """A wedged column (no retire, no error) resolves only through the
    heartbeat timeout: the retire feed goes quiet, supervision declares
    it dead, its queue requeues."""
    _, dec = serve_both(pkgs, reference, 21, 4, heartbeat_timeout=2.0,
                        injector=dict(hang_from={2: 1}, dispatch_s=0.5))
    assert 2 in dec["dead"]


def test_hung_column_without_supervision_stalls_loudly(pkgs, reference):
    out, _ = serve_both(pkgs, reference, 9, 2, max_idle_passes=5,
                        injector=dict(hang_from={1: 0}, dispatch_s=0.5))
    assert out.startswith("RuntimeError") and "stopped progressing" in out


def test_straggler_column_is_evicted_and_work_requeued(pkgs, reference):
    _, dec = serve_both(pkgs, reference, 21, 4,
                        injector=dict(slow={3: 0.2}),
                        straggler=dict(straggler_factor=2.0, evict_after=2))
    assert dec["dead"] == {3}


def test_weighted_deal_with_band_recovers_bit_identical(pkgs, reference):
    _, dec = serve_both(pkgs, reference, 21, 4, weights=(1, 2, 0, 1),
                        deal_band=0.25, injector=dict(kill={1: 2}))
    assert dec["dead"] == {1} and dec["initial"][2] == []


# ------------------------------------------------- the injector, both

def test_injector_reset_replays_identically(pkgs):
    for ns in pkgs.values():
        clk = ns.fault.VirtualClock()
        inj = ns.fault.FaultInjector(kill={0: 1}, transient={(1, 0)},
                                     dispatch_s=0.01, clock=clk)
        outs, deads = [], []
        for _ in range(2):
            r = ns.fault.FaultTolerantColumnRunner(
                ns.app, ns.StreamConfig(window=WINDOW, hop=HOP,
                                        batch_windows=BW),
                n_columns=3, injector=inj, clock=clk,
                devices=[ns.device] * 3)
            outs.append(r.process(ns.signal(_signal(13))))
            deads.append(set(r.scheduler.dead))
            inj.reset()                 # counters rewind, the clock doesn't
        assert deads == [{0}, {0}]
        for k in outs[0]:
            assert (np.asarray(outs[0][k]) == np.asarray(outs[1][k])).all()


def test_injector_sequences_are_per_column(pkgs):
    def run(ns):
        inj = ns.fault.FaultInjector(kill={1: 1}, transient={(0, 2)},
                                     kill_drain={0: 1})
        got = []
        for col in (0, 0, 1, 1, 0, 0):
            try:
                inj.on_dispatch(col)
                got.append((col, "ok"))
            except Exception as e:
                got.append((col, type(e).__name__, getattr(e, "column",
                                                           None)))
        for col in (0, 0):
            try:
                inj.on_drain(col)
                got.append(("drain", col, "ok"))
            except Exception as e:
                got.append(("drain", col, type(e).__name__, str(e)))
        try:
            ns.fault.FaultInjector(hang_from={0: 0}).on_dispatch(0)
        except ns.fault.ColumnHungError as e:
            got.append(("hung", e.column))
        return got

    got = {name: run(ns) for name, ns in pkgs.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == [(0, "ok"), (0, "ok"), (1, "ok"),
                                (1, "ColumnDeadError", 1)]
    assert got["torch"][4][1] == "TransientDispatchError"


# ---------------------------------------------------- scheduler decisions

def decide(pkgs, scenario):
    """``scenario(ns)`` in both packages; the decisions must be equal.
    Returns the port's."""
    got = {name: scenario(ns) for name, ns in pkgs.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _cols(sched, sids):
    return {s: sched.column_of(s) for s in sids}


def _warm(ns, rates, *, alpha=0.5, ratio=2.0):
    """One stream per column retiring ``rates`` windows/s (virtual)."""
    clk = ns.fault.VirtualClock()
    tel = ns.Telemetry(alpha=alpha, clock=clk)
    sched = ns.Scheduler([ns.device] * len(rates), telemetry=tel,
                         rebalance_ratio=ratio)
    for i in range(len(rates)):
        sched.admit(f"s{i}")
    for _ in range(3):
        for i, r in enumerate(rates):
            clk.advance(1.0 / len(rates))
            tel.record_retire(f"s{i}", r)
    return sched, tel, clk


def test_scheduler_places_round_robin_and_reuses_freed_columns(pkgs):
    def run(ns):
        sched = ns.Scheduler([ns.device] * 3)
        placed = [sched.admit(f"s{i}") for i in range(3)]
        out = [_cols(sched, [f"s{i}" for i in range(3)]),
               placed == [ns.device] * 3]
        sched.admit("extra")
        out += [sched.column_of("extra"), sched.loads()]
        sched.release("s1")
        sched.admit("reuse")
        out += [sched.column_of("reuse"), sched.loads()]
        try:
            sched.admit("reuse")
        except (AssertionError, ValueError):
            out.append("refused")
        return out

    assert decide(pkgs, run) == [{"s0": 0, "s1": 1, "s2": 2}, True, 0,
                                 [2, 1, 1], 1, [2, 1, 1], "refused"]


def test_scheduler_cold_and_measured_placement(pkgs):
    def run(ns):
        sched = ns.Scheduler([ns.device] * 3, telemetry=ns.Telemetry())
        out = [sched.measured_loads()]
        for i in range(4):
            sched.admit(f"c{i}")
        out.append(_cols(sched, [f"c{i}" for i in range(4)]))
        warm, _, _ = _warm(ns, [24.0, 4.0, 4.0])
        out.append(warm.measured_loads())
        warm.admit("new")
        out.append(warm.column_of("new"))
        spread, _, _ = _warm(ns, [50.0, 60.0, 70.0])
        for i in range(6):                      # cold burst spreads
            spread.admit(f"cold{i}")
        out += [spread.loads(), spread.measured_loads()]
        return out

    got = decide(pkgs, run)
    assert got[0] is None and got[1] == {"c0": 0, "c1": 1, "c2": 2, "c3": 0}
    assert got[3] == 1 and sorted(got[4]) == [3, 3, 3]


def test_scheduler_rebalance_decisions(pkgs):
    def run(ns):
        clk = ns.fault.VirtualClock()
        tel = ns.Telemetry(alpha=0.5, clock=clk)
        sched = ns.Scheduler([ns.device] * 3, telemetry=tel,
                             rebalance_ratio=1.5)
        for sid, col in [("h0", 0), ("h1", 0), ("l0", 1)]:
            sched.admit(sid)
            sched._move(sid, col)       # the pathological layout
        for _ in range(3):
            for sid, r in [("h0", 10.0), ("h1", 10.0), ("l0", 2.0)]:
                clk.advance(0.33)
                tel.record_retire(sid, r * 0.33)
        before = sched.measured_loads()
        moves = sched.rebalance()
        out = [before, sorted(moves), _cols(sched, ["h0", "h1", "l0"]),
               sched.measured_loads()]
        balanced, _, _ = _warm(ns, [8.0, 8.0, 8.0])
        out.append(balanced.rebalance())
        counts = ns.Scheduler([ns.device] * 2, rebalance_ratio=1.5)
        for i in range(4):              # cold: rebalance evens counts
            counts.admit(f"s{i}")
            counts._move(f"s{i}", 0)
        out += [sorted(counts.rebalance()), counts.loads()]
        return out

    got = decide(pkgs, run)
    assert got[1] and max(got[3]) < max(got[0])
    assert got[4] == {} and got[6] == [2, 2] and len(got[5]) == 2


def test_scheduler_retire_count_trigger(pkgs):
    def run(ns):
        clk = ns.fault.VirtualClock()
        tel = ns.Telemetry(alpha=0.5, clock=clk)
        sched = ns.Scheduler([ns.device] * 2, telemetry=tel,
                             rebalance_ratio=1.5, rebalance_every=12)
        for i in range(4):
            sched.admit(f"s{i}")
            sched._move(f"s{i}", 0)
        tel.attach("foreign", 1)        # not placed: never counts
        out = []
        for step in range(4):
            clk.advance(0.5)
            for i in range(4):
                tel.record_retire(f"s{i}", 2)
            tel.record_retire("foreign", 50)
            out.append((step, sorted(sched.pop_moves()), sched.loads()))
        return out

    got = decide(pkgs, run)
    assert any(moves for _, moves, _ in got)


def test_scheduler_deal_weights_and_band(pkgs):
    def run(ns):
        sched, tel, clk = _warm(ns, [6.0, 12.0, 12.0])
        out = [sched.deal_weights()]
        tel2 = ns.Telemetry(alpha=0.5, clock=clk)
        cold = ns.Scheduler([ns.device] * 3, telemetry=tel2)
        out.append(cold.deal_weights())
        tel2.attach("a", 0)
        tel2.record_retire("a", 4)
        clk.advance(1.0)
        tel2.record_retire("a", 4)
        out.append(cold.deal_weights())             # unobserved: the mean
        banded, _, _ = _warm(ns, [5.0, 10.0, 11.0, 9.5])
        out += [banded.deal_weights(band=0.3), banded.deal_weights()]
        return out

    got = decide(pkgs, run)
    assert got[1] is None and got[2] == pytest.approx((4.0, 4.0, 4.0))
    assert got[3][1] == got[3][2] == got[3][3]
    assert got[4] == pytest.approx((5.0, 10.0, 11.0, 9.5), rel=1e-3)


def test_scheduler_mark_dead_drains_and_zeroes_the_deal(pkgs):
    def run(ns):
        clk = ns.fault.VirtualClock()
        tel = ns.Telemetry(clock=clk)
        sched = ns.Scheduler([ns.device] * 3, telemetry=tel, clock=clk)
        for sid in ("a", "b", "c"):
            sched.admit(sid)
        moves = sched.mark_dead(1)
        out = [sorted(moves), sched.column_of("b"),
               sorted(sched.pop_moves()), sched.healthy_columns()]
        for i in range(4):
            sched.admit(f"n{i}")
        out += [_cols(sched, [f"n{i}" for i in range(4)]),
                sched.mark_dead(1)]
        for _ in range(3):
            clk.advance(1.0)
            for sid in ("a", "b", "c"):
                tel.record_retire(sid, 8)
        out.append(sched.deal_weights())
        sched.mark_dead(2)
        try:
            sched.mark_dead(0)
        except ns.rt.InsufficientHealthyWorkers:
            out.append("raised")
        return out

    got = decide(pkgs, run)
    assert got[0] == ["b"] and got[1] != 1 and got[3] == [0, 2]
    assert 1 not in got[4].values() and got[5] == {}
    assert got[6][1] == 0.0 and got[-1] == "raised"


def test_scheduler_supervise_heartbeat_and_straggler_paths(pkgs):
    def run(ns):
        clk = ns.fault.VirtualClock()
        tel = ns.Telemetry(clock=clk)
        det = ns.rt.StragglerDetector(straggler_factor=2.0, evict_after=2)
        sched = ns.Scheduler([ns.device] * 4, telemetry=tel, clock=clk,
                             heartbeat_timeout=5.0, straggler=det)
        for sid in ("a", "b", "c", "d"):
            sched.admit(sid)
        for _ in range(3):
            clk.advance(1.0)
            for sid in ("a", "b", "c"):
                tel.record_retire(sid, 4)
            for col, dt in ((0, 0.1), (1, 0.9), (2, 0.1), (3, 0.1)):
                sched.record_batch_time(col, dt)
        clk.advance(3.0)
        for sid in ("a", "b", "c"):
            tel.record_retire(sid, 4)
        return [sched.supervise(), sched.supervise(),
                sched.healthy_columns(), sched.supervise(),
                _cols(sched, "abcd")]

    got = decide(pkgs, run)
    assert got[:4] == [[3], [1], [0, 2], []]


def test_scheduler_withdraw_and_restore(pkgs):
    def run(ns):
        clk = ns.fault.VirtualClock()
        tel = ns.Telemetry(clock=clk)
        sched = ns.Scheduler([ns.device] * 2, telemetry=tel, clock=clk,
                             heartbeat_timeout=5.0)
        sched.admit("a")
        sched.admit("b")
        _, moves = sched.withdraw(1)
        out = [sorted(moves), sched.healthy_columns(), sorted(sched.dead)]
        for call in (lambda: sched.withdraw(0), lambda: sched.withdraw(1),
                     lambda: sched.restore(0)):
            try:
                call()
                out.append("ok")
            except Exception as e:
                out.append(type(e).__name__)
        clk.advance(4.0)
        sched.restore(1)
        clk.advance(3.0)            # column 0 silent 7 s, column 1 3 s
        out += [sched.healthy_columns(), sched.supervise()]
        return out

    assert decide(pkgs, run) == [
        ["b"], [0], [1], "InsufficientHealthyWorkers", "ValueError",
        "ValueError", [0, 1], [0]]


# ------------------------------------------- streams opened by scheduler

def test_open_stream_wires_telemetry_and_matches_reference(pkgs):
    sig = _signal(11, seed=23)
    got = {}
    for name, ns in pkgs.items():
        tel = ns.Telemetry()
        sched = ns.Scheduler([ns.device] * 2, telemetry=tel)
        cfg = ns.StreamConfig(window=WINDOW, hop=HOP, batch_windows=4)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            stream = sched.open_stream(ns.app, cfg, stream_id="sensor-a")
        assert any(issubclass(w.category, DeprecationWarning)
                   for w in caught)
        col = sched.column_of("sensor-a")
        assert stream.device == sched.devices[col]
        out = stream.process(ns.signal(sig))
        windows = tel.column_stats(2)[col].windows
        sched.release("sensor-a")
        got[name] = (out, col, windows, sched.loads(),
                     tel.column_load(col))
    tout, *tdec = got["torch"]
    jout, *jdec = got["jax"]
    assert tdec == jdec and tdec[1] == 11
    assert_matches_reference(tout, jout)
    ns = pkgs["torch"]
    unpinned = ns.Stream(ns.app, ns.StreamConfig(
        window=WINDOW, hop=HOP, batch_windows=4)).process(ns.signal(sig))
    assert_identical(tout, unpinned)


def test_manual_repin_reattributes_telemetry(pkgs):
    def run(ns):
        tel = ns.Telemetry()
        s = ns.Stream(ns.app, ns.StreamConfig(window=WINDOW, hop=HOP,
                                              batch_windows=5),
                      telemetry=tel, stream_id="s0", column=0)
        sig = ns.signal(_signal(7, seed=31))
        s.process(sig)
        w0 = tel.column_stats(2)[0].windows
        s.repin(ns.device, column=1)
        s.process(sig)
        return [w0, s.column, [c.windows for c in tel.column_stats(2)]]

    assert decide(pkgs, run) == [7, 1, [7, 7]]


def test_default_devices_never_fall_back_to_the_cpu(pkgs):
    """With no card, the scheduler's and the runner's default devices
    raise; on a card they are CUDA devices."""
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in tengine.ColumnScheduler().devices)
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.ColumnScheduler()
    with pytest.raises(RuntimeError, match="cuda"):
        tfault.FaultTolerantColumnRunner(pkgs["torch"].app, n_columns=2)
    with pytest.raises(RuntimeError, match="cuda"):
        tfault.FaultTolerantColumnRunner(n_columns=2)
