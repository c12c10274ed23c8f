"""The port's unified admission front-end (`repro_torch.serve.frontend`)
against the JAX package's, on the CPU: the cases of
`tests/test_frontend.py`.

* The same submissions through both packages' `ServeFrontend` give the
  same ticket states after every pump and the same dispatch order
  (each engine's `add_request` and each scheduler's `place_stream`
  logged), and the LM tickets resolve to the reference's greedy tokens
  (reduced qwen1.5-0.5b, vocab 64, the JAX package's parameters of seed
  3 carried by `params_from_numpy`, float32 on both sides).
* The ASR class runs on reduced whisper-medium (vocab 64): its log-mel
  features are within `tests/test_torch_asr.py`'s tolerance (1e-5 of
  max(1, max |reference|)) of the reference front-end's, and its greedy
  tokens equal the reference's.
* Backpressure, the feature stash, column lending, the shims' warnings
  and the error taxonomy as the reference pins them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build_model
from repro.models import init_model_params as j_init_model_params
from repro.serve import engine as jeng_mod
from repro.serve import engine_fault as jft
from repro.serve import frontend as jfe
from repro.sharding import ctx as jctx
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import engine as eng_mod
from repro_torch.serve import engine_fault as ft
from repro_torch.serve import errors as err
from repro_torch.serve import frontend as fe


@pytest.fixture(autouse=True, scope="module")
def _no_installed_activation_specs():
    """The reference's train-step factory installs activation sharding
    specs for the whole process (`repro.sharding.ctx.install`), so a test
    of another file that built one leaves them set in this worker, and
    the reference's models then constrain to a mesh no test here entered.
    Start from none, as a fresh process does."""
    jctx.install(None)


PROMPTS = {0: [3, 1, 4, 1], 1: [5, 9, 2], 2: [6, 5], 3: [8, 9, 7, 9, 3]}
LOGMEL_TOL = 1e-5


def _pair(name):
    jcfg = dataclasses.replace(j_reduced(j_get_config(name)), vocab_size=64)
    jm = j_build_model(jcfg)
    jp = j_init_model_params(jm, seed=3)
    cfg = dataclasses.replace(reduced(get_config(name)), vocab_size=64)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jp),
                               device="cpu")
    return model, params, (jm, jp, jeng_mod.Engine.compile_model(jm))


@pytest.fixture(scope="module")
def setup():
    return _pair("qwen1.5-0.5b")


@pytest.fixture(scope="module")
def asr_setup():
    """Reduced whisper-medium: the ASR class's enc-dec decode backend."""
    return _pair("whisper-medium")


def _engine(setup, cls=eng_mod.Engine, **kw):
    model, params, _ = setup
    return cls(model, params, slots=2, max_len=64, temperature=0.0, seed=7,
               device="cpu", **kw)


def _ref_engine(setup, cls=jeng_mod.Engine, **kw):
    jm, jp, compiled = setup[2]
    return cls(jm, jp, slots=2, max_len=64, temperature=0.0, seed=7,
               compiled=compiled, **kw)


def _audio(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _logged(engine, scheduler, order):
    """Wrap ``engine.add_request`` and ``scheduler.place_stream`` so that
    each dispatch appends (class, id) to ``order``."""
    if engine is not None:
        real_add = engine.add_request

        def add(req, **kw):
            real_add(req, **kw)
            order.append(("engine", req.rid))
        engine.add_request = add
    if scheduler is not None:
        real_place = scheduler.place_stream

        def place(app=None, cfg=None, *, stream_id):
            out = real_place(app, cfg, stream_id=stream_id)
            order.append(("stream", stream_id))
            return out
        scheduler.place_stream = place


def _drive(pkg, engine, scheduler, works, qos=None):
    """Submit ``works`` (factories taking the package's front-end module
    and engine module) through one front-end; pump until quiet, then run.
    Returns (statuses after each pump, dispatch order, tickets)."""
    order = []
    _logged(engine, scheduler, order)
    front = pkg.ServeFrontend(engine=engine, scheduler=scheduler, qos=qos)
    tickets = [front.submit(w) for w in works]
    states = []
    for _ in range(3):
        front.pump()
        states.append([t.status for t in tickets])
    front.run()
    states.append([t.status for t in tickets])
    return states, order, tickets, front


def _both(setup, works, *, cls=(eng_mod.Engine, jeng_mod.Engine),
          engine_kw=None, columns=None, qos=None):
    """Run ``works(fe_module, engine_module)`` through the port and the
    reference; assert equal states and dispatch order; return both
    drives."""
    runs = []
    for pkg, emod, mk, ecls, devs in (
            (fe, eng_mod, _engine, cls[0], ["cpu"] * (columns or 0)),
            (jfe, jeng_mod, _ref_engine, cls[1],
             [f"c{i}" for i in range(columns or 0)])):
        engine = mk(setup, ecls, **(engine_kw or {})) \
            if setup is not None else None
        sched = emod.ColumnScheduler(devices=devs) if columns else None
        runs.append(_drive(pkg, engine, sched, works(pkg, emod), qos))
    (s0, o0, t0, _), (s1, o1, t1, _) = runs
    assert s0 == s1
    assert o0 == o1
    return runs


def _tokens(tickets):
    out = {}
    for t in tickets:
        if t.status == "done" and t.work_class in ("lm", "asr"):
            r = t.result()
            req = r.request if t.work_class == "asr" else r
            out[req.rid] = tuple(req.out)
    return out


# ------------------------------------------------------- ticket lifecycle

def test_lm_ticket_lifecycle(setup):
    front = fe.ServeFrontend(engine=_engine(setup))
    t = front.submit(eng_mod.Request(0, list(PROMPTS[0]), max_new=4))
    assert isinstance(t, fe.Ticket)
    assert (t.work_class, t.status) == ("lm", "queued")
    with pytest.raises(err.TicketNotReady):
        t.result()
    front.run()
    assert t.status == "done"
    req = t.result()
    assert req.rid == 0 and len(req.out) == 4


def test_stream_ticket_resolves_at_dispatch():
    sched = eng_mod.ColumnScheduler(devices=["cpu", "cpu"])
    front = fe.ServeFrontend(scheduler=sched)
    t = front.submit(fe.StreamOpen(stream_id="s-1"))
    assert t.status == "queued"
    front.pump()
    assert t.status == "done"
    assert t.result().column == sched.column_of("s-1")


def test_both_classes_one_front_end(setup):
    """LM requests and stream opens through one verb in both packages:
    the same states, dispatch order and greedy tokens, the streams
    balanced, and a paged engine under the port's front-end giving the
    dense engine's tokens."""
    def works(pkg, emod):
        return ([emod.Request(r, list(p), max_new=4)
                 for r, p in PROMPTS.items()] +
                [pkg.StreamOpen(stream_id=f"s{i}") for i in range(3)])
    (s0, _, t0, f0), (_, _, t1, f1) = _both(
        setup, works, cls=(eng_mod.PagedEngine, jeng_mod.PagedEngine),
        engine_kw=dict(page_size=8), columns=2)
    assert s0[-1] == ["done"] * 7
    assert _tokens(t0) == _tokens(t1)
    assert sorted(f0.scheduler.loads()) == [1, 2]
    dense = _engine(setup)
    for r, p in PROMPTS.items():
        dense.add_request(eng_mod.Request(r, list(p), max_new=4))
    assert _tokens(t0) == {r.rid: tuple(r.out) for r in
                           dense.run_to_completion(max_steps=500)}


def test_submit_rejects_unknown_work(setup):
    front = fe.ServeFrontend(engine=_engine(setup))
    with pytest.raises(TypeError):
        front.submit("not a work item")
    with pytest.raises(ValueError):
        front.submit(fe.StreamOpen(stream_id="s"))   # no scheduler wired


def test_typed_rejection_lands_on_ticket(setup):
    def works(pkg, emod):
        return [emod.Request(0, list(range(2, 80)), max_new=4),
                emod.Request(1, [3, 1], max_new=2)]
    (s0, _, t0, _), _ = _both(setup, works)
    assert s0[0] == ["failed", "running"] and s0[-1] == ["failed", "done"]
    with pytest.raises(err.PromptTooLong):
        t0[0].result()


@pytest.mark.parametrize("qos", [{"lm": 1, "stream": 2},
                                 {"lm": 3, "stream": 1}],
                         ids=["lm1_stream2", "lm3_stream1"])
def test_qos_round_robin_order_equals_the_reference(qos):
    """A burst of one class cannot starve the other; the order is the
    reference's for the same weights and arrivals."""
    orders = []
    for pkg, emod in ((fe, eng_mod), (jfe, jeng_mod)):
        order = []

        class SpyEngine:
            def add_request(self, req):
                order.append(("lm", req.rid))

        class SpyScheduler:
            def place_stream(self, app=None, cfg=None, *, stream_id):
                order.append(("stream", stream_id))
                return stream_id

        front = pkg.ServeFrontend(engine=SpyEngine(),
                                  scheduler=SpyScheduler(), qos=qos)
        for i in range(3):
            front.submit(emod.Request(i, [1, 2], max_new=1))
        for i in range(6):
            front.submit(pkg.StreamOpen(stream_id=i))
        front.pump()
        orders.append(order)
    assert orders[0] == orders[1] and len(orders[0]) == 9
    if qos == {"lm": 1, "stream": 2}:
        assert orders[0][:6] == [("lm", 0), ("stream", 0), ("stream", 1),
                                 ("lm", 1), ("stream", 2), ("stream", 3)]


def test_queue_full_backpressure_retries_next_pump(setup):
    """`QueueFull` leaves tickets QUEUED; `run` re-pumps as the engine
    frees queue space, in both packages alike."""
    def works(pkg, emod):
        return [emod.Request(r, list(p), max_new=4)
                for r, p in PROMPTS.items()]
    (s0, o0, t0, _), (_, _, t1, _) = _both(
        setup, works, cls=(ft.FaultTolerantEngine, jft.FaultTolerantEngine),
        engine_kw=dict(max_queue=2))
    assert s0[0] == ["running", "running", "queued", "queued"]
    assert s0[-1] == ["done"] * 4
    assert _tokens(t0) == _tokens(t1)


# ------------------------------------------------------- the ASR class

def _assert_logmel_close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    err_ = float(np.abs(got.numpy() - want).max())
    assert err_ <= LOGMEL_TOL * max(1.0, float(np.abs(want).max())), err_


def test_asr_ticket_lifecycle(asr_setup):
    """Featurize at dispatch, enc-dec decode token at a time, `AsrResult`
    pairing the log-mel with the finished request: the reference's
    features within tolerance and its greedy tokens."""
    def works(pkg, emod):
        return [pkg.AsrTranscribe(7, _audio(512 * 3), max_new=4)]
    (s0, _, t0, f0), (_, _, t1, _) = _both(asr_setup, works)
    assert s0[0] == ["running"] and s0[-1] == ["done"]
    res, ref = t0[0].result(), t1[0].result()
    assert isinstance(res, fe.AsrResult) and res.rid == 7
    assert tuple(res.features.shape) == (7, 64)    # 512*3 at (512, 160)
    assert res.features.device.type == "cpu"
    _assert_logmel_close(res.features, ref.features)
    assert res.tokens == res.request.out == ref.tokens
    assert 1 <= len(res.tokens) <= 4
    assert f0._features == {}                      # stash drained


def test_asr_features_equal_a_direct_entry_call(asr_setup):
    """The ticket's features are bitwise one direct `graph_pipeline_stream`
    call on the same waveform (a tensor is featurized where it lies)."""
    from repro_torch.kernels.pipeline.ops import graph_pipeline_stream

    audio = torch.as_tensor(_audio(512 * 4, seed=5))
    front = fe.ServeFrontend(engine=_engine(asr_setup))
    t = front.submit(fe.AsrTranscribe(3, audio, max_new=2))
    front.run()
    want = graph_pipeline_stream("asr", None, audio, window=512, hop=160,
                                 outputs=("logmel",))["logmel"]
    assert torch.equal(t.result().features, want)


def test_asr_requires_engine():
    front = fe.ServeFrontend(
        scheduler=eng_mod.ColumnScheduler(devices=["cpu"]))
    with pytest.raises(ValueError, match="no engine"):
        front.submit(fe.AsrTranscribe(0, _audio(1024)))


def test_asr_default_qos_covers_three_classes(asr_setup):
    front = fe.ServeFrontend(engine=_engine(asr_setup))
    assert front.qos == {"lm": 1, "stream": 1, "asr": 1}
    with pytest.raises(ValueError):
        fe.ServeFrontend(engine=_engine(asr_setup), qos={"lm": 0})


def test_three_classes_one_front_end(asr_setup):
    """LM requests, stream opens and transcriptions through the one
    verb: the reference's states, order, tokens and features."""
    def works(pkg, emod):
        return [emod.Request(0, [3, 1, 4], max_new=4),
                pkg.StreamOpen(stream_id="s-0"),
                pkg.AsrTranscribe(1, _audio(512 * 2, seed=2), max_new=4),
                emod.Request(2, [5, 9], max_new=3),
                pkg.AsrTranscribe(3, _audio(512 * 2 + 77, seed=3),
                                  max_new=3)]
    (s0, o0, t0, _), (_, _, t1, _) = _both(
        asr_setup, works, columns=2, qos={"lm": 2, "stream": 1, "asr": 1})
    assert s0[-1] == ["done"] * 5
    assert _tokens(t0) == _tokens(t1)
    for i in (2, 4):
        _assert_logmel_close(t0[i].result().features,
                             t1[i].result().features)
    assert o0[:3] == [("engine", 0), ("engine", 2), ("stream", "s-0")]


def test_asr_backpressure_reuses_feature_stash(asr_setup, monkeypatch):
    """`QueueFull` leaves ASR tickets queued; each ticket is featurized
    once (the stash is reused on the retry), and every ticket resolves
    with the reference's states and tokens."""
    from repro_torch.kernels.pipeline import ops

    calls = []
    real = ops.graph_pipeline_stream

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "graph_pipeline_stream", counting)

    def works(pkg, emod):
        return [pkg.AsrTranscribe(r, _audio(512 * 2, seed=r), max_new=2)
                for r in range(3)]
    (s0, _, t0, f0), (_, _, t1, _) = _both(
        asr_setup, works,
        cls=(ft.FaultTolerantEngine, jft.FaultTolerantEngine),
        engine_kw=dict(max_queue=1))
    assert s0[0] == ["running", "queued", "queued"]
    assert s0[-1] == ["done"] * 3
    assert len(calls) == 3
    assert _tokens(t0) == _tokens(t1)
    assert f0._features == {}


# --------------------------------------------------------- re-provisioning

def test_lend_and_return_columns():
    sched = eng_mod.ColumnScheduler(devices=["cpu"] * 3)
    for i in range(3):
        sched.admit(f"s{i}")
    front = fe.ServeFrontend(scheduler=sched)
    devs = front.lend_columns(2)
    assert len(devs) == 2 and len(sched.healthy_columns()) == 1
    survivor = sched.healthy_columns()[0]
    assert all(sched.column_of(f"s{i}") == survivor for i in range(3))
    with pytest.raises(err.InsufficientHealthyWorkers):
        front.lend_columns(1)                  # quorum of one holds
    assert front.return_columns() == sorted(
        set(range(3)) - {survivor}, reverse=True)
    assert sched.healthy_columns() == [0, 1, 2]


def test_lend_and_return_columns_as_the_reference():
    """Loads, survivors and the restore order equal the reference's for
    the same placements."""
    seen = []
    for emod, pkg, devs in ((eng_mod, fe, ["cpu"] * 4),
                            (jeng_mod, jfe, ["c0", "c1", "c2", "c3"])):
        sched = emod.ColumnScheduler(devices=devs)
        for i in range(6):
            sched.admit(f"s{i}")
        sched.release("s1")
        front = pkg.ServeFrontend(scheduler=sched)
        front.lend_columns(2)
        mid = (sched.loads(), sched.healthy_columns(),
               {f"s{i}": sched.column_of(f"s{i}") for i in (0, 2, 3, 4, 5)})
        seen.append((mid, front.return_columns(), sched.healthy_columns()))
    assert seen[0] == seen[1]


def test_withdraw_restore_guards():
    sched = eng_mod.ColumnScheduler(devices=["cpu", "cpu"])
    sched.withdraw(1)
    with pytest.raises(ValueError):
        sched.withdraw(1)                      # already withdrawn
    with pytest.raises(ValueError):
        sched.restore(0)                       # never withdrawn
    sched.restore(1)
    assert sched.healthy_columns() == [0, 1]
    sched.mark_dead(1)
    with pytest.raises(ValueError):
        sched.restore(1)


# ------------------------------------------------------ deprecation shims

def test_engine_submit_shim_warns(setup):
    eng = _engine(setup)
    with pytest.warns(DeprecationWarning, match="Engine.submit"):
        eng.submit(eng_mod.Request(0, [1, 2], max_new=1))
    assert eng.queue[0].rid == 0


def test_fault_tolerant_submit_shim_warns(setup):
    eng = _engine(setup, ft.FaultTolerantEngine, max_queue=4)
    with pytest.warns(DeprecationWarning, match="Engine.submit"):
        eng.submit(eng_mod.Request(0, [1, 2], max_new=1), ttl=10.0)
    assert 0 in eng.deadlines


def test_open_stream_shim_warns():
    sched = eng_mod.ColumnScheduler(devices=["cpu"])
    with pytest.warns(DeprecationWarning, match="open_stream"):
        sched.open_stream(stream_id="s-legacy")
    assert sched.column_of("s-legacy") == 0


# --------------------------------------------------------- error taxonomy

def test_every_serving_error_roots_at_serve_error():
    for name in err.__all__:
        cls = getattr(err, name)
        if isinstance(cls, type) and issubclass(cls, Exception):
            assert issubclass(cls, err.ServeError), name


def test_historical_import_locations_still_work():
    from repro_torch.runtime.fault import (ColumnDeadError,
                                           InsufficientHealthyWorkers,
                                           TransientDispatchError)
    from repro_torch.serve.engine import (EngineStalled,
                                          PagedCacheUnsupported,
                                          PromptTooLong)
    from repro_torch.serve.engine_fault import (ColumnHungError, QueueFull,
                                                RequestExpired)
    assert ColumnDeadError is err.ColumnDeadError
    assert InsufficientHealthyWorkers is err.InsufficientHealthyWorkers
    assert TransientDispatchError is err.TransientDispatchError
    assert EngineStalled is err.EngineStalled
    assert PromptTooLong is err.PromptTooLong
    assert PagedCacheUnsupported is err.PagedCacheUnsupported
    assert QueueFull is err.QueueFull
    assert RequestExpired is err.RequestExpired
    assert ColumnHungError is err.ColumnHungError


def test_serve_package_exports():
    import repro_torch.serve as serve

    assert serve.ServeFrontend is fe.ServeFrontend
    assert serve.PagedEngine is eng_mod.PagedEngine
    assert serve.FaultTolerantPagedEngine is ft.FaultTolerantPagedEngine
    with pytest.raises(AttributeError):
        serve.NoSuchThing
