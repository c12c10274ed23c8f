"""The port's fault-tolerant LM engine (`repro_torch.serve.engine_fault`)
against the JAX package's, on the CPU: the cases of
`tests/test_engine_fault.py`.

Every scenario runs one fault schedule (`FaultInjector` on a
`VirtualClock`) through both packages' engines. Greedy, the port's
tokens, its counters (`evictions`, `replays`, `decode_steps`,
`prefill_dispatches`), its poisoned `dead_slots`, its shed `expired`
requests and the virtual clock equal the reference's exactly (reduced
qwen1.5-0.5b, vocab 64, the JAX package's parameters of seed 3 carried
by `params_from_numpy`, float32 on both sides). Sampling cannot reuse the
reference's keys, so at temperature 0.8 the recovered tokens are held to
the port's own fault-free run, as the reference holds its own. The paged
variants (`FaultTolerantPagedEngine`) are included.
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
from repro.runtime.fault import StragglerDetector as JStragglerDetector
from repro.runtime.fault import Supervisor as JSupervisor
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve import engine_fault as jft
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, params_from_numpy
from repro_torch.runtime.fault import (InsufficientHealthyWorkers,
                                       StragglerDetector, Supervisor)
from repro_torch.serve import engine_fault as ft
from repro_torch.serve import fault as tfault
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.errors import EngineStalled, QueueFull, RequestExpired

SLOTS, MAX_LEN, MAX_NEW = 4, 64, 6
PROMPTS = {0: [3, 1, 4, 1], 1: [5, 9, 2], 2: [6, 5], 3: [8, 9, 7, 9, 3],
           4: [2, 3, 8], 5: [4, 6, 2, 6]}
COUNTERS = ("evictions", "replays", "decode_steps", "prefill_dispatches")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen1.5-0.5b")),
                               vocab_size=64)
    jm = j_build_model(jcfg)
    jp = j_init_model_params(jm, seed=3)
    cfg = dataclasses.replace(reduced(get_config("qwen1.5-0.5b")),
                              vocab_size=64)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(model, jax.tree.map(np.asarray, jp),
                               device="cpu")
    return model, params, (jm, jp, JEngine.compile_model(jm))


@pytest.fixture(scope="module")
def fault_free(setup):
    """The port's fault-free dense outputs {rid: tokens} by temperature."""
    cache = {}

    def get(temperature):
        if temperature not in cache:
            cache[temperature] = _serve(setup, Engine, temperature)[0]
        return cache[temperature]

    return get


def _injector(pkg, **kw):
    kw.setdefault("clock", pkg.VirtualClock())
    kw.setdefault("dispatch_s", 0.01)
    return pkg.FaultInjector(**kw)


def _serve(setup, cls, temperature, rids=tuple(PROMPTS), **kw):
    model, params, _ = setup
    eng = cls(model, params, slots=SLOTS, max_len=MAX_LEN,
              temperature=temperature, seed=7, device="cpu", **kw)
    for rid in rids:
        eng.add_request(Request(rid, list(PROMPTS[rid]), max_new=MAX_NEW))
    done = eng.run_to_completion(max_steps=500)
    assert sorted(r.rid for r in done) == sorted(rids)
    return {r.rid: tuple(r.out) for r in done}, eng


def _serve_ref(setup, cls, rids=tuple(PROMPTS), **kw):
    jm, jp, compiled = setup[2]
    eng = cls(jm, jp, slots=SLOTS, max_len=MAX_LEN, temperature=0.0,
              seed=7, compiled=compiled, **kw)
    for rid in rids:
        eng.add_request(JRequest(rid, list(PROMPTS[rid]), max_new=MAX_NEW))
    done = eng.run_to_completion(max_steps=500)
    return {r.rid: tuple(r.out) for r in done}, eng


def _state(eng) -> dict:
    return {**{c: getattr(eng, c) for c in COUNTERS},
            "dead_slots": set(eng.dead_slots),
            "expired": [r.rid for r in eng.expired]}


def _same_as_reference(setup, fault_free, temperature, *, paged=False,
                       inj=None, ref_kw=None, **kw):
    """Run the schedule ``inj`` (FaultInjector keywords) through the port
    and, greedy, through the reference; returns the port's engine."""
    inj = inj or {}
    cls = ft.FaultTolerantPagedEngine if paged else ft.FaultTolerantEngine
    injector = _injector(tfault, **inj)
    out, eng = _serve(setup, cls, temperature, injector=injector, **kw)
    assert out == fault_free(temperature)
    if temperature == 0.0:
        jcls = jft.FaultTolerantPagedEngine if paged else \
            jft.FaultTolerantEngine
        jinjector = _injector(jft, **inj)
        want, jeng = _serve_ref(setup, jcls, injector=jinjector,
                                **(ref_kw if ref_kw is not None else kw))
        assert out == want
        assert _state(eng) == _state(jeng)
        assert injector.clock() == jinjector.clock()
    return eng


# ------------------------------------------------------------ no faults

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_fault_free_matches_base_engine(setup, fault_free, temperature):
    eng = _same_as_reference(setup, fault_free, temperature,
                             heartbeat_timeout=10.0)
    assert eng.evictions == 0 and eng.replays == 0


# ---------------------------------------------------------- kill sweeps

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("slot,seq", [(0, 0), (1, 0), (0, 1), (2, 1),
                                      (0, 3), (3, 5)])
def test_killed_slot_recovers(setup, fault_free, temperature, slot, seq):
    eng = _same_as_reference(setup, fault_free, temperature,
                             inj=dict(kill={slot: seq}))
    assert eng.dead_slots == {slot}
    assert eng.evictions == 1 and eng.replays == 1


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_multi_kill_recovers(setup, fault_free, temperature):
    eng = _same_as_reference(setup, fault_free, temperature,
                             inj=dict(kill={0: 2, 2: 0, 3: 4}))
    assert eng.dead_slots == {0, 2, 3}
    assert eng.healthy_slots() == [1]


def test_replayed_request_requeued_as_the_reference(setup):
    model, params, (jm, jp, compiled) = setup
    queues = []
    for pkg, cls, req_cls, kw in (
            (tfault, ft.FaultTolerantEngine, Request,
             dict(model=model, params=params, device="cpu")),
            (jft, jft.FaultTolerantEngine, JRequest,
             dict(model=jm, params=jp, compiled=compiled))):
        eng = cls(slots=SLOTS, max_len=MAX_LEN, temperature=0.0, seed=7,
                  injector=_injector(pkg, kill={0: 1, 1: 1}), **kw)
        for rid in PROMPTS:
            eng.add_request(req_cls(rid, list(PROMPTS[rid]),
                                    max_new=MAX_NEW))
        eng.step()
        queues.append([(r.rid, r.replayed, tuple(r.out))
                       for r in eng.queue])
    assert queues[0] == queues[1]
    assert [rid for rid, _, _ in queues[0][:2]] == [0, 1]
    assert all(rep for _, rep, _ in queues[0][:2])
    assert not any(rep for _, rep, _ in queues[0][2:])


# ----------------------------------------------------------- transients

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("faults", [
    {(0, 0)},                    # at prefill
    {(1, 1)},                    # at first decode step
    {(2, 3), (2, 4)},            # two in a row mid-decode
    {(0, 0), (1, 2), (3, 3)},    # spread across slots
], ids=["prefill", "first_decode", "two_in_a_row", "spread"])
def test_transient_faults_absorbed_in_place(setup, fault_free, temperature,
                                            faults):
    eng = _same_as_reference(setup, fault_free, temperature,
                             inj=dict(transient=set(faults)))
    assert eng.evictions == 0 and eng.dead_slots == set()


def test_transient_budget_exhausted_escalates_to_eviction(setup,
                                                         fault_free):
    faults = {(0, s) for s in range(10)}
    for temperature in (0.0, 0.8):
        eng = _same_as_reference(
            setup, fault_free, temperature, inj=dict(transient=faults),
            retry=Supervisor(max_retries=2),
            ref_kw=dict(retry=JSupervisor(max_retries=2)))
        assert eng.dead_slots == {0} and eng.replays == 1


# ---------------------------------------------------------------- hangs

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("slot,seq", [(0, 0), (1, 1), (2, 4)])
def test_hung_slot_evicted_by_heartbeat_timeout(setup, fault_free,
                                                temperature, slot, seq):
    eng = _same_as_reference(setup, fault_free, temperature,
                             inj=dict(hang_from={slot: seq}),
                             heartbeat_timeout=0.1)
    assert eng.dead_slots == {slot}
    assert eng.evictions == 1 and eng.replays == 1


def test_hang_without_supervision_stalls_loudly(setup):
    model, params, _ = setup
    eng = ft.FaultTolerantEngine(
        model, params, slots=SLOTS, max_len=MAX_LEN, device="cpu",
        injector=_injector(tfault, hang_from={0: 1}))
    for rid in (0, 1):
        eng.add_request(Request(rid, list(PROMPTS[rid]), max_new=MAX_NEW))
    with pytest.raises(EngineStalled) as ei:
        eng.run_to_completion(max_steps=40)
    assert ei.value.unfinished == [0]
    assert [r.rid for r in ei.value.done] == [1]


# ------------------------------------------------------------ stragglers

def test_straggler_slot_evicted_and_replayed(setup, fault_free):
    for temperature in (0.0, 0.8):
        eng = _same_as_reference(
            setup, fault_free, temperature, inj=dict(slow={1: 0.5}),
            straggler=StragglerDetector(window=4, straggler_factor=3.0,
                                        evict_after=2),
            ref_kw=dict(straggler=JStragglerDetector(
                window=4, straggler_factor=3.0, evict_after=2)))
        assert 1 in eng.dead_slots


# -------------------------------------------------- degradation to zero

def test_all_slots_dead_raises_insufficient_healthy_workers(setup):
    model, params, _ = setup
    eng = ft.FaultTolerantEngine(
        model, params, slots=SLOTS, max_len=MAX_LEN, device="cpu",
        injector=_injector(tfault, kill={s: 0 for s in range(SLOTS)}))
    for rid in (0, 1):
        eng.add_request(Request(rid, list(PROMPTS[rid]), max_new=MAX_NEW))
    with pytest.raises(InsufficientHealthyWorkers):
        eng.run_to_completion(max_steps=100)
    assert eng.dead_slots == set(range(SLOTS))
    assert (eng.evictions, eng.replays) == (SLOTS, SLOTS)


# ------------------------------------------------- admission backpressure

def test_queue_full_rejects_typed(setup):
    model, params, _ = setup
    eng = ft.FaultTolerantEngine(model, params, slots=SLOTS,
                                 max_len=MAX_LEN, max_queue=2, device="cpu")
    eng.add_request(Request(0, [1, 2], max_new=2))
    eng.add_request(Request(1, [1, 2], max_new=2))
    with pytest.raises(QueueFull) as ei:
        eng.add_request(Request(2, [1, 2], max_new=2))
    assert (ei.value.rid, ei.value.depth, ei.value.max_queue) == (2, 2, 2)
    eng.run_to_completion()
    eng.add_request(Request(2, [1, 2], max_new=2))


def test_ttl_expiry_drops_queued_requests_typed(setup):
    model, params, _ = setup
    clk = tfault.VirtualClock()
    eng = ft.FaultTolerantEngine(
        model, params, slots=SLOTS, max_len=MAX_LEN, device="cpu",
        injector=tfault.FaultInjector(dispatch_s=1.0, clock=clk))
    for rid in range(SLOTS):            # fill every slot
        eng.add_request(Request(rid, list(PROMPTS[rid]), max_new=MAX_NEW))
    eng.add_request(Request(9, [1, 2], max_new=2), ttl=0.5)
    with pytest.raises(RequestExpired):
        eng.add_request(Request(10, [1, 2], max_new=2), ttl=0.0)
    done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == list(range(SLOTS))
    assert [r.rid for r in eng.expired] == [9]
    assert 9 not in eng.deadlines
    assert clk() == SLOTS * (1 + MAX_NEW)   # a prefill and 6 decodes each


def test_submit_shim_warns_and_forwards_ttl(setup):
    model, params, _ = setup
    eng = ft.FaultTolerantEngine(model, params, slots=SLOTS,
                                 max_len=MAX_LEN, max_queue=4, device="cpu")
    with pytest.warns(DeprecationWarning, match="Engine.submit"):
        eng.submit(Request(0, [1, 2], max_new=1), ttl=10.0)
    assert 0 in eng.deadlines


# ----------------------------------------------------- injector sharing

def test_injector_determinism_across_reset(setup, fault_free):
    inj = _injector(tfault, kill={0: 2})
    out1, e1 = _serve(setup, ft.FaultTolerantEngine, 0.8, injector=inj)
    inj.reset()
    out2, e2 = _serve(setup, ft.FaultTolerantEngine, 0.8, injector=inj)
    assert out1 == out2 == fault_free(0.8)
    assert e1.evictions == e2.evictions == 1


# ------------------------------------------------- paged + supervision

@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("slot,seq", [(1, 0), (0, 3)])
def test_paged_killed_slot_recovers(setup, fault_free, temperature, slot,
                                    seq):
    """A slot killed at prefill or mid-decode frees its pages, its request
    replays into fresh pages, and the tokens are the dense fault-free
    run's (and, greedy, the reference paged engine's, counter for
    counter)."""
    eng = _same_as_reference(setup, fault_free, temperature, paged=True,
                             inj=dict(kill={slot: seq}), page_size=8)
    assert eng.evictions == 1 and eng.replays == 1
    assert eng.pool.n_free == eng.pool.capacity


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_paged_eviction_frees_pages_for_waiting_admissions(
        setup, fault_free, temperature):
    """A small pool oversubscribed by mixed requests, a mid-decode
    eviction punching holes in it, and waiting admissions reusing the
    freed pages: the dense tokens, the pool drained to empty."""
    eng = _same_as_reference(setup, fault_free, temperature, paged=True,
                             inj=dict(kill={2: 3}), page_size=4, n_pages=13)
    assert eng.evictions == 1 and eng.replays == 1
    assert eng.peak_admitted > 0
    assert eng.pool.n_free == eng.pool.capacity


@pytest.mark.parametrize("cls", [ft.FaultTolerantEngine,
                                 ft.FaultTolerantPagedEngine],
                         ids=["dense", "paged"])
def test_supervised_engines_default_to_the_card(setup, cls):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model, params, _ = setup
    with pytest.raises(RuntimeError, match="cuda"):
        cls(model, params, slots=SLOTS, max_len=MAX_LEN)
