"""The port's fault-tolerance decision layer (`repro_torch.runtime.fault`)
and error taxonomy (`repro_torch.serve.errors`) against the JAX
package's, on the CPU.

Both are pure host logic, so every case of `tests/test_fault.py` runs
through BOTH packages on the same script of events — the same injected
times, the same failures, the same recording ``sleep`` — and the two must
take the same decisions: the same dead and alive workers, the same
stragglers, the same elastic plans and typed errors, the same retries,
sleeps and replayed states. Cases of `tests/test_fault.py` that probe one
mechanism with different scripts are merged as parametrised cases. The
taxonomy must match class for class: names, the names of the bases, and
what the constructors carry.
"""
import pytest

from repro.runtime import fault as jfault
from repro.serve import errors as jerrors
from repro_torch.runtime import fault as tfault
from repro_torch.serve import errors as terrors

PKGS = {"jax": jfault, "torch": tfault}


def both(scenario):
    """``scenario(fault_module)`` in each package; the results must be
    equal. Returns the port's."""
    got = {name: scenario(mod) for name, mod in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ------------------------------------------------------------ heartbeats

@pytest.mark.parametrize("timeout,script,want", [
    # the timeout is STRICT: exactly timeout_s of silence is still alive;
    # a fresh beat resurrects the worker before anyone observed it dead
    (10.0, [("beat", 0, 100.0), ("dead", 110.0), ("alive", 110.0),
            ("dead", 110.0 + 1e-9), ("beat", 0, 111.0), ("dead", 120.0)],
     [None, [], [0], [0], None, []]),
    # forgotten != dead; forgetting an unknown worker is a no-op
    (5.0, [("beat", 0, 0.0), ("beat", 1, 0.0), ("forget", 0),
           ("alive", 1.0), ("dead", 100.0), ("forget", 99)],
     [None, None, None, [1], [1], None]),
])
def test_heartbeat_decisions(timeout, script, want):
    def run(fault):
        hb = fault.HeartbeatMonitor(timeout_s=timeout)
        out = []
        for op, *args in script:
            if op == "beat":
                out.append(hb.beat(args[0], t=args[1]))
            elif op == "forget":
                out.append(hb.forget(args[0]))
            else:
                out.append(getattr(hb, op)(now=args[0]))
        return out

    assert both(run) == want


# ------------------------------------------------------------ stragglers

@pytest.mark.parametrize("kw,script,want", [
    # strikes 1 and 2 are below the threshold; strike 3 evicts
    (dict(straggler_factor=2.0, evict_after=3),
     [("record", w, 1.0 if w != 3 else 5.0) for w in range(4)]
     + [("stragglers",)] * 3, [[], [], [3]]),
    # the worker recovers: fast samples push the slow one out of the
    # rolling window and the strike counter resets to zero
    (dict(window=4, straggler_factor=2.0, evict_after=2),
     [("record", w, 1.0) for w in range(3)] + [("record", 3, 9.0),
                                               ("stragglers",)]
     + [("record", 3, 1.0)] * 4 + [("stragglers",)] * 2, [[], [], []]),
    # a forgotten worker has no sample left to strike on
    (dict(straggler_factor=2.0, evict_after=1),
     [("record", w, 1.0) for w in range(3)] + [("record", 3, 9.0),
                                               ("forget", 3),
                                               ("stragglers",)], [[]]),
    # median of medians over uneven windows, then a recovery mid-run
    (dict(window=3, straggler_factor=1.5, evict_after=2),
     [("record", 0, 1.0), ("record", 1, 1.2), ("record", 2, 2.5),
      ("stragglers",), ("record", 2, 2.0), ("stragglers",),
      ("record", 2, 0.5), ("record", 2, 0.5), ("stragglers",),
      ("stragglers",)], [[], [2], [], []]),
])
def test_straggler_decisions(kw, script, want):
    def run(fault):
        det = fault.StragglerDetector(**kw)
        out = []
        for op, *args in script:
            res = getattr(det, op)(*args)
            if op == "stragglers":
                out.append(res)
        return out

    assert both(run) == want


# ---------------------------------------------------------- elastic plan

@pytest.mark.parametrize("chips,model_axis,pods_of", [
    (15, 16, 256), (16, 16, 256), (80, 16, 256), (512, 16, 256),
    (1000, 8, 256), (12, 8, 256), (3, 4, 256), (700, 16, 128)])
def test_elastic_plan_decisions(chips, model_axis, pods_of):
    def run(fault):
        try:
            return fault.elastic_plan(chips, model_axis=model_axis,
                                      pods_of=pods_of)
        except fault.InsufficientHealthyWorkers as e:
            return ("raised", str(e))

    plan = both(run)
    if chips < model_axis:
        assert plan[0] == "raised"
    else:
        assert plan["chips"] == plan["pod"] * plan["data"] * plan["model"]
        assert plan["data"] & (plan["data"] - 1) == 0


def test_elastic_plan_caller_can_degrade_on_typed_error():
    def run(fault):
        model_axis = 16
        while True:
            try:
                return fault.elastic_plan(12, model_axis=model_axis)
            except fault.InsufficientHealthyWorkers:
                model_axis //= 2

    plan = both(run)
    assert plan["model"] == 8 and plan["chips"] <= 12


# ------------------------------------------------------- Supervisor.run

def _run_supervised(fault, failures, *, n_steps, ckpt_every,
                    max_retries=3, retry_on=None, exc=RuntimeError,
                    step_fn=lambda s, b: (s + b, {}),
                    batches=lambda s: 1.0):
    """Supervisor.run with ``failures`` (step -> times it fails); returns
    (state, step) or the raised type's name with the steps attempted."""
    store = {0: 0.0}
    attempts = []
    left = dict(failures)

    def inject(step):
        attempts.append(step)
        if left.get(step, 0) > 0:
            left[step] -= 1
            raise exc(f"lost at {step}")

    kw = {} if retry_on is None else {"retry_on": retry_on}
    sup = fault.Supervisor(save_fn=lambda s, k: store.__setitem__(k, s),
                           restore_fn=lambda k: store.get(k, 0.0),
                           ckpt_every=ckpt_every, max_retries=max_retries,
                           **kw)
    try:
        state, step, _ = sup.run(0.0, step_fn, batches, n_steps,
                                 inject_failure=inject)
        return ("done", state, step, attempts)
    except Exception as e:              # the decision under test
        return ("raised", type(e).__name__, attempts)


@pytest.mark.parametrize("case,kw,want", [
    # retries reset on any NEW progress: four failures in one checkpoint
    # interval with progress between them do not exhaust max_retries=3
    ("reset_on_progress", dict(failures={3: 1, 5: 1, 7: 1, 9: 1},
                               n_steps=12, ckpt_every=100),
     ("done", 12.0, 12)),
    # a persistent fault at one step exhausts the budget
    ("persistent", dict(failures={2: 99}, n_steps=5, ckpt_every=100,
                        max_retries=2), ("raised", "RuntimeError")),
    # only retry_on is retried: a ValueError propagates by default ...
    ("not_retryable", dict(failures={1: 99}, n_steps=4, ckpt_every=2,
                           exc=ValueError), ("raised", "ValueError")),
    # ... and is retried once configured
    ("retryable", dict(failures={1: 1}, n_steps=4, ckpt_every=2,
                       exc=ValueError, retry_on=(ValueError,)),
     ("done", 4.0, 4)),
])
def test_supervisor_run_decisions(case, kw, want):
    got = both(lambda fault: _run_supervised(fault, **kw))
    assert got[:len(want)] == want


def test_supervisor_restore_replay_is_deterministic():
    """Replay from checkpoint is exact: a crashy run's state equals the
    fault-free run's, in both packages."""
    kw = dict(n_steps=17, ckpt_every=4, step_fn=lambda s, b: (s * 1.5 + b,
                                                              {}),
              batches=lambda step: float(step % 3 + 1))
    clean = both(lambda f: _run_supervised(f, {}, **kw))
    crashy = both(lambda f: _run_supervised(f, {5: 1, 6: 1, 13: 1}, **kw))
    assert crashy[1:3] == clean[1:3]
    assert crashy[3] != clean[3]        # the replayed steps ran again


# ------------------------------------------------------ Supervisor.call

@pytest.mark.parametrize("kw,fails,exc,want", [
    # exponential 1, 2, 4, 8 clamped at the 3 s cap, success on try 5
    (dict(max_retries=4, backoff_base_s=1.0, backoff_factor=2.0,
          backoff_cap_s=3.0), 4, "transient",
     ("ok", 5, [1.0, 2.0, 3.0, 3.0])),
    # the last failure re-raises after max_retries retries
    (dict(max_retries=2), 99, "transient",
     ("TransientDispatchError", 3, [])),
    # a column death is not a RuntimeError: never retried by default
    (dict(max_retries=5, retry_on=None), 99, "dead",
     ("ColumnDeadError", 1, [])),
    # base 0 disables sleeping
    (dict(max_retries=3, backoff_base_s=0.0), 2, "transient",
     ("ok", 3, [])),
])
def test_supervisor_call_decisions(kw, fails, exc, want):
    def run(fault):
        sleeps, calls = [], []
        opts = dict(kw)
        if opts.pop("retry_on", True) is not None:
            opts["retry_on"] = (fault.TransientDispatchError,)

        def flaky():
            calls.append(1)
            if len(calls) <= fails:
                raise (fault.TransientDispatchError("flaky")
                       if exc == "transient" else fault.ColumnDeadError(2))
            return "ok"

        sup = fault.Supervisor(sleep=sleeps.append, **opts)
        try:
            res = sup.call(flaky)
        except Exception as e:
            res = type(e).__name__
        return res, len(calls), sleeps

    assert both(run) == want


# ------------------------------------------------------------- taxonomy

@pytest.mark.parametrize("name", jerrors.__all__)
def test_error_classes_match_reference(name):
    want, got = getattr(jerrors, name), getattr(terrors, name)
    assert [c.__name__ for c in got.__mro__] == \
        [c.__name__ for c in want.__mro__]
    assert name in terrors.__all__


def test_error_payloads_and_reexports_match_reference():
    cases = [("PromptTooLong", (7, 300, 256)), ("EngineStalled", ([1, 2],)),
             ("QueueFull", (3, 8, 8)), ("RequestExpired", (4, 1.5)),
             ("ColumnDeadError", (2,)), ("ColumnHungError", (1,)),
             ("InsufficientPages", (5, 2, 16)), ("TicketNotReady", (9, "q"))]
    for name, args in cases:
        j, t = getattr(jerrors, name)(*args), getattr(terrors, name)(*args)
        assert str(t) == str(j) and vars(t) == vars(j), name
    for name in jfault.__all__:                  # runtime.fault's names
        assert getattr(tfault, name).__name__ == \
            getattr(jfault, name).__name__
    assert not issubclass(terrors.ColumnDeadError, RuntimeError)
    assert issubclass(terrors.TransientDispatchError, RuntimeError)
