"""Fault-tolerance runtime logic: heartbeats, straggler detection, elastic
re-meshing, and a supervised retry loop with capped exponential backoff.

The port's own copy of the reference's `runtime/fault.py`: pure decision
logic with an injectable clock and ``sleep``, so one schedule of events
yields the same decisions in both packages (`tests/test_torch_fault.py`).

  * heartbeat timeout => worker declared dead;
  * straggler = worker whose step time exceeds `straggler_factor` x the
    rolling median of medians — persistent stragglers are evicted BEFORE
    they fail (tail-latency mitigation);
  * `elastic_plan` keeps the model axis fixed and shrinks the data axis
    to the largest power of two the healthy-worker count supports; too
    few healthy workers raises the typed `InsufficientHealthyWorkers`
    (never a bare ``assert``, which vanishes under ``python -O``);
  * `Supervisor.run` is restore-latest-checkpoint + deterministic replay,
    `Supervisor.call` the capped-backoff retry of one callable.

This module is the serving runtime's decision layer
(`serve/fault.py` + `serve/engine.py:ColumnScheduler.supervise`): the
stream telemetry's retire feed is the heartbeat source, per-column
dispatch times feed `StragglerDetector`, and `Supervisor.call` wraps
each stream dispatch against transient faults. The fault taxonomy is
`serve/errors.py`, re-exported here:

  * `TransientDispatchError` — retryable (the column survives);
    `Supervisor`'s default `retry_on` covers it.
  * `ColumnDeadError` — fatal for the column; deliberately NOT a
    `RuntimeError` so no retry loop can swallow it. The serving layer
    drains + requeues instead.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

# the typed taxonomy lives in serve/errors.py (ServeError root); these
# names are importable from here too, as in the reference
from repro_torch.serve.errors import (ColumnDeadError,  # noqa: F401 (re-export)
                                InsufficientHealthyWorkers,
                                TransientDispatchError)

__all__ = ["InsufficientHealthyWorkers", "TransientDispatchError",
           "ColumnDeadError", "HeartbeatMonitor", "StragglerDetector",
           "elastic_plan", "Supervisor"]


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 30.0
    _last: dict = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, t: Optional[float] = None):
        self._last[worker] = time.monotonic() if t is None else t

    def forget(self, worker: int) -> None:
        """Drop a worker from monitoring (it was drained/released);
        a forgotten worker is neither dead nor alive."""
        self._last.pop(worker, None)

    def dead(self, now: Optional[float] = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return sorted(w for w, t in self._last.items()
                      if now - t > self.timeout_s)

    def alive(self, now: Optional[float] = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return sorted(w for w, t in self._last.items()
                      if now - t <= self.timeout_s)


@dataclasses.dataclass
class StragglerDetector:
    window: int = 20
    straggler_factor: float = 2.0
    evict_after: int = 3
    _times: dict = dataclasses.field(default_factory=dict)
    _strikes: dict = dataclasses.field(default_factory=dict)

    def record(self, worker: int, step_time_s: float):
        self._times.setdefault(worker, []).append(step_time_s)
        self._times[worker] = self._times[worker][-self.window:]

    def forget(self, worker: int) -> None:
        """Drop a worker's samples + strikes (evicted/drained workers
        must not keep skewing the fleet median)."""
        self._times.pop(worker, None)
        self._strikes.pop(worker, None)

    def _median_of_medians(self) -> float:
        meds = sorted(sorted(v)[len(v) // 2] for v in self._times.values()
                      if v)
        return meds[len(meds) // 2] if meds else 0.0

    def stragglers(self) -> list[int]:
        med = self._median_of_medians()
        if med <= 0:
            return []
        out = []
        for w, v in self._times.items():
            if v and sorted(v)[len(v) // 2] > self.straggler_factor * med:
                self._strikes[w] = self._strikes.get(w, 0) + 1
                if self._strikes[w] >= self.evict_after:
                    out.append(w)
            else:
                self._strikes[w] = 0
        return sorted(out)


def elastic_plan(n_healthy_chips: int, *, model_axis: int = 16,
                 pods_of: int = 256) -> dict:
    """Largest (pod, data, model) mesh the healthy chips support.

    TP ('model') stays fixed (weight shards match it); DP shrinks to the
    largest power of two; full pods are preferred (ICI locality). Raises
    the typed `InsufficientHealthyWorkers` when the healthy count cannot
    cover even one model shard — a real error callers handle (shrink the
    model axis, wait for capacity), not an `assert` that disappears
    under ``python -O``.
    """
    if n_healthy_chips < model_axis:
        raise InsufficientHealthyWorkers(
            f"{n_healthy_chips} healthy chips cannot cover the fixed "
            f"model axis of {model_axis}")
    pods = max(1, n_healthy_chips // pods_of)
    per_pod = min(n_healthy_chips // pods, pods_of)
    data = 1
    while data * 2 * model_axis <= per_pod:
        data *= 2
    return {"pod": pods, "data": data, "model": model_axis,
            "chips": pods * data * model_axis,
            "spare": n_healthy_chips - pods * data * model_axis}


@dataclasses.dataclass
class Supervisor:
    """Wraps work in retry + recovery policies.

    Two entry points share the same (max_retries, retry_on, backoff)
    policy knobs:

    * `run` — the training-loop form: step/checkpoint/restore with
      deterministic replay. ``retries`` counts CONSECUTIVE failures and
      resets whenever the run makes NEW progress (advances past its
      prior high-water step) — transient failures spread across a long
      run must not exhaust the budget when there is progress in between,
      while a persistent fault at one step still exhausts it (a reset on
      every replayed step would retry forever).
    * `call` — the serving-dispatch form: retry one callable on
      ``retry_on`` with capped exponential backoff
      (``backoff_base_s * backoff_factor**attempt``, clamped to
      ``backoff_cap_s``; base 0 disables sleeping). The streaming
      dispatch path wraps transient faults in this
      (`serve/stream.py:BiosignalStream`).

    ``retry_on`` is the configurable exception tuple: only those types
    are retried, everything else propagates. The default covers
    `RuntimeError` (and therefore `TransientDispatchError`);
    `ColumnDeadError` is not a `RuntimeError` precisely so the default
    never swallows a death. ``sleep`` is injectable for tests.
    """
    save_fn: Optional[Callable] = None     # (state, step) -> None
    restore_fn: Optional[Callable] = None  # (step) -> state
    ckpt_every: int = 100
    max_retries: int = 3
    retry_on: tuple = (RuntimeError,)
    backoff_base_s: float = 0.0
    backoff_factor: float = 2.0
    backoff_cap_s: float = 30.0
    sleep: Callable = time.sleep

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (0-based): capped exponential."""
        return min(self.backoff_base_s * self.backoff_factor ** attempt,
                   self.backoff_cap_s)

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` with up to ``max_retries`` retries on ``retry_on``
        failures, sleeping `backoff_s(attempt)` between attempts. The
        last failure re-raises."""
        for attempt in range(self.max_retries + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on:
                if attempt >= self.max_retries:
                    raise
                delay = self.backoff_s(attempt)
                if delay > 0:
                    self.sleep(delay)

    def run(self, state, step_fn, batches, n_steps: int, *, start_step: int = 0,
            inject_failure: Optional[Callable] = None):
        """Deterministic replay: on failure, restore the last checkpoint and
        re-run from its step. `inject_failure(step)` raising simulates a
        node loss (tests). Consecutive-failure budget: ``retries`` resets
        whenever the run advances past its previous high-water step —
        not just on checkpoint boundaries — so a long run survives any
        number of transient failures as long as each recovery makes NEW
        progress. Replayed steps below the high-water mark do not reset
        the counter: a persistent fault at one step must exhaust the
        budget, not loop forever on restore/replay/reset."""
        assert self.save_fn is not None and self.restore_fn is not None, \
            "Supervisor.run needs save_fn/restore_fn (call() does not)"
        step = start_step
        last_ckpt = start_step
        high_water = start_step
        retries = 0
        metrics = None
        while step < n_steps:
            try:
                if inject_failure is not None:
                    inject_failure(step)
                state, metrics = step_fn(state, batches(step))
                step += 1
                if step > high_water:
                    high_water = step
                    retries = 0
                if step % self.ckpt_every == 0:
                    self.save_fn(state, step)
                    last_ckpt = step
            except self.retry_on:
                retries += 1
                if retries > self.max_retries:
                    raise
                state = self.restore_fn(last_ckpt)
                step = last_ckpt
        return state, step, metrics
