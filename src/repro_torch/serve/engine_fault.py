"""Fault-tolerant LM engine serving: slot supervision, deterministic
request replay, and admission backpressure (the port's counterpart of the
JAX package's `serve/engine_fault.py`).

The LM-side twin of `serve/fault.py`: the same decision layer
(`runtime/fault.py`) and the same chaos injector
(`serve/fault.py:FaultInjector`, with the engine SLOT playing the
injector's "column" role) supervise the `Engine`'s decode slots.

`FaultTolerantEngine` layers onto `serve/engine.py:Engine`'s dispatch
hooks:

* TOKEN RETIRES ARE HEARTBEATS: every token a slot retires beats its
  `runtime.fault.HeartbeatMonitor` entry. A slot is monitored from its
  admission beat until its request finishes; silence past
  ``heartbeat_timeout`` seconds declares it stuck.
* STUCK/POISONED-SLOT EVICTION: a heartbeat-timed-out or persistently
  slow slot (`runtime.fault.StragglerDetector` over per-slot dispatch
  walls) is evicted: the slot is POISONED (masked out of admission via
  `Engine.dead_slots`, never reused) and its request is requeued at the
  queue FRONT in rid order for deterministic replay.
* DETERMINISTIC REPLAY: a requeued request re-prefills its prompt PLUS
  the already-generated prefix in one dispatch and continues decoding at
  step ``len(out)``. Sampling is a per-request stream
  (`serve/engine.py:sample_per_request`, seeded by (seed, rid, step)),
  so the continuation draws the same noise wherever it lands. On the
  CPU in float32 the replayed tokens equal the fault-free run's; on the
  card the replayed K/V come from one prefill where the fault-free run
  wrote them one decode at a time, another kernel shape, so bfloat16
  continuations are close rather than equal.
* TRANSIENT RETRY: injected transients and real ``RuntimeError``s from
  the prefill/decode dispatch are retried in place with capped
  exponential backoff (`runtime.fault.Supervisor.call`); an exhausted
  retry budget escalates to slot eviction, never a lost request.
* CHAOS SURFACE: `FaultInjector` injects per-slot faults into the
  prefill and decode dispatch paths: ``kill`` at a slot's dispatch seq
  (`runtime.fault.ColumnDeadError`: poison + requeue), ``transient``
  one-shots (absorbed by retry), ``hang_from`` (`ColumnHungError`: the
  slot wedges, no retire, no heartbeat; only the heartbeat timeout
  resolves it), ``slow`` (extra virtual seconds per dispatch: straggler
  eviction). A slot's dispatch seq counts every dispatch it takes part
  in: its admission prefill is seq 0, decode steps follow, retried
  attempts count.
* ADMISSION BACKPRESSURE: the queue is bounded (``max_queue``):
  `add_request` raises the typed `QueueFull`. Requests carry a TTL
  (``ttl``/``default_ttl``): a request not admitted by its deadline is
  dropped from the queue into ``expired`` (a dead-on-arrival TTL raises
  `RequestExpired`).
* GRACEFUL DEGRADATION: every eviction shrinks the live-slot set; only
  when NO healthy slot remains with work pending does the engine raise
  the typed `runtime.fault.InsufficientHealthyWorkers`.

Every decision is host arithmetic on the engine's counters and the
injected clock, the reference's to the last comparison, so one fault
schedule gives the same evictions, replays and requeue order in both
packages (`tests/test_torch_engine_fault.py`).
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.runtime.fault import (ColumnDeadError, HeartbeatMonitor,
                                       InsufficientHealthyWorkers,
                                       StragglerDetector, Supervisor,
                                       TransientDispatchError)
from repro_torch.serve.engine import Engine, PagedEngine, Request
# QueueFull/RequestExpired live in the serve/errors.py taxonomy (ServeError
# root) and are re-exported from here, as the reference's module does
from repro_torch.serve.errors import QueueFull, RequestExpired
from repro_torch.serve.fault import (ColumnHungError, FaultInjector,
                                     VirtualClock)

__all__ = ["QueueFull", "RequestExpired", "FaultTolerantEngine",
           "FaultTolerantPagedEngine", "FaultInjector", "VirtualClock",
           "ColumnHungError"]


class FaultTolerantEngine(Engine):
    """`Engine` + the supervision closed loop (see the module docstring).

    Construction mirrors `serve/fault.py:FaultTolerantColumnRunner`:
    ``injector`` is the shared chaos `FaultInjector` (slot = the
    injector's column), ``heartbeat_timeout`` arms decode-progress
    liveness, ``straggler`` arms slow-slot eviction, ``retry`` is the
    transient-fault `runtime.fault.Supervisor` (capped exponential
    backoff; default: 3 retries, no sleep), ``clock`` the injectable time
    source (defaults to the injector's `VirtualClock` when it has one,
    else wall time). ``max_queue``/``default_ttl`` bound admission.

    >>> eng = FaultTolerantEngine(model, params, slots=4, device="cuda",
    ...                           heartbeat_timeout=5.0,
    ...                           injector=FaultInjector(kill={0: 3}))
    >>> eng.add_request(Request(0, [1, 2, 3], max_new=8))
    >>> done = eng.run_to_completion()   # every request completes
    """

    def __init__(self, model, params, *, slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0, compiled=None,
                 device="cuda", max_queue: Optional[int] = None,
                 default_ttl: Optional[float] = None,
                 heartbeat_timeout: Optional[float] = None,
                 straggler: Optional[StragglerDetector] = None,
                 injector: Optional[FaultInjector] = None,
                 retry: Optional[Supervisor] = None, clock=None, **kwargs):
        # extra kwargs flow to the next class in the MRO, so the paged
        # composition (`FaultTolerantPagedEngine`) can thread
        # page_size/n_pages through without re-declaring them here
        super().__init__(model, params, slots=slots, max_len=max_len,
                         temperature=temperature, seed=seed,
                         compiled=compiled, device=device, **kwargs)
        self.max_queue = max_queue
        self.default_ttl = default_ttl
        self.injector = injector
        self.retry = retry if retry is not None else Supervisor()
        self.clock = clock if clock is not None else (
            injector.clock if injector is not None and
            injector.clock is not None else time.monotonic)
        self.heartbeats = (HeartbeatMonitor(timeout_s=heartbeat_timeout)
                           if heartbeat_timeout is not None else None)
        self.straggler = straggler
        self.hung: set[int] = set()
        self.deadlines: dict = {}          # rid -> absolute deadline
        self.expired: list[Request] = []   # TTL-dropped while queued
        self.evictions = 0
        self.replays = 0
        self.decode_steps = 0
        self.prefill_dispatches = 0

    # ---------------------------------------------------- admission edge

    def healthy_slots(self) -> list[int]:
        """Slots not poisoned — the only legal admission targets."""
        return [s for s in range(self.slots) if s not in self.dead_slots]

    def add_request(self, req: Request, *, ttl: Optional[float] = None):
        """Bounded, TTL-aware admission. Raises `QueueFull` when the
        queue is at ``max_queue`` (backpressure — the unbounded
        ``queue.append`` is exactly what this replaces), `RequestExpired`
        for a dead-on-arrival TTL, and the base engine's `PromptTooLong`
        for a prompt the cache cannot hold. (The deprecated
        ``Engine.submit`` shim forwards here.)"""
        ttl = self.default_ttl if ttl is None else ttl
        if ttl is not None and ttl <= 0:
            raise RequestExpired(req.rid, ttl)
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            raise QueueFull(req.rid, len(self.queue), self.max_queue)
        super().add_request(req)
        if ttl is not None:
            self.deadlines[req.rid] = self.clock() + ttl

    def _expire_queued(self) -> list[Request]:
        """Drop queued requests whose deadline passed into ``expired``
        (typed shed-load accounting, not silent loss)."""
        if not self.deadlines:
            return []
        now = self.clock()
        dropped = [r for r in self.queue
                   if self.deadlines.get(r.rid, now) < now]
        if dropped:
            gone = {r.rid for r in dropped}
            self.queue = [r for r in self.queue if r.rid not in gone]
            for r in dropped:
                self.deadlines.pop(r.rid, None)
            self.expired.extend(dropped)
        return dropped

    # -------------------------------------------------- fault injection

    def _probe(self, s: int) -> str:
        """Consult the chaos injector for slot ``s``'s share of the next
        dispatch: ``"ok"``, ``"hung"`` (wedged — no result, no retire,
        no heartbeat), or ``"fault"`` (killed, or transient retry budget
        exhausted). Transients are retried through ``retry`` — each
        attempt advances the slot's injector seq, the column-runner
        convention — and the per-probe virtual wall feeds the straggler
        detector."""
        if self.injector is None:
            return "ok"
        t0 = self.clock()
        try:
            self.retry.call(self.injector.on_dispatch, s)
            return "ok"
        except ColumnHungError:
            return "hung"
        except (ColumnDeadError, TransientDispatchError):
            return "fault"
        finally:
            self._record_time(s, self.clock() - t0)

    def _record_time(self, s: int, dt: float) -> None:
        if self.straggler is not None and s not in self.dead_slots:
            self.straggler.record(s, dt)

    def _beat(self, s: int) -> None:
        if self.heartbeats is not None:
            self.heartbeats.beat(s, self.clock())

    # ------------------------------------------------------ engine hooks

    def _pre_dispatch_prefill(self, admitted: list) -> list:
        kept = []
        for s, req in admitted:
            # beat FIRST: admission registers the slot for liveness
            # monitoring, so a slot that wedges during its very first
            # prefill still times out (an unmonitored slot is neither
            # dead nor alive to `HeartbeatMonitor`)
            self._beat(s)
            status = self._probe(s)
            if status == "hung":
                self.hung.add(s)        # request occupies the slot with
                continue                # no cache effect; timeout resolves
            if status == "fault":
                self._evict(s)
                continue
            kept.append((s, req))
        return kept

    def _prefill_dispatch(self, batch):
        self.prefill_dispatches += 1
        return self.retry.call(super()._prefill_dispatch, batch)

    def _decode_dispatch(self, batch):
        # probe hung slots too: a wedged dispatch still burns virtual
        # time (`FaultInjector.on_dispatch` advances the clock before
        # raising), and that advance is what lets the heartbeat timeout
        # fire even when EVERY live slot is wedged
        for s, r in enumerate(self.live):
            if r is None:
                continue
            status = self._probe(s)
            if status == "hung":
                self.hung.add(s)
            elif status == "fault":
                self._evict(s)
        self.decode_steps += 1
        return self.retry.call(super()._decode_dispatch, batch)

    def _slot_retires(self, s: int) -> bool:
        return s not in self.hung

    def _on_retire(self, s: int, req: Request) -> None:
        self._beat(s)                   # a retired token IS a heartbeat

    def _on_finish(self, s: int, req: Request) -> None:
        if self.heartbeats is not None:
            self.heartbeats.forget(s)   # idle slots are not monitored
        self.deadlines.pop(req.rid, None)
        super()._on_finish(s, req)      # paged composition frees pages

    # -------------------------------------------------- the closed loop

    def _evict(self, s: int) -> None:
        """Poison slot ``s`` and requeue its request for replay: the slot
        leaves the admission set for good (degraded mode — the engine
        keeps serving on the survivors), monitors forget it, and its
        request goes back to the queue front carrying its generated
        prefix."""
        self.dead_slots.add(s)
        self.hung.discard(s)
        if self.heartbeats is not None:
            self.heartbeats.forget(s)
        if self.straggler is not None:
            self.straggler.forget(s)
        req = self.live[s]
        if req is not None:
            self.live[s] = None
            self.lens[s] = 0
            self._on_evict(req)   # paged composition frees stale pages
            self._requeue(req)
        self.evictions += 1

    def _requeue(self, req: Request) -> None:
        """Deterministic requeue: evicted requests re-enter at the queue
        FRONT (ahead of never-started work) in rid order among
        themselves, so the replay schedule is a pure function of the
        fault schedule."""
        req.replayed = True
        i = 0
        while (i < len(self.queue) and self.queue[i].replayed
               and self.queue[i].rid < req.rid):
            i += 1
        self.queue.insert(i, req)
        self.replays += 1

    def _supervise(self) -> list[int]:
        """Detection half of the loop: evict every slot whose heartbeat
        timed out (no token retired for ``heartbeat_timeout``) or that
        the straggler detector condemned. Returns the newly evicted
        slots; their requests are already requeued."""
        suspects: list[int] = []
        if self.heartbeats is not None:
            suspects += self.heartbeats.dead(self.clock())
        if self.straggler is not None:
            suspects += self.straggler.stragglers()
        newly = []
        for s in suspects:
            if 0 <= s < self.slots and s not in self.dead_slots:
                newly.append(s)
                self._evict(s)
        return newly

    def step(self):
        """One supervised engine step: expire stale queue entries, decode
        (with per-slot fault injection riding the dispatch hooks), then
        run the detection pass. Raises
        `runtime.fault.InsufficientHealthyWorkers` when work is pending
        and no healthy slot remains."""
        self._expire_queued()
        if not self.healthy_slots() and self._work_pending():
            raise InsufficientHealthyWorkers(
                "every engine slot is poisoned; pending requests cannot "
                "be served")
        finished = super().step()
        self._supervise()
        return finished


class FaultTolerantPagedEngine(FaultTolerantEngine, PagedEngine):
    """The paged engine under the full supervision closed loop — pure
    cooperative composition, no new code paths.

    The MRO stacks the two layers the way the hooks were designed for:
    admission runs FT's bounded/TTL `add_request` over the paged
    `InsufficientPages` check; `_prefill_dispatch`/`_decode_dispatch`
    wrap the paged fused dispatches in FT's probe/retry/counter;
    eviction (`_evict` → `_on_evict`) frees the dead slot's pages before
    the deterministic front-of-queue requeue, so a replay re-prefills
    prompt + generated prefix into FRESH pages; `_on_finish` releases
    pages after FT drops the monitors. Per-request sampling streams give
    the replayed continuation the fault-free run's noise: on the CPU in
    float32 its tokens equal both the fault-free paged run's and the
    dense run's (`tests/test_torch_engine_fault.py`); on the card they
    are close (see the module docstring).

    Accepts the union of both constructors' keyword arguments
    (``page_size``/``n_pages`` ride through `FaultTolerantEngine`'s
    ``**kwargs``)."""
