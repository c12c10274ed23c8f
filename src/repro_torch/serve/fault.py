"""Fault-tolerant column serving: heartbeats, dead-column drain, and
deterministic requeue.

The flexibility claim behind column replication only holds if columns are
INTERCHANGEABLE — and interchangeable must include "one of them died
mid-stream". This module connects the decision logic of
`runtime/fault.py` (heartbeat timeout, straggler eviction, capped-backoff
retry) to the streaming runtime (`serve/stream.py`, `serve/resident.py`,
`serve/engine.py:ColumnScheduler`), as the reference's `serve/fault.py`
does:

* the telemetry retire feed is the HEARTBEAT source — every per-batch
  retire and every resident counter drain beats the column's
  `runtime.fault.HeartbeatMonitor`;
* per-column dispatch wall times feed `runtime.fault.StragglerDetector`,
  so a persistently slow column is evicted BEFORE it fails;
* a dead column's streams DRAIN onto survivors
  (`ColumnScheduler.mark_dead`) and its *unretired* hop-aligned frame
  ranges REQUEUE across them (`kernels/pipeline/shard.py:requeue_ranges`)
  under the degraded deal (`ColumnScheduler.deal_weights`, dead columns
  zeroed);
* transient dispatch failures are retried in place with capped
  exponential backoff (`runtime.fault.Supervisor.call`), never escalated
  to a death.

THE INVARIANT: for any injected fault schedule the recovered output is
**bit-identical** to the fault-free run, only redistributed across
surviving columns — every unit of requeued work is a hop-aligned frame
range, and frame i depends only on samples ``[i*hop, i*hop + window)``.

`FaultInjector` is the chaos harness: a deterministic schedule keyed by
(column, that column's dispatch or drain sequence number), which the
streams consult before each dispatch (`BiosignalStream`) and at each
counter drain (`ResidentStream._drain`). The port counts the same events
as the reference, so one schedule kills at the same points in both
packages (`tests/test_torch_chaos.py`).

On a card each column's dispatch wall includes its kernels: the batch
path's `process` waits on each batch's event before it returns, and the
resident path reads its retire counters back (`_drain`) inside the
timed dispatch.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

from repro_torch.core.biosignal import make_app
from repro_torch.device import resolve_device
from repro_torch.kernels.pipeline.kernel import empty_outputs
from repro_torch.kernels.pipeline.shard import column_shares, requeue_ranges
from repro_torch.runtime.fault import (ColumnDeadError, StragglerDetector,
                                       Supervisor, TransientDispatchError)
from repro_torch.serve.engine import ColumnScheduler
from repro_torch.serve.errors import ColumnHungError
from repro_torch.serve.resident import ResidentConfig, ResidentStream
from repro_torch.serve.stream import (BiosignalStream, StreamConfig,
                                      StreamTelemetry, frame_count,
                                      stream_signal)

__all__ = ["VirtualClock", "ColumnHungError", "FaultInjector",
           "FaultTolerantColumnRunner"]


class VirtualClock:
    """A deterministic monotonic clock tests advance by hand —
    the injectable time source `FaultInjector`, `StreamTelemetry`, and
    `ColumnScheduler` share so heartbeat timeouts and EWMA math replay
    exactly."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault schedule for the chaos harness.

    Faults are keyed by ``(column, seq)`` where ``seq`` is the
    per-column DISPATCH sequence number (0-based, incremented on every
    `on_dispatch` call — retried attempts count, so "two transient
    failures then success" is entries at seq s and s+1). Drain faults
    use the separate per-column DRAIN counter (`on_drain`, one tick per
    telemetry drain point of the resident path).

    * ``kill[column] = seq`` — the dispatch raises
      `runtime.fault.ColumnDeadError` (fatal; the serving layer drains
      and requeues).
    * ``kill_drain[column] = seq`` — the column dies at that counter
      DRAIN instead: the resident loop's outputs are lost with the
      column, but earlier drains already fed the telemetry — the "death
      mid-resident-sweep" scenario.
    * ``transient`` — set of ``(column, seq)`` dispatches that raise
      `runtime.fault.TransientDispatchError` (retryable; the stream's
      `runtime.fault.Supervisor.call` backoff absorbs them).
    * ``hang_from[column] = seq`` — from that dispatch on, the column is
      wedged (`ColumnHungError`): no result, no retire, no heartbeat.
      Requires heartbeat supervision (or a real wall-clock) to resolve.
    * ``slow[column] = extra_s`` — every dispatch on the column takes
      ``extra_s`` extra virtual seconds (straggler simulation).

    ``dispatch_s`` is the virtual cost of a healthy dispatch; when
    ``clock`` (a `VirtualClock`) is set, every `on_dispatch` advances it
    by ``dispatch_s + slow.get(column, 0)`` so heartbeat timeouts and
    straggler medians replay deterministically. `reset` rewinds the
    sequence counters (NOT the clock) so one schedule can be replayed
    across bench reps.
    """
    kill: dict = dataclasses.field(default_factory=dict)
    kill_drain: dict = dataclasses.field(default_factory=dict)
    transient: set = dataclasses.field(default_factory=set)
    hang_from: dict = dataclasses.field(default_factory=dict)
    slow: dict = dataclasses.field(default_factory=dict)
    dispatch_s: float = 0.0
    clock: VirtualClock | None = None
    _seq: dict = dataclasses.field(default_factory=dict)
    _drain_seq: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self._seq.clear()
        self._drain_seq.clear()

    def on_dispatch(self, column: int) -> None:
        seq = self._seq.get(column, 0)
        self._seq[column] = seq + 1
        if self.clock is not None:
            self.clock.advance(self.dispatch_s +
                               float(self.slow.get(column, 0.0)))
        if column in self.hang_from and seq >= self.hang_from[column]:
            raise ColumnHungError(column)
        if self.kill.get(column) == seq:
            raise ColumnDeadError(column)
        if (column, seq) in self.transient:
            raise TransientDispatchError(
                f"injected transient fault on column {column} seq {seq}")

    def on_drain(self, column: int) -> None:
        seq = self._drain_seq.get(column, 0)
        self._drain_seq[column] = seq + 1
        if self.kill_drain.get(column) == seq:
            raise ColumnDeadError(
                column, f"column {column} died at drain {seq}")


class FaultTolerantColumnRunner:
    """Drives ONE signal across D columns with fault-tolerant requeue —
    the serving front-end of the detection → drain → requeue → re-deal
    closed loop.

    The signal's frames are dealt into hop-aligned per-column ranges
    (`column_shares` exact-sum equal deal, or ``weights``), each range
    dispatched through the column's pinned stream — a
    `serve.stream.BiosignalStream` per range of ``cfg.batch_windows``
    frames (``mode="batch"``), or a `serve.resident.ResidentStream`
    covering the whole share in ring sweeps (``mode="resident"``). After
    every dispatch round `ColumnScheduler.supervise` runs: a column is
    declared dead on `runtime.fault.ColumnDeadError`, heartbeat timeout
    (the retire feed went quiet), or straggler eviction; its streams
    drain and its UNRETIRED ranges requeue across survivors via
    `requeue_ranges` under the degraded `ColumnScheduler.deal_weights`
    (dead columns zeroed; equal weights while telemetry is cold). The
    last column dying raises
    `runtime.fault.InsufficientHealthyWorkers`.

    `process` returns the full framed output dict, bit-identical to the
    fault-free single-column reference for ANY injected fault schedule
    (the chaos property). ``column_busy`` holds per-column busy seconds
    (sum of dispatch walls) — ``max(column_busy)`` is the modelled
    dispatch wall on a D-device machine, the quantity the reference's
    ``--check-fault`` bench gate bounds at 1.5x the fault-free run.

    ``devices`` (one per column) defaults to the card for every column,
    as the reference puts every column on its first device; with no card
    that raises.
    """

    def __init__(self, app=None,
                 cfg: StreamConfig | None = None, *, n_columns: int,
                 mode: str = "batch", rcfg: ResidentConfig | None = None,
                 injector: FaultInjector | None = None,
                 weights=None, deal_band: float = 0.0,
                 heartbeat_timeout: float | None = None,
                 straggler: StragglerDetector | None = None,
                 retry: Supervisor | None = None, devices=None, clock=None,
                 max_idle_passes: int = 10_000):
        if n_columns < 1:
            raise ValueError(f"n_columns must be >= 1, got {n_columns}")
        if mode not in ("batch", "resident"):
            raise ValueError(f"mode {mode!r}")
        if devices is None:
            devices = [resolve_device("cuda")] * n_columns
        self.app = app if app is not None else make_app(device=devices[0])
        self.cfg = cfg or StreamConfig()
        if self.cfg.n_columns != 1:
            raise ValueError("the runner deals ranges itself; streams stay "
                             "column-pinned (cfg.n_columns == 1)")
        self.mode = mode
        self.rcfg = rcfg or ResidentConfig()
        self.injector = injector
        self.weights = weights
        self.deal_band = deal_band
        self.max_idle_passes = max_idle_passes
        self.clock = clock if clock is not None else (
            injector.clock if injector is not None and
            injector.clock is not None else time.perf_counter)
        self.telemetry = StreamTelemetry(clock=self.clock)
        self.scheduler = ColumnScheduler(
            devices, telemetry=self.telemetry,
            heartbeat_timeout=heartbeat_timeout, straggler=straggler,
            clock=self.clock)
        # one pinned stream per column: an idle scheduler admits
        # round-robin, so stream "col d" lands on column d exactly
        self.streams = {}
        for d in range(n_columns):
            sid = f"col{d}"
            device = self.scheduler.admit(sid)
            common = dict(telemetry=self.telemetry, stream_id=sid,
                          column=d, injector=injector, retry=retry)
            self.streams[d] = (
                BiosignalStream(self.app, self.cfg, device=device, **common)
                if mode == "batch" else
                ResidentStream(self.app, self.cfg, self.rcfg,
                               device=device, **common))
        self.column_busy = [0.0] * n_columns
        self.dispatches = 0
        self.requeues = 0

    @property
    def n_columns(self) -> int:
        return len(self.streams)

    def live_columns(self) -> list[int]:
        return self.scheduler.healthy_columns()

    # ------------------------------------------------------------ deal

    def _initial_queues(self, n_frames: int) -> list[deque]:
        """Deal frames into per-column queues of hop-aligned ranges:
        batch mode splits a column's contiguous share into
        ``batch_windows``-frame dispatch ranges; resident mode keeps the
        share whole (the ring loop iterates it on-device)."""
        w = self.weights if self.weights is not None \
            else (1.0,) * self.n_columns
        shares = column_shares(n_frames, self.n_columns, w)
        queues = [deque() for _ in range(self.n_columns)]
        start = 0
        bw = self.cfg.batch_windows
        for d, share in enumerate(shares):
            if self.mode == "resident":
                if share:
                    queues[d].append((start, share))
            else:
                for s in range(start, start + share, bw):
                    queues[d].append((s, min(bw, start + share - s)))
            start += share
        return queues

    def _degraded_weights(self) -> list[float]:
        """The re-deal weight vector for requeued work: measured column
        rates with dead columns zeroed (`ColumnScheduler.deal_weights`),
        or the equal deal over survivors while telemetry is cold."""
        measured = self.scheduler.deal_weights(band=self.deal_band)
        if measured is not None:
            return list(measured)
        return [0.0 if c in self.scheduler.dead else 1.0
                for c in range(self.n_columns)]

    def _requeue_from(self, column: int, queues: list[deque]) -> None:
        """Drain a dead column's queue and deal its unretired ranges
        across the survivors (hop-aligned splits, degraded weights)."""
        unretired = list(queues[column])
        queues[column].clear()
        if not unretired:
            return
        parts = requeue_ranges(unretired, self.n_columns,
                               self._degraded_weights())
        for d, runs in enumerate(parts):
            queues[d].extend(runs)
        self.requeues += 1

    # -------------------------------------------------------- dispatch

    def _chunk(self, sig, start: int, count: int):
        cfg = self.cfg
        s0 = start * cfg.hop
        return sig[s0: s0 + (count - 1) * cfg.hop + cfg.window]

    def _dispatch(self, column: int, sig, start: int, count: int) -> dict:
        out = self.streams[column].process(self._chunk(sig, start, count))
        self.dispatches += 1
        return out

    # ---------------------------------------------------------- serve

    def process(self, signal) -> dict:
        """All framed outputs for ``signal`` under the injected fault
        schedule — bit-identical to the fault-free run. Raises
        `runtime.fault.InsufficientHealthyWorkers` if every column dies,
        and RuntimeError if the fleet stops progressing without a
        supervisable cause (a hung column with no heartbeat timeout)."""
        cfg = self.cfg
        sig = stream_signal(signal, self.scheduler.devices[0])
        n = frame_count(sig.shape[0], cfg.window, cfg.hop)
        if n == 0:
            w = self.app.svm_w.shape
            return empty_outputs(cfg.window, w[0], w[1], sig.dtype,
                                 cfg.outputs, sig.device)
        queues = self._initial_queues(n)
        results: dict[int, tuple[int, dict]] = {}
        idle = 0
        while True:
            pending = [d for d in self.live_columns() if queues[d]]
            if not pending:
                break
            progressed = False
            for d in pending:
                if d in self.scheduler.dead:    # died earlier this round
                    continue
                start, count = queues[d][0]
                t0 = self.clock()
                try:
                    out = self._dispatch(d, sig, start, count)
                except ColumnHungError:
                    continue        # wedged: no retire — only the
                    #                 heartbeat timeout can resolve this
                except ColumnDeadError:
                    self.scheduler.mark_dead(d)
                    self._requeue_from(d, queues)
                    continue
                dt = self.clock() - t0
                queues[d].popleft()
                results[start] = (count, out)
                self.column_busy[d] += dt
                self.scheduler.record_batch_time(d, dt)
                progressed = True
            newly = self.scheduler.supervise()
            for d in newly:
                self._requeue_from(d, queues)
            if progressed or newly:
                idle = 0
            else:
                idle += 1
                if idle > self.max_idle_passes:
                    raise RuntimeError(
                        "fleet stopped progressing (hung column without "
                        "heartbeat supervision?)")
        # assemble: the requeued ranges must tile [0, n) exactly once
        items = sorted(results.items())
        pos = 0
        for start, (count, _) in items:
            if start != pos:
                break
            pos += count
        if pos != n:
            raise RuntimeError(f"retired ranges do not tile the {n} frames "
                               f"(gap or overlap at frame {pos})")
        outs = [out for _, (_, out) in items]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
