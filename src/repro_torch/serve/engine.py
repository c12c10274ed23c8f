"""Serving engine layer. In this slice: `ColumnScheduler`, the admission
policy for continuous biosignal streams (the LM `Engine` of the
reference's `serve/engine.py` joins this file with the LM stack).

Independent streams are placed on distinct column replicas (devices),
the multi-tenant complement of dealing one stream across all columns
(`StreamConfig.n_columns`). With a `serve.stream.StreamTelemetry`
attached the scheduler is load-aware: placement by least MEASURED
windows/s (stream count is only the cold-start fallback), a `rebalance`
work-stealing pass that re-pins streams when the max/min column-load
ratio passes a threshold, and `deal_weights` feeding measured
per-column rates into the non-uniform frame deal. With a heartbeat
timeout and/or a straggler detector it also supervises column liveness
(`supervise`, `mark_dead`), the detection + drain half of
`serve/fault.py`'s closed loop.

Every decision is host arithmetic over the telemetry's numbers, the
reference's to the last comparison, so one stream of telemetry events
gives the same placements, moves and deaths in both packages
(`tests/test_torch_chaos.py`). The port's devices are `torch.device`s;
the default is every CUDA device of the host, and with no card it
raises rather than placing streams on the CPU.
"""
from __future__ import annotations

import time
import warnings

import torch

from repro_torch.device import resolve_device
from repro_torch.runtime.fault import (HeartbeatMonitor,
                                       InsufficientHealthyWorkers,
                                       StragglerDetector)

__all__ = ["ColumnScheduler", "cuda_devices"]


def cuda_devices() -> list[torch.device]:
    """Every CUDA device of the host; raises (via `resolve_device`) when
    there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [resolve_device(f"cuda:{i}") for i in range(n)] or \
        [resolve_device("cuda")]


class ColumnScheduler:
    """Admission placement of independent biosignal streams onto column
    replicas (devices) — LOAD-AWARE when given telemetry.

    Two ways to use D columns: one heavy stream deals each dispatch
    across all of them (`StreamConfig.n_columns=D`), or D independent
    streams each stay on ONE column — no halo, and every column sees the
    single-column shape. This scheduler implements the second: `admit`
    pins a new stream to the least-loaded column, `release` frees it on
    stream close. A column is an index into ``devices``; on one card
    every column may name the same device, as the reference's runner
    puts every column on its first device.

    "Least-loaded" is MEASURED when a `serve.stream.StreamTelemetry` is
    attached and warm: a column's load is the sum of its streams' EWMA
    windows/s, so a heavy sensor counts for what it actually consumes and
    a cheap one barely counts — balancing by live-stream count only when
    telemetry is cold (no inter-retire gap observed yet). Ties break by
    stream count then column index, so an idle machine still fills
    round-robin.

    `rebalance` is the work-stealing step: when the max/min column-load
    ratio exceeds ``rebalance_ratio`` it re-pins streams from the most-
    to the least-loaded column (largest mover first, only while a move
    strictly shrinks the spread) and returns the
    ``{stream_id: new_device}`` moves for the caller to apply via
    `BiosignalStream.repin`. `deal_weights` is the sharded-stream
    complement: measured per-column throughput rates as a
    `column_shares` weight vector (`StreamConfig.column_weights`), so a
    column sharing its device with another tenant is dealt fewer frames.

    RETIRE-COUNT TRIGGER: pass ``rebalance_every=N`` (windows) and the
    scheduler subscribes to its telemetry's retire feed
    (`StreamTelemetry.add_retire_listener`) — `rebalance` then runs BY
    ITSELF once N windows have retired fleet-wide since the last pass,
    instead of a host-side poller calling it on a timer. The trigger
    consumes whatever the telemetry sees: per-batch retires from the
    host-driven path or counter DRAINS from the device-resident loop
    (`serve.resident.ResidentStream` — each drain reports the windows
    retired on-device since the previous drain), so moving the steady
    state on-device keeps the closed loop closed. Triggered moves queue
    in ``pending_moves``; drain them with `pop_moves` and apply via
    `BiosignalStream.repin`.

    SUPERVISION (the fault-tolerant layer): pass ``heartbeat_timeout``
    (seconds) and/or a ``straggler`` (`runtime.fault.StragglerDetector`)
    and the scheduler watches column LIVENESS through the same retire
    feed — every retire from a placed stream beats the column's
    `runtime.fault.HeartbeatMonitor` (resident counter drains included),
    per-dispatch wall times go in via `record_batch_time`, and
    `supervise` declares a column dead on heartbeat timeout or straggler
    eviction, draining its streams onto survivors (`mark_dead`) and
    zeroing it out of `deal_weights`. The last column dying raises the
    typed `runtime.fault.InsufficientHealthyWorkers`. The requeue of a
    dead column's unretired frame ranges is the serving front-end's job
    (`serve/fault.py`).

    >>> sched = ColumnScheduler(telemetry=StreamTelemetry(),
    ...                         rebalance_every=256)
    >>> stream = BiosignalStream(app, cfg, device=sched.admit("sensor-7"))
    >>> ...  # retires accumulate; sched.pop_moves() hands back any re-pins
    """

    def __init__(self, devices=None, *, telemetry=None,
                 rebalance_ratio: float = 2.0,
                 rebalance_every: int | None = None,
                 heartbeat_timeout: float | None = None,
                 straggler: StragglerDetector | None = None,
                 clock=time.monotonic):
        self.devices = [resolve_device(d) for d in devices] \
            if devices is not None else cuda_devices()
        if not self.devices:
            raise ValueError("no devices to schedule columns on")
        if rebalance_ratio < 1.0:
            raise ValueError(f"rebalance_ratio {rebalance_ratio} < 1")
        if rebalance_every is not None and rebalance_every < 1:
            raise ValueError(f"rebalance_every {rebalance_every} < 1")
        if telemetry is None and (heartbeat_timeout is not None or
                                  rebalance_every is not None):
            raise ValueError("heartbeat supervision and the retire-count "
                             "trigger need a telemetry retire feed")
        self.telemetry = telemetry
        self.rebalance_ratio = rebalance_ratio
        self.rebalance_every = rebalance_every
        self.pending_moves: dict = {}
        self._retired_since_rebalance = 0
        self._load = [0] * len(self.devices)
        self._placement: dict = {}
        # SUPERVISION state: the retire feed doubles as the heartbeat
        # source (a column that retires work is alive — per-batch retires
        # and resident counter drains both count), per-column batch
        # times feed the straggler detector, and `supervise` turns both
        # into dead-column declarations + stream drains.
        self._clock = clock
        self.dead: set[int] = set()
        self.withdrawn: set[int] = set()   # drained for re-provisioning
        self.heartbeats = (HeartbeatMonitor(timeout_s=heartbeat_timeout)
                           if heartbeat_timeout is not None else None)
        self.straggler = straggler
        if self.heartbeats is not None:
            now = clock()
            for c in range(len(self.devices)):   # grace period from t0
                self.heartbeats.beat(c, now)
            telemetry.add_retire_listener(self._beat_on_retire)
        if rebalance_every is not None:
            telemetry.add_retire_listener(self._on_retire)

    @property
    def n_columns(self) -> int:
        return len(self.devices)

    def healthy_columns(self) -> list[int]:
        """Columns not declared dead — the only legal placement targets."""
        return [c for c in range(len(self.devices)) if c not in self.dead]

    def column_of(self, stream_id) -> int:
        return self._placement[stream_id]

    def loads(self) -> list:
        """Live-stream count per column (admission balance introspection)."""
        return list(self._load)

    def _warm(self) -> bool:
        return self.telemetry is not None and self.telemetry.warm

    def _stream_weights(self) -> dict:
        """Every placed stream's load contribution: its measured EWMA rate
        when warm. A cold (not-yet-measured) stream counts the MEAN
        warm-stream rate — the same unmeasured-is-not-zero substitution
        as `deal_weights`; a unitless placeholder against windows/s loads
        would make a burst of cold admissions nearly invisible and pile
        them onto one column. Computed in one pass (the mean once, not
        per stream)."""
        rates = {s: (self.telemetry.stream_rate(s) if self.telemetry
                     else 0.0) for s in self._placement}
        warm = [r for r in rates.values() if r > 0.0]
        mean = sum(warm) / len(warm) if warm else 1.0
        return {s: (r if r > 0.0 else mean) for s, r in rates.items()}

    def measured_loads(self) -> list[float] | None:
        """Measured windows/s demand per column (sum of the column's
        streams' EWMA rates, cold streams counted at the mean warm rate),
        or None while telemetry is cold — callers then balance by stream
        count."""
        if not self._warm():
            return None
        loads = [0.0] * len(self.devices)
        for sid, w in self._stream_weights().items():
            loads[self._placement[sid]] += w
        return loads

    def admit(self, stream_id):
        """Place a new stream; returns the device to pin it to
        (`BiosignalStream(..., device=...)`). Rate-based (least measured
        load) when telemetry is warm, least-stream-count otherwise. Dead
        columns are never placement targets; with every column dead the
        fleet cannot admit — the typed `InsufficientHealthyWorkers`."""
        if stream_id in self._placement:
            raise ValueError(f"stream {stream_id!r} already placed")
        healthy = self.healthy_columns()
        if not healthy:
            raise InsufficientHealthyWorkers(
                "every column is dead; nothing to admit onto")
        measured = self.measured_loads()
        if measured is None:
            col = min(healthy, key=lambda i: (self._load[i], i))
        else:
            col = min(healthy,
                      key=lambda i: (measured[i], self._load[i], i))
        self._load[col] += 1
        self._placement[stream_id] = col
        if self.telemetry is not None:
            self.telemetry.attach(stream_id, col)
        return self.devices[col]

    def release(self, stream_id) -> None:
        self._load[self._placement.pop(stream_id)] -= 1
        if self.telemetry is not None:
            self.telemetry.detach(stream_id)

    def _move(self, stream_id, col: int) -> None:
        old = self._placement[stream_id]
        self._load[old] -= 1
        self._load[col] += 1
        self._placement[stream_id] = col
        if self.telemetry is not None:
            self.telemetry.attach(stream_id, col)

    def _on_retire(self, stream_id, n_windows: int) -> None:
        """Telemetry retire listener: accumulate retired windows and run
        the work-stealing pass once ``rebalance_every`` of them landed —
        the retire-count trigger that replaces a host-side poller. Only
        streams this scheduler placed count toward the trigger (a foreign
        stream sharing the telemetry is not this scheduler's load)."""
        if stream_id not in self._placement:
            return
        self._retired_since_rebalance += n_windows
        if self._retired_since_rebalance >= self.rebalance_every:
            self._retired_since_rebalance = 0
            self.pending_moves.update(self.rebalance())

    def pop_moves(self) -> dict:
        """Drain the retire-triggered re-pins: {stream_id: new device},
        empty when the trigger hasn't fired (or found nothing to move).
        Callers apply each with `BiosignalStream.repin`."""
        moves, self.pending_moves = self.pending_moves, {}
        return moves

    def rebalance(self) -> dict:
        """One work-stealing pass. While the max/min column-load ratio
        exceeds ``rebalance_ratio`` (a zero-load column under a loaded one
        counts as exceeded), move the heaviest stream that strictly
        shrinks the max-min spread from the most- to the least-loaded
        column. Returns {stream_id: new device}; apply with
        `BiosignalStream.repin`."""
        moves: dict = {}
        healthy = self.healthy_columns()
        if len(healthy) < 2:
            return moves
        for _ in range(len(self._placement) or 1):
            loads = self.measured_loads()
            if loads is None:
                loads = [float(c) for c in self._load]
            hi = max(healthy, key=lambda i: (loads[i], -i))
            lo = min(healthy, key=lambda i: (loads[i], i))
            if loads[hi] <= 0.0 or \
                    (loads[lo] > 0.0 and
                     loads[hi] / loads[lo] <= self.rebalance_ratio):
                break
            weights = self._stream_weights()
            movers = sorted(
                (s for s, c in self._placement.items() if c == hi),
                key=weights.__getitem__, reverse=True)
            pick = next((s for s in movers
                         if loads[lo] + weights[s] < loads[hi]), None)
            if pick is None:        # no move shrinks the spread
                break
            self._move(pick, lo)
            moves[pick] = self.devices[lo]
        return moves

    # ------------------------------------------------------- supervision

    def _beat_on_retire(self, stream_id, n_windows: int) -> None:
        """Telemetry retire listener: a retire from one of THIS
        scheduler's streams is a heartbeat for its column — per-batch
        retires (`serve.stream.BiosignalStream._collect`) and resident
        counter drains (`serve.resident.ResidentStream._drain`) both
        land here, so moving the steady state on-device keeps the
        liveness signal alive."""
        if stream_id in self._placement:
            self.heartbeats.beat(self._placement[stream_id], self._clock())

    def record_batch_time(self, column: int, seconds: float) -> None:
        """Feed one column dispatch's wall time to the straggler
        detector (the serving analogue of a training step time)."""
        if self.straggler is not None and column not in self.dead:
            self.straggler.record(column, seconds)

    def mark_dead(self, column: int) -> dict:
        """Declare a column dead and DRAIN it: every stream pinned to it
        re-pins onto the least-loaded surviving column (the drain moves
        land in ``pending_moves`` like triggered rebalances — apply with
        `BiosignalStream.repin`). The column stops being a placement /
        rebalance / heartbeat target and its measured rate is zeroed out
        of future `deal_weights`. Raises `InsufficientHealthyWorkers`
        when the last column dies — the caller decides whether that is
        an outage or a wait-for-capacity."""
        if column in self.dead:
            return {}
        self.dead.add(column)
        if self.heartbeats is not None:
            self.heartbeats.forget(column)
        if self.straggler is not None:
            self.straggler.forget(column)
        healthy = self.healthy_columns()
        if not healthy:
            raise InsufficientHealthyWorkers(
                f"column {column} was the last healthy column")
        moves: dict = {}
        for sid, c in sorted(self._placement.items(), key=lambda kv: kv[0]):
            if c != column:
                continue
            measured = self.measured_loads()
            target = min(healthy,
                         key=(lambda i: (self._load[i], i)) if measured
                         is None else (lambda i: (measured[i],
                                                  self._load[i], i)))
            self._move(sid, target)
            moves[sid] = self.devices[target]
        self.pending_moves.update(moves)
        return moves

    def supervise(self, now: float | None = None) -> list[int]:
        """One supervision pass: declare dead every column whose
        heartbeat timed out (no retire for ``heartbeat_timeout``
        seconds) or that the straggler detector evicted (persistently
        slower than `StragglerDetector.straggler_factor` x the fleet
        median), drain each via `mark_dead`, and return the newly-dead
        columns. The closed loop is detection -> drain -> requeue ->
        re-deal; this method is the detection + drain half — the requeue
        half (unretired frame ranges onto survivors) lives in
        `serve/fault.py`."""
        suspects: list[int] = []
        if self.heartbeats is not None:
            suspects += self.heartbeats.dead(
                self._clock() if now is None else now)
        if self.straggler is not None:
            suspects += self.straggler.stragglers()
        newly = []
        for c in suspects:
            if 0 <= c < len(self.devices) and c not in self.dead:
                newly.append(c)
                self.mark_dead(c)
        return newly

    def deal_weights(self, band: float = 0.0) -> tuple | None:
        """Measured per-column throughput rates (the retire-rate EWMAs) as
        a weight vector for the non-uniform deal
        (`StreamConfig.column_weights` / `column_shares`), or None while
        telemetry is cold. A column that never retired anything gets the
        mean observed rate — unobserved is not the same as broken.

        ``band`` is the deal's deadband (same thrash-guard idea as
        ``rebalance_ratio``): columns whose measured rates differ by less
        than ``band`` (relative, walked over the rate-sorted columns) are
        considered EQUALLY capable and share their cluster's mean rate —
        EWMA jitter between identical columns must not deal them unequal
        shares; only a genuine rate gap wider than the band changes the
        deal. 0 disables it.

        DEAD columns are zeroed: a drained column's weight is exactly
        0.0 (never the stale pre-death EWMA, never the mean), so the
        degraded deal rides `column_shares`' zero-weight path and deals
        it nothing. All columns dead raises
        `InsufficientHealthyWorkers` — there is no deal to compute."""
        if self.telemetry is None:
            return None
        healthy = self.healthy_columns()
        if not healthy:
            raise InsufficientHealthyWorkers(
                "every column is dead; no deal weights to compute")
        rates = [self.telemetry.column_rate(c)
                 for c in range(len(self.devices))]
        seen = [rates[c] for c in healthy if rates[c] > 0.0]
        if not seen:
            return None
        mean = sum(seen) / len(seen)
        rates = [r if r > 0.0 else mean for r in rates]
        if band > 0.0:
            # cluster only the healthy columns: a dead column's stale
            # rate must not drag a cluster mean around
            order = sorted(healthy, key=lambda c: rates[c])
            clusters, cur = [], [order[0]]
            for c in order[1:]:
                if rates[c] <= rates[cur[0]] * (1.0 + band):
                    cur.append(c)       # within the band of the cluster
                else:                   # floor: same capability class
                    clusters.append(cur)
                    cur = [c]
            clusters.append(cur)
            for cl in clusters:
                m = sum(rates[c] for c in cl) / len(cl)
                for c in cl:
                    rates[c] = m
        for c in self.dead:
            rates[c] = 0.0
        return tuple(rates)

    # --------------------------------------------- class re-provisioning

    def withdraw(self, column: int):
        """Administratively DRAIN a column so its device can serve the
        other traffic class (the reference's unified front-end lends
        columns to the LM engine under load). Reuses the `mark_dead` drain machinery — streams re-pin onto
        survivors, the column leaves placement/heartbeat/deal targets —
        but records the column as WITHDRAWN, not failed, so `restore`
        can hand it back. Returns ``(device, moves)`` where ``moves`` is
        the `mark_dead`-style ``{stream_id: new_device}`` drain to apply
        via `BiosignalStream.repin`. Withdrawing the last healthy column
        raises `InsufficientHealthyWorkers` (the stream class keeps a
        quorum of one)."""
        if column in self.dead:
            raise ValueError(f"column {column} is already dead/withdrawn")
        if len(self.healthy_columns()) < 2:
            # checked BEFORE the drain so a refused withdraw leaves the
            # scheduler untouched (mark_dead declares first, then raises)
            raise InsufficientHealthyWorkers(
                f"column {column} is the last healthy column; "
                "cannot withdraw it for re-provisioning")
        moves = self.mark_dead(column)
        self.withdrawn.add(column)
        return self.devices[column], moves

    def restore(self, column: int) -> None:
        """Return a `withdraw`n column to the placement set: it becomes
        a placement/rebalance target again and its heartbeat restarts
        with a fresh grace period. Only withdrawn columns are
        restorable — a column that FAILED stays dead."""
        if column not in self.withdrawn:
            raise ValueError(f"column {column} was not withdrawn")
        self.withdrawn.discard(column)
        self.dead.discard(column)
        if self.heartbeats is not None:
            self.heartbeats.beat(column, self._clock())

    # ------------------------------------------------------ stream entry

    def place_stream(self, app=None, cfg=None, *, stream_id):
        """Admit + construct in one call: a `BiosignalStream` whose every
        dispatch is committed to the assigned column and (when the
        scheduler carries telemetry) reports its retires to it."""
        from repro_torch.serve.stream import BiosignalStream

        device = self.admit(stream_id)
        return BiosignalStream(app, cfg, device=device,
                               telemetry=self.telemetry,
                               stream_id=stream_id,
                               column=self._placement[stream_id])

    def open_stream(self, app=None, cfg=None, *, stream_id):
        """Deprecated name for `place_stream`, kept as the reference keeps
        it."""
        warnings.warn(
            "ColumnScheduler.open_stream is deprecated; use "
            "ColumnScheduler.place_stream",
            DeprecationWarning, stacklevel=2)
        return self.place_stream(app, cfg, stream_id=stream_id)
