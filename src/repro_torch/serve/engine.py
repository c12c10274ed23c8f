"""Serving engine layer: the LM `Engine`, continuous-batching decode over
fixed slots, its paged twin `PagedEngine`, and `ColumnScheduler`, the
admission policy for continuous biosignal streams — the reference's
`serve/engine.py`, in PyTorch.

`Engine`: requests occupy slots of a fixed-capacity batch; each engine
step decodes one token for every slot (one batched decode call — free
slots ride along). Admission claims every free slot, then runs one padded
prefill per prompt-length bucket; the new cache rows of the admitted
slots are merged into the live cache by the schema's named "batch" axis.
Greedy decoding is an argmax; temperature sampling draws each token from
the request's OWN stream, a `torch.Generator` seeded by (engine seed,
rid, token index) (`sample_per_request`), so a request's tokens are a
function of (seed, rid, prompt, model) and never of its slot, its
co-tenants or the engine step — the invariant replay after an eviction
rests on. (The reference's ``fold_in`` keys cannot be reproduced in
torch; greedy tokens are the reference's exactly.) The dispatch path is
factored into the reference's overridable hooks (`_admissible`,
`_pre_dispatch_prefill`, `_prefill_dispatch`, `_decode_dispatch`,
`_slot_retires`, `_on_retire`, `_on_finish`, `_on_evict`) for a
supervision layer (`serve/engine_fault.py`). An encoder-decoder model
(whisper) admits token at a time through decode, as the reference's.
Typed errors at the admission boundary: `PromptTooLong` at
`add_request`, `EngineStalled` from `run_to_completion`.

`PagedEngine`: the same engine over a paged KV cache (`serve/paged.py`),
admission bounded by free pages instead of slots.

`ColumnScheduler`: independent streams are placed on distinct column
replicas (devices), the multi-tenant complement of dealing one stream
across all columns (`StreamConfig.n_columns`). With a
`serve.stream.StreamTelemetry` attached the scheduler is load-aware:
placement by least MEASURED windows/s (stream count is only the
cold-start fallback), a `rebalance` work-stealing pass that re-pins
streams when the max/min column-load ratio passes a threshold, and
`deal_weights` feeding measured per-column rates into the non-uniform
frame deal. With a heartbeat timeout and/or a straggler detector it also
supervises column liveness (`supervise`, `mark_dead`), the detection +
drain half of `serve/fault.py`'s closed loop.

Every scheduler decision is host arithmetic over the telemetry's
numbers, the reference's to the last comparison, so one stream of
telemetry events gives the same placements, moves and deaths in both
packages (`tests/test_torch_chaos.py`). The port's devices are
`torch.device`s; the default is every CUDA device of the host, and with
no card it raises rather than placing streams on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.device import cuda_devices, resolve_device
from repro_torch.models.api import cast_params, init_cache
from repro_torch.models.layers import (tree_from_items, tree_items,
                                       tree_map)
from repro_torch.runtime.fault import (HeartbeatMonitor,
                                       InsufficientHealthyWorkers,
                                       StragglerDetector)
from repro_torch.serve import paged
from repro_torch.serve.errors import (EngineStalled, InsufficientPages,
                                      PagedCacheUnsupported,  # noqa: F401
                                      PromptTooLong)

__all__ = ["Request", "Engine", "PagedEngine", "sample_per_request",
           "ColumnScheduler", "cuda_devices"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int = 16
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # set by a supervision layer when the request was evicted from a
    # faulty slot and requeued for replay
    replayed: bool = False


def _stream_seed(seed: int, rid: int, step: int) -> int:
    """A fixed 64-bit mix of (engine seed, rid, token index)."""
    words = np.random.SeedSequence(
        [int(v) % 2 ** 64 for v in (seed, rid, step)]).generate_state(2)
    return int(words[0]) | int(words[1]) << 32


def sample_per_request(seed: int, rids, steps, logits):
    """Per-request-stream categorical sample of each row of ``logits``
    ((n, V), already divided by the temperature) by the Gumbel-max rule:
    row r takes argmax(logits[r] + g), g drawn in float64 on the CPU from
    a `torch.Generator` seeded by (seed, rids[r], steps[r]) and moved to
    the logits' device. ``steps[r]`` is the token's index WITHIN its
    request, so a draw depends only on (seed, rid, step) and the row's
    logits."""
    V = logits.shape[-1]
    noise = []
    for rid, step in zip(rids, steps):
        g = torch.Generator().manual_seed(_stream_seed(seed, rid, step))
        u = torch.rand(V, generator=g, dtype=torch.float64)
        noise.append(-torch.log(-torch.log(u)))
    noise = torch.stack(noise).to(device=logits.device, dtype=torch.float32)
    return torch.argmax(logits.float() + noise, dim=-1)


class Engine:
    """Continuous batching over ``slots`` fixed cache slots of ``max_len``
    rows each, on ``device`` (default the card; raises on a host without
    one unless given ``device="cpu"``). ``params`` must live on that
    device; the attention and MLP weights are cast to the compute dtype
    once (`models.api.cast_params`)."""

    def __init__(self, model, params, *, slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0, compiled=None,
                 device="cuda"):
        self.device = resolve_device(device)
        for path, t in tree_items(params):
            if t.device.type != self.device.type:
                raise ValueError(f"parameter {'/'.join(path)} is on "
                                 f"{t.device}, the engine on {self.device}")
        self.model = model
        self.params = cast_params(model, params)
        self.slots = slots
        self.max_len = max_len
        self.temperature = temperature
        self.seed = seed
        self.cache = self._init_cache()
        self.live: list[Optional[Request]] = [None] * slots
        self.lens = np.zeros(slots, np.int32)
        self.queue: list[Request] = []
        # poisoned slots: masked out of admission by a supervision layer;
        # the base engine never adds to it
        self.dead_slots: set[int] = set()
        # per-leaf index of the SLOT axis, read from the cache schema's
        # named axes ("batch") — never guessed from shapes: a stacked-layer
        # leaf is (layers, slots, ...) and with n_layers == slots a shape
        # probe picks the layer axis and merges the wrong rows
        self._slot_axes = tree_map(lambda p: p.axes.index("batch"),
                                   model.cache_schema(slots, max_len))
        self._prefill, self._decode = (compiled if compiled is not None
                                       else self.compile_model(model))

    def _init_cache(self):
        """The dense ``(slots, max_len)`` cache the engine decodes into."""
        return init_cache(self.model, self.slots, self.max_len,
                          device=self.device)

    @staticmethod
    def compile_model(model):
        """The (prefill, decode) pair, shareable across engines via
        ``Engine(..., compiled=...)`` (the reference's jitted pair)."""
        return model.prefill, model.decode

    def add_request(self, req: Request):
        """Enqueue one request for admission. Raises the typed
        `PromptTooLong` for a prompt the cache cannot hold."""
        if len(req.prompt) > self.max_len:
            raise PromptTooLong(req.rid, len(req.prompt), self.max_len)
        self.queue.append(req)

    def submit(self, req: Request, **kwargs):
        """Deprecated alias of `add_request`; dispatches through
        ``self.add_request`` so subclass overrides apply."""
        warnings.warn(
            "Engine.submit is deprecated; use Engine.add_request",
            DeprecationWarning, stacklevel=2)
        return self.add_request(req, **kwargs)

    def _length_bucket(self, n: int) -> int:
        """Pad prompt lengths up to the next power of two, capped at
        max_len: the cache has no rows past it."""
        return min(1 << max(n - 1, 0).bit_length(), self.max_len)

    def _admissible(self, s: int) -> bool:
        """Is slot ``s`` free AND not poisoned?"""
        return self.live[s] is None and s not in self.dead_slots

    def _pad_ok(self) -> bool:
        """Is right-padding a prompt safe for this model's cache? Yes for
        linear causal caches (pad K/V lie past the prompt: decode masks
        them and overwrites them before they become visible); no for
        sliding-window RING caches (the kept tail and its rotation come
        from the padded length) or recurrent state — those bucket by
        exact length."""
        cfg = self.model.cfg
        return (getattr(cfg, "ssm", None) is None and
                getattr(cfg, "sliding_window", None) is None)

    def _work_pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.live)

    def _pending_rids(self) -> set:
        return ({r.rid for r in self.queue} |
                {r.rid for r in self.live if r is not None})

    def _pre_dispatch_prefill(self, admitted: list) -> list:
        """Hook called with the claimed ``(slot, request)`` pairs before
        any prefill dispatch; returns the pairs that actually prefill."""
        return admitted

    def _prefill_dispatch(self, batch):
        """One prefill dispatch over every slot."""
        return self._prefill(self.params, batch, self.cache)

    def _admit(self):
        # claim every free slot first, then admit them in one padded
        # prefill per prompt-length bucket. A replayed request prefills
        # its prompt + already-generated prefix.
        admitted = []
        for s in range(self.slots):
            if self._admissible(s) and self.queue:
                req = self.queue.pop(0)
                self.live[s] = req
                admitted.append((s, req))
        if not admitted:
            return
        admitted = self._pre_dispatch_prefill(admitted)
        if not admitted:
            return
        if getattr(self.model.cfg, "is_encdec", False):
            # an enc-dec decoder has no engine-supplied encoder frames
            # (prefill would run the encoder), so it admits token at a
            # time through decode, as the reference's: a full-slot batch
            # a token. Decode writes every slot's row in place, so it
            # runs on a copy of the self-attention K/V (the encoder K/V,
            # which decode only reads, are shared) and slot s's rows are
            # merged back once its sequence is in.
            for s, req in admitted:
                seq = req.prompt + req.out
                cache = tree_from_items(
                    (path, leaf if path[-1] in ("ek", "ev") else leaf.clone())
                    for path, leaf in tree_items(self.cache))
                for t, tok in enumerate(seq):
                    batch = {"tokens": torch.full((self.slots, 1), tok,
                                                  dtype=torch.int64,
                                                  device=self.device),
                             "cache_len": torch.tensor(t, device=self.device)}
                    _, cache = self._decode(self.params, batch, cache)
                self.cache = self._merge_slots(cache, [s])
                self.lens[s] = len(seq)
            return
        pad_ok = self._pad_ok()
        buckets: dict[int, list] = {}
        for s, req in admitted:
            n = len(req.prompt) + len(req.out)
            buckets.setdefault(self._length_bucket(n) if pad_ok else n,
                               []).append((s, req))
        for width, group in sorted(buckets.items()):
            tokens = np.zeros((self.slots, width), np.int64)
            for s, req in group:
                seq = req.prompt + req.out
                tokens[s, : len(seq)] = seq
            _, cache = self._prefill_dispatch(
                {"tokens": torch.as_tensor(tokens, device=self.device)})
            self.cache = self._merge_slots(cache, [s for s, _ in group])
            for s, req in group:
                self.lens[s] = len(req.prompt) + len(req.out)

    def _merge_slots(self, new_cache, slots: list):
        """Copy the admitted ``slots``' rows of ``new_cache`` into the live
        cache, in place, along each leaf's slot axis (from the schema,
        `self._slot_axes`); every other slot's rows stay bitwise as they
        were, and a leaf ``new_cache`` shares with it is left alone.
        Returns the live cache."""
        idx = torch.as_tensor(sorted(slots), device=self.device)
        for (_, old), (_, new), (_, ax) in zip(
                tree_items(self.cache), tree_items(new_cache),
                tree_items(self._slot_axes)):
            if new is not old:
                old.index_copy_(ax, idx, new.index_select(ax, idx))
        return self.cache

    def _decode_dispatch(self, batch):
        """One batched decode dispatch for all slots."""
        return self._decode(self.params, batch, self.cache)

    def _slot_retires(self, s: int) -> bool:
        """Does slot ``s`` retire its sampled token this step?"""
        return True

    def _on_retire(self, s: int, req: Request) -> None:
        """Hook after slot ``s`` retires one token."""

    def _on_finish(self, s: int, req: Request) -> None:
        """Hook after ``req`` completes and frees slot ``s``."""

    def _on_evict(self, req: Request) -> None:
        """Hook when a supervision layer evicts ``req`` from a faulty
        slot, before it requeues."""

    def step(self):
        """One decode step for all live slots; returns finished requests."""
        self._admit()
        if all(r is None for r in self.live):
            return []
        last_tokens = np.zeros((self.slots, 1), np.int64)
        rows, rids, steps = [], [], []
        for s, r in enumerate(self.live):
            if r is not None:
                last_tokens[s, 0] = (r.prompt + r.out)[-1]
                rows.append(s)
                rids.append(r.rid)
                steps.append(len(r.out))
        # per-slot positions: slot s's last token sits at lens[s]-1; free
        # slots park at 0 (overwritten on admit)
        cl = np.maximum(self.lens - 1, 0)
        batch = {"tokens": torch.as_tensor(last_tokens, device=self.device),
                 "cache_len": torch.as_tensor(cl, device=self.device)}
        logits, self.cache = self._decode_dispatch(batch)
        if self.temperature > 0:
            picked = sample_per_request(
                self.seed, rids, steps, logits[rows, 0, :] / self.temperature)
        else:
            picked = torch.argmax(logits[rows, 0, :], dim=-1)
        sampled = dict(zip(rows, picked.tolist()))
        finished = []
        for s, r in enumerate(self.live):
            if r is None or not self._slot_retires(s):
                continue
            r.out.append(sampled[s])
            self.lens[s] += 1
            self._on_retire(s, r)
            if len(r.out) >= r.max_new or self.lens[s] >= self.max_len - 1:
                r.done = True
                finished.append(r)
                self.live[s] = None
                self.lens[s] = 0
                self._on_finish(s, r)
        return finished

    def run_to_completion(self, max_steps: int = 10_000):
        """Step until every submitted request finishes; returns the
        finished requests. Exhausting ``max_steps`` with work still queued
        or live raises the typed `EngineStalled` (the unfinished rids and
        the done subset)."""
        done = []
        for _ in range(max_steps):
            done += self.step()
            if not self._work_pending():
                return done
        if not self._work_pending():
            return done
        raise EngineStalled(sorted(self._pending_rids()), done=done)


class PagedEngine(Engine):
    """`Engine` with a paged KV cache: ADMISSION IS BOUNDED BY FREE
    PAGES, not by ``slots``.

    Every request's K/V lives in fixed-size pages of one preallocated
    pool (`serve/paged.py`), so:

    * ``slots`` is only the DECODE LANE count (the batch width of one
      decode dispatch). Admission pulls from the queue while the free
      pages cover a request's worst-case footprint (``ceil(min(len +
      max_new, max_len) / page_size)`` pages, the max over cache leaves;
      a ring leaf never needs more than its W slots). Admitted requests
      beyond the lane count wait PREFILLED in ``paused``; when a lane
      frees, the refill is a block-table row swap (no prefill, no copy).
      With the default pool (the dense engine's memory, ``slots *
      ceil(max_len / page_size)`` pages plus scratch) short requests
      oversubscribe the lanes: ``peak_admitted`` > ``slots``.
    * prefill and decode read and write THROUGH the block table
      (`serve.paged.paged_prefill` / `paged_decode`, one dispatch each,
      as dense); the dense slot merge becomes page assignment.
    * decode attends over each lane's ALLOCATED span instead of
      ``max_len``; masked positions add exactly zero. On the CPU in
      float32 the tokens equal the dense engine's; on the card the
      shorter span is another kernel shape, so bfloat16 logits are
      close to the dense engine's, not bitwise.

    A model whose cache cannot be paged (recurrent state, enc-dec)
    raises the typed `PagedCacheUnsupported` at construction; a request
    whose footprint exceeds the POOL raises `InsufficientPages` at
    `add_request`. The supervision layer stacks on top unchanged
    (`serve/engine_fault.py:FaultTolerantPagedEngine`)."""

    def __init__(self, model, params, *, slots: int = 4, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0, compiled=None,
                 device="cuda", page_size: int = 16,
                 n_pages: Optional[int] = None):
        if n_pages is None:
            # the dense engine's exact K/V memory, repartitioned into
            # pages (+1 for scratch): oversubscription comes from
            # requests shorter than max_len, not from extra memory
            n_pages = slots * (-(-max_len // page_size)) + 1
        self.pool = paged.PagePool(model, page_size=page_size,
                                   n_pages=n_pages, max_len=max_len,
                                   device=device)
        self.table = paged.PageTable(self.pool)
        super().__init__(model, params, slots=slots, max_len=max_len,
                         temperature=temperature, seed=seed,
                         compiled=compiled, device=device)
        # admitted (pages held, prefilled) but waiting for a free lane
        self.paused: list[Request] = []
        self.peak_admitted = 0   # max concurrent admissions observed

    def _init_cache(self):
        return None              # every K/V row lives in the pool

    # ------------------------------------------------------- admission

    def _pages_for(self, req: Request) -> int:
        total = min(len(req.prompt) + len(req.out) + req.max_new,
                    self.max_len)
        return self.pool.pages_for(total)

    def add_request(self, req: Request):
        """Page-aware admission bound: a request whose worst-case footprint
        can NEVER fit the pool raises the typed `InsufficientPages` (the
        paged twin of `PromptTooLong`); one that only exceeds the current
        free count waits in the queue for pages to free."""
        need = self._pages_for(req)
        if need > self.pool.capacity:
            raise InsufficientPages(need, self.pool.n_free,
                                    self.pool.capacity)
        super().add_request(req)

    def _work_pending(self) -> bool:
        return bool(self.paused) or super()._work_pending()

    def _pending_rids(self) -> set:
        return super()._pending_rids() | {r.rid for r in self.paused}

    def _admit(self):
        # 1. refill free lanes from the paused set first: their K/V is
        # already paged in, so the "prefill" is a block-table row swap
        for s in range(self.slots):
            if not self.paused:
                break
            if self._admissible(s):
                req = self.paused.pop(0)
                self.live[s] = req
                self.lens[s] = len(req.prompt) + len(req.out)
        # 2. admit from the queue while free pages cover the head
        # request's footprint: THE admission bound; lanes don't gate it
        admitted: list[Request] = []
        while self.queue:
            need = self._pages_for(self.queue[0])
            if need > self.pool.n_free:
                break
            req = self.queue.pop(0)
            self.table.assign(req.rid, need)
            admitted.append(req)
        n_live = sum(r is not None for r in self.live)
        self.peak_admitted = max(
            self.peak_admitted, n_live + len(self.paused) + len(admitted))
        if not admitted:
            return
        # 3. claim free lanes for as many as fit; the rest decode later
        lane_pairs, pausing = [], []
        for req in admitted:
            s = next((s for s in range(self.slots)
                      if self._admissible(s)), None)
            if s is None:
                pausing.append(req)
            else:
                self.live[s] = req
                self.lens[s] = len(req.prompt) + len(req.out)
                lane_pairs.append((s, req))
        # the supervision hook probes LANE claims (a paused admission has
        # no slot yet; it is probed when it joins a lane's decodes)
        kept = self._pre_dispatch_prefill(lane_pairs)
        jobs = kept + [(None, r) for r in pausing]
        if not jobs:
            return
        # 4. prefill into pages, bucketed exactly like the dense engine
        pad_ok = self._pad_ok()
        buckets: dict[int, list] = {}
        for s, req in jobs:
            n = len(req.prompt) + len(req.out)
            buckets.setdefault(self._length_bucket(n) if pad_ok else n,
                               []).append((s, req))
        ps = self.pool.page_size
        for width, group in sorted(buckets.items()):
            qbt = paged.prefill_table_width(self.pool.specs, ps, width)
            for i0 in range(0, len(group), self.slots):
                chunk = group[i0:i0 + self.slots]
                tokens = np.zeros((self.slots, width), np.int64)
                for row, (s, req) in enumerate(chunk):
                    seq = req.prompt + req.out
                    tokens[row, :len(seq)] = seq
                bt = self.table.block_table(
                    [req.rid for _, req in chunk] +
                    [None] * (self.slots - len(chunk)), width=qbt)
                self._prefill_dispatch(
                    {"tokens": torch.as_tensor(tokens, device=self.device),
                     "block_table": torch.as_tensor(bt, device=self.device)})
        self.paused.extend(pausing)

    # ------------------------------------------------------- dispatch

    def _prefill_dispatch(self, batch):
        logits, _ = paged.paged_prefill(
            self._prefill, self.pool.paths, self.pool.specs, self.params,
            {"tokens": batch["tokens"]}, self.pool.leaves,
            batch["block_table"])
        return logits, None

    def _decode_dispatch(self, batch):
        bt = self.table.block_table(
            [r.rid if r is not None else None for r in self.live])
        logits, _ = paged.paged_decode(
            self._decode, self.pool.paths, self.pool.specs, self.params,
            batch, self.pool.leaves, torch.as_tensor(bt, device=self.device))
        return logits, None

    # ------------------------------------------------------- lifecycle

    def _on_finish(self, s: int, req: Request) -> None:
        self.table.release(req.rid)
        super()._on_finish(s, req)

    def _on_evict(self, req: Request) -> None:
        # the replay re-admits against FRESH pages; stale ones free now
        if self.table.holds(req.rid):
            self.table.release(req.rid)
        super()._on_evict(req)

    def defrag(self) -> dict[int, int]:
        """Compact allocated pages onto the lowest ids (see
        `serve.paged.PageTable.defrag`); safe mid-decode, and the
        continuation is bitwise the same."""
        return self.table.defrag()


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
