"""Streaming window runtime: continuous biosignal traffic through the fused
pipeline kernel.

The paper's deployment model (§4.4.2) is a sensor feeding windows to the
accelerator forever; this is the serving analogue. The default feed hands
the kernel contiguous RAW signal chunks (views of one device copy of the
signal) and the kernel cuts the overlapping (window, hop) frames itself —
no host gather, no duplicated overlap bytes. The pre-framed path
(``framing="host"``) is kept as the reference. Dispatch is pipelined: up
to ``depth`` later batches are in flight while batch k is consumed; each
dispatch records one `torch.cuda.Event`, and `_collect` waits on that
batch's event — the retire point the telemetry measures.

MULTI-COLUMN: ``n_columns > 1`` deals each dispatch's ``batch_windows *
n_columns`` frames across column replicas, hop-aligned
(`kernels/pipeline/shard.py`); ``column_weights`` makes the deal
non-uniform. The stream's ``mesh`` (`column_mesh`: the host's first
``n_columns`` cards when it has that many, as the reference builds its
``data`` mesh over its local devices) puts column d on card d, each on a
CUDA stream of its own; with no mesh (on the CPU, for one column, on too
few cards) the columns run one after another on the stream's device.
``mesh`` is a public attribute: ``(cuda:0,) * D`` runs the D columns on
D streams of one card. Outputs are bit-identical to one column.
Independent streams can instead be pinned to distinct columns — what
`serve.engine.ColumnScheduler` hands out; a pinned stream has no mesh.

FAULT HOOKS: an ``injector`` (`serve.fault.FaultInjector`) fires before
every dispatch and may raise `TransientDispatchError`, retried through
``retry`` (`runtime.fault.Supervisor.call`, default three retries), or
`ColumnDeadError`, which propagates to the serving layer
(`serve/fault.py`).

`StreamTelemetry` keeps per-stream and per-column throughput (an EWMA of
windows/s per retire). The device-resident sibling is
`serve/resident.py` (`ResidentStream`, reachable via
`BiosignalStream.process_resident`), bit-identical to this path.

AUTOTUNE: ``autotune=True`` (with ``block_rows`` unset) measures the
kernel's frames a block at the first dispatch of each shape
(`core.autotune`, through `kernels.pipeline.ops.tune_stream_block` /
`tune_frames_block`, under the reference's keys) and reuses the cached
winner after; the outputs do not change.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterator

import torch

from repro_torch.device import cuda_devices, resolve_device
from repro_torch.kernels.pipeline.graph import (canonical_graph_outputs,
                                                default_app,
                                                get_graph_factory,
                                                graph_empty_outputs,
                                                staged_signal,
                                                stream_frame_count)
from repro_torch.kernels.pipeline.kernel import OUTPUTS
from repro_torch.kernels.pipeline.ops import (tune_frames_block,
                                              tune_stream_block)
from repro_torch.kernels.pipeline.shard import (graph_sharded,
                                                graph_stream_sharded,
                                                mesh_operands)
from repro_torch.runtime.fault import Supervisor, TransientDispatchError


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Shape + policy of one stream's dispatches (shared by the
    host-driven `BiosignalStream` and the resident
    `serve.resident.ResidentStream`).

    Invariants the runtimes check: ``window >= app.fft_size``, ``0 < hop
    <= window`` (frames advance by whole hops; every chunk and column
    boundary is HOP-ALIGNED, which is what makes raw-chunk feeds and
    column deals bit-identical to host framing), ``batch_windows > 0``,
    and ``column_weights`` — when set — has exactly ``n_columns``
    entries and needs ``framing="kernel"``. Graphs other than the
    biosignal one are single-column."""
    window: int = 2048          # samples per frame (the processing window)
    hop: int = 512              # frame stride; < window => overlapping frames
    batch_windows: int = 8      # frames per fused-kernel dispatch PER COLUMN
    autotune: bool = False      # measure the kernel's frames a block (cached)
    block_rows: int | None = None   # frames per CUDA block (default: the
    #                             graph's, BIOSIGNAL_BLOCK_FRAMES or
    #                             ASR_BLOCK_FRAMES)
    outputs: tuple = OUTPUTS    # which app outputs to compute/write
    framing: str = "kernel"     # "kernel": raw chunks, frames cut in-kernel
    #                             "host": gather-framed reference
    n_columns: int = 1          # column replicas a dispatch is dealt across
    depth: int = 1              # max in-flight batches (1 = double buffer)
    column_weights: tuple | None = None   # non-uniform deal weights (one
    #                             per column, e.g. measured rates from
    #                             ColumnScheduler.deal_weights); None =
    #                             the equal deal
    graph: str = "biosignal"    # which registered stage graph runs
    #                             ("asr": the ASR front-end); the default
    #                             `outputs` then means all of its outputs


# single source of the framing arithmetic (shared with the kernel)
frame_count = stream_frame_count


def frame_signal(signal, window: int, hop: int) -> torch.Tensor:
    """(S,) continuous signal -> (n_frames, window) overlapping frames,
    materialised (every sample duplicated ~window/hop times). The
    ``framing="host"`` reference the raw-chunk path is held to."""
    sig = torch.as_tensor(signal)
    if sig.ndim != 1:
        raise ValueError(f"signal must be 1-D, got {tuple(sig.shape)}")
    n = frame_count(sig.shape[0], window, hop)
    if n == 0:
        return torch.zeros((0, window), dtype=sig.dtype, device=sig.device)
    return sig.unfold(0, window, hop).contiguous()


def stream_signal(signal, device) -> torch.Tensor:
    """``signal`` as a 1-D tensor on ``device``, the stream entries' input.
    float64 becomes float32 and int64 int32, as the reference's
    ``jnp.asarray`` makes them with x64 off; any other dtype is kept."""
    sig = staged_signal(torch.as_tensor(signal))
    if sig.ndim != 1:
        raise ValueError(f"signal must be 1-D, got {tuple(sig.shape)}")
    return sig.to(device)


def column_mesh(n_columns: int, device="cuda"):
    """The column mesh of a stream on ``device``: the host's first
    ``n_columns`` cards, or None — on a CPU stream, for one column, and
    when the host has fewer cards (the columns then run one after another
    on the stream's device), as the reference's ``data`` mesh needs that
    many local devices. A CUDA stream on a host without a card raises."""
    if n_columns <= 1 or torch.device(device).type != "cuda":
        return None
    devs = cuda_devices()
    if len(devs) < n_columns:
        return None
    return tuple(devs[:n_columns])


def _check_stream_config(cfg: StreamConfig, fft_size: int) -> None:
    if cfg.n_columns < 1:
        raise ValueError(f"n_columns must be >= 1, got {cfg.n_columns}")
    if cfg.graph != "biosignal" and (cfg.n_columns != 1 or
                                     cfg.column_weights is not None):
        raise ValueError(f"graph {cfg.graph!r} is single-column (no "
                         f"sharded entry)")
    if cfg.column_weights is not None:
        if len(cfg.column_weights) != cfg.n_columns:
            raise ValueError(f"{len(cfg.column_weights)} column weights for "
                             f"{cfg.n_columns} columns")
        if cfg.framing != "kernel":
            raise ValueError("the weighted deal is a raw-chunk "
                             "(framing='kernel') path")
    if cfg.window < fft_size:
        raise ValueError(f"window {cfg.window} < fft_size {fft_size}")
    if not 0 < cfg.hop <= cfg.window:
        raise ValueError(f"hop {cfg.hop} must be in (0, {cfg.window}]")
    if cfg.batch_windows <= 0 or cfg.depth < 1:
        raise ValueError("batch_windows and depth must be positive")
    if cfg.framing not in ("kernel", "host"):
        raise ValueError(f"framing {cfg.framing!r}")


def stream_outputs(graph, cfg: StreamConfig) -> tuple:
    """The config's output selection, canonical for its graph. The
    default `OUTPUTS` (the biosignal graph's four) means ALL of the
    configured graph's outputs, so ``StreamConfig(graph="asr")`` needs no
    ``outputs=``."""
    return canonical_graph_outputs(
        graph, None if cfg.outputs is OUTPUTS else cfg.outputs)


def guarded_dispatch(launch, *, injector, retry, column: int):
    """Run one dispatch under the fault hooks: the injector fires first
    (a simulated transient is retried through ``retry``'s capped backoff
    before anything launched; a column death propagates), then
    ``launch()``."""
    def dispatch():
        if injector is not None:
            injector.on_dispatch(column)
        return launch()
    if retry is not None:
        return retry.call(dispatch)
    return dispatch()


def default_retry(injector, retry):
    """The dispatch's retry policy: ``retry``, or with an ``injector`` and
    no ``retry`` three retries of `TransientDispatchError` without
    sleeping, as the reference's streams default."""
    if injector is not None and retry is None:
        return Supervisor(max_retries=3, retry_on=(TransientDispatchError,))
    return retry


@dataclasses.dataclass(frozen=True)
class ColumnStats:
    """One column's measured-throughput snapshot (see `StreamTelemetry`)."""
    column: int
    streams: int        # live streams attached to the column
    windows: int        # total windows retired on the column
    rate: float         # EWMA of the column's retire throughput, windows/s
    load: float         # sum of the column's live streams' EWMA rates


class StreamTelemetry:
    """Per-stream and per-column throughput telemetry.

    Every batch retire (`BiosignalStream._collect`, after the batch's
    event completes) reports ``(stream_id, n_windows)``; the telemetry
    turns the inter-retire gap into an instantaneous windows/s sample and
    folds it into an EWMA (``alpha`` = weight of the newest sample) per
    stream and per column. The first retire of a stream/column only seeds
    the timestamp, so a telemetry with no gap yet is COLD (`warm` False).

    ``clock`` is injectable (default `time.perf_counter`) so tests can
    replay timings deterministically. The resident path reports one
    retire per counter drain (the windows retired since the previous
    drain). ``add_retire_listener`` lets a consumer observe every retire.
    """

    def __init__(self, alpha: float = 0.3, clock=time.perf_counter):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha {alpha} must be in (0, 1]")
        self.alpha = alpha
        self._clock = clock
        self._stream_col: dict = {}       # stream_id -> column
        self._stream_rate: dict = {}      # stream_id -> EWMA windows/s
        self._stream_last: dict = {}      # stream_id -> last retire t
        self._stream_windows: dict = {}   # stream_id -> total windows
        self._col_rate: dict[int, float] = {}
        self._col_last: dict[int, float] = {}
        self._col_windows: dict[int, int] = {}
        self._listeners: list = []        # fns called (stream_id, n) per
        #                                   retire, AFTER the EWMA update

    def add_retire_listener(self, fn) -> None:
        """Register ``fn(stream_id, n_windows)`` to run on every recorded
        retire (after the EWMA fold)."""
        self._listeners.append(fn)

    def attach(self, stream_id, column: int = 0) -> None:
        """Register a stream on a column (re-attach moves it)."""
        self._stream_col[stream_id] = int(column)
        self._stream_rate.setdefault(stream_id, 0.0)
        self._stream_windows.setdefault(stream_id, 0)

    def detach(self, stream_id) -> None:
        for d in (self._stream_col, self._stream_rate, self._stream_last,
                  self._stream_windows):
            d.pop(stream_id, None)

    def column_of(self, stream_id) -> int:
        return self._stream_col[stream_id]

    @staticmethod
    def _ewma(old: float | None, inst: float, alpha: float) -> float:
        return inst if old is None or old == 0.0 else \
            alpha * inst + (1.0 - alpha) * old

    def record_retire(self, stream_id, n_windows: int) -> None:
        """Fold one retired batch (``n_windows`` valid frames) into the
        stream's and its column's EWMAs, then notify retire listeners."""
        if stream_id not in self._stream_col:
            self.attach(stream_id)
        t = self._clock()
        col = self._stream_col[stream_id]
        self._stream_windows[stream_id] += int(n_windows)
        self._col_windows[col] = self._col_windows.get(col, 0) + int(n_windows)
        last = self._stream_last.get(stream_id)
        if last is not None and t > last:
            inst = n_windows / (t - last)
            self._stream_rate[stream_id] = self._ewma(
                self._stream_rate.get(stream_id), inst, self.alpha)
        self._stream_last[stream_id] = t
        last_c = self._col_last.get(col)
        if last_c is not None and t > last_c:
            inst = n_windows / (t - last_c)
            self._col_rate[col] = self._ewma(
                self._col_rate.get(col), inst, self.alpha)
        self._col_last[col] = t
        for fn in self._listeners:
            fn(stream_id, int(n_windows))

    @property
    def warm(self) -> bool:
        """True once ANY stream has a measured rate (>= 2 retires)."""
        return any(r > 0.0 for r in self._stream_rate.values())

    def stream_rate(self, stream_id) -> float:
        return self._stream_rate.get(stream_id, 0.0)

    def column_rate(self, column: int) -> float:
        return self._col_rate.get(column, 0.0)

    def column_load(self, column: int) -> float:
        """Sum of the column's live streams' EWMA rates (demand)."""
        return sum(self._stream_rate.get(s, 0.0)
                   for s, c in self._stream_col.items() if c == column)

    def column_stats(self, n_columns: int | None = None) -> list[ColumnStats]:
        """Snapshot over columns 0..n-1 (default: every column seen)."""
        cols = range(n_columns) if n_columns is not None else sorted(
            set(self._col_windows) | set(self._stream_col.values()) or {0})
        return [ColumnStats(
            column=c,
            streams=sum(1 for v in self._stream_col.values() if v == c),
            windows=self._col_windows.get(c, 0),
            rate=self.column_rate(c),
            load=self.column_load(c)) for c in cols]


class BiosignalStream:
    """Drives a continuous signal through the fused pipeline in pipelined
    window batches (up to `cfg.depth` in flight).

    >>> stream = BiosignalStream(make_app(), StreamConfig(hop=256))
    >>> out = stream.process(signal)          # dict over all frames

    ``device`` is where the dispatches run (default: the app's device;
    with no app, ``"cuda"``); `repin` moves later dispatches to another
    device. Pinning a device is for column-pinned streams: with
    ``cfg.n_columns > 1`` it is refused, as in the reference. ``mesh`` is
    the stream's column mesh (`column_mesh` of its columns and device;
    None for a pinned stream); setting it deals later dispatches over
    other devices. ``telemetry``
    makes the stream report every batch retire under ``stream_id`` on
    ``column``. ``injector`` and ``retry`` are the fault hooks (module
    docstring).

    Guarantee: `process` equals the fused graph on
    `frame_signal(signal, window, hop)` in one call — bit-identical across
    framing modes, batch sizes, column counts and weights and the resident
    mode (`process_resident`) on one device; the zero-frame path returns
    the same keys/dtypes.
    """

    def __init__(self, app=None, cfg: StreamConfig | None = None, *,
                 device=None, telemetry: StreamTelemetry | None = None,
                 stream_id=None, column: int = 0, injector=None,
                 retry=None):
        cfg = cfg or StreamConfig()
        if device is not None and cfg.n_columns != 1:
            raise ValueError("pin a stream to one column OR deal it across "
                             "columns, not both")
        self.app = app if app is not None else default_app(
            cfg.graph, device=device if device is not None else "cuda")
        _check_stream_config(cfg, self.app.fft_size)
        self._graph, operands = get_graph_factory(cfg.graph)(self.app)
        self._app_operands = operands
        self.cfg = dataclasses.replace(
            cfg, outputs=stream_outputs(self._graph, cfg))
        self.device = self.app.device
        self._operands = operands
        if device is not None:
            self.repin(device)
        self.mesh = column_mesh(self.cfg.n_columns, self.device)
        self._mesh_held = None      # (mesh, operands, mesh_operands)
        self.telemetry = telemetry
        self.stream_id = stream_id if stream_id is not None else id(self)
        self.column = column
        self._resident = None       # lazy ResidentStream sibling (cached)
        self.injector = injector
        self._retry = default_retry(injector, retry)
        if telemetry is not None:
            telemetry.attach(self.stream_id, column)

    def repin(self, device, column: int | None = None) -> None:
        """Move the stream's future dispatches to another device; batches
        already in flight finish where they were launched. Pass
        ``column`` to re-attribute later retires in the telemetry. Only
        for column-pinned (``n_columns == 1``) streams."""
        if self.cfg.n_columns != 1:
            raise ValueError("repin applies to column-pinned streams")
        self.device = resolve_device(device)
        self._operands = tuple(t.to(self.device) for t in self._app_operands)
        if column is not None:
            self.column = column
            if self.telemetry is not None:
                self.telemetry.attach(self.stream_id, column)

    @property
    def dispatch_windows(self) -> int:
        """Frames per dispatch across all columns."""
        return self.cfg.batch_windows * self.cfg.n_columns

    @property
    def chunk_samples(self) -> int:
        """Raw samples per kernel-framed dispatch: one batch's span."""
        cfg = self.cfg
        return (self.dispatch_windows - 1) * cfg.hop + cfg.window

    def _column_operands(self):
        """What the columns read: the operands on each device of
        ``self.mesh`` (`mesh_operands`, made once a mesh), else on the
        stream's device."""
        if self.mesh is None or self.cfg.n_columns == 1:
            return self._operands
        held = self._mesh_held
        if held is None or held[0] != self.mesh or \
                held[1] is not self._operands:
            held = (self.mesh, self._operands,
                    mesh_operands(self._operands, self.mesh))
            self._mesh_held = held
        return held[2]

    def _retire_event(self):
        """One event per dispatch on a card (None on the CPU, where the
        plain version has finished when the dispatch returns)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _guarded(self, launch) -> dict:
        return guarded_dispatch(launch, injector=self.injector,
                                retry=self._retry, column=self.column)

    def _dispatch_chunk(self, chunk: torch.Tensor) -> dict:
        """Raw-chunk dispatch: the kernel cuts the frames itself, one
        launch per column share, on ``self.mesh`` when set. With
        ``cfg.autotune`` the block is
        measured after the injector fired (cached per shape)."""
        cfg = self.cfg
        weights = cfg.column_weights if cfg.n_columns > 1 else None

        def run(rb):
            return graph_stream_sharded(
                chunk, self._column_operands(), graph=self._graph,
                window=cfg.window, hop=cfg.hop, n_columns=cfg.n_columns,
                weights=weights, block_frames=rb, outputs=cfg.outputs,
                mesh=self.mesh)

        def launch():
            rb = cfg.block_rows
            if cfg.autotune and rb is None:
                rb = tune_stream_block(self._graph, chunk, cfg.window,
                                       cfg.hop, cfg.outputs, run,
                                       n_columns=cfg.n_columns,
                                       weights=weights)
            return run(rb)
        return self._guarded(launch)

    def _dispatch_frames(self, frames: torch.Tensor) -> dict:
        """Pre-framed dispatch (reference path), one launch per column's
        row block, on ``self.mesh`` when set."""
        cfg = self.cfg

        def run(rb):
            return graph_sharded(frames, self._column_operands(),
                                 graph=self._graph,
                                 n_columns=cfg.n_columns, block_rows=rb,
                                 outputs=cfg.outputs, mesh=self.mesh)

        def launch():
            rb = cfg.block_rows
            if cfg.autotune and rb is None:
                # the reference keys the biosignal stream's frames under
                # its app entry (`biosignal_pipeline`), other graphs under
                # their graph entry
                rb = tune_frames_block(
                    self._graph, frames, cfg.outputs, run,
                    n_columns=cfg.n_columns,
                    app_key=self._graph.name == "biosignal")
            return run(rb)
        return self._guarded(launch)

    def _batches(self, signal) -> Iterator[tuple]:
        """(in-flight output dict, n valid frames, retire event) per
        window batch."""
        cfg = self.cfg
        sig = stream_signal(signal, self.device)
        n = frame_count(sig.shape[0], cfg.window, cfg.hop)
        bw = self.dispatch_windows
        if cfg.framing == "host":
            frames = frame_signal(sig, cfg.window, cfg.hop)
            for start in range(0, n, bw):
                batch = frames[start: start + bw]
                valid = batch.shape[0]
                if valid < bw:      # pad the tail batch to the fixed shape
                    batch = torch.cat([batch, batch.new_zeros(
                        (bw - valid, cfg.window))])
                out = self._dispatch_frames(batch)
                yield out, valid, self._retire_event()
            return
        # raw-chunk feed: batch k's frames live in one contiguous slice of
        # the signal; the tail batch pads with raw zeros, trimmed by `valid`
        span = self.chunk_samples
        for start in range(0, n, bw):
            s0 = start * cfg.hop
            chunk = sig[s0: s0 + span]
            if chunk.shape[0] < span:
                chunk = torch.cat(
                    [chunk, chunk.new_zeros(span - chunk.shape[0])])
            out = self._dispatch_chunk(chunk)
            yield out, min(bw, n - start), self._retire_event()

    def stream(self, signal) -> Iterator[dict]:
        """Yields one output dict per window batch (trimmed to the real
        frames). Up to `cfg.depth` later batches are dispatched before
        batch k is yielded."""
        inflight: deque[tuple] = deque()
        for nxt in self._batches(signal):       # in flight now
            inflight.append(nxt)
            if len(inflight) > self.cfg.depth:
                yield self._collect(*inflight.popleft())
        while inflight:
            yield self._collect(*inflight.popleft())

    def _collect(self, out: dict, valid: int, event) -> dict:
        if event is not None:
            event.synchronize()                 # the batch retires HERE
        if self.telemetry is not None:
            self.telemetry.record_retire(self.stream_id, valid)
        return {k: v[:valid] for k, v in out.items()}

    def _empty(self, dtype) -> dict:
        """Zero-frame result: same keys/shapes/dtypes as the kernel path."""
        return graph_empty_outputs(self._graph, self.cfg.window, dtype,
                                   self.cfg.outputs, self.device)

    def process(self, signal) -> dict:
        """All framed outputs concatenated, equal to running the graph on
        `frame_signal(signal, window, hop)` at once."""
        sig = stream_signal(signal, self.device)
        chunks = list(self.stream(sig))
        if not chunks:
            return self._empty(sig.dtype)
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    def process_resident(self, signal, rcfg=None) -> dict:
        """`process`, with the steady state as one device loop: delegates
        to a cached `serve.resident.ResidentStream` sharing this stream's
        app, config, device, telemetry and stream_id. Outputs are
        bit-identical to `process`; telemetry sees counter drains instead
        of per-batch retires."""
        from repro_torch.serve.resident import ResidentConfig, ResidentStream

        rcfg = rcfg or ResidentConfig()
        if self._resident is None or self._resident.rcfg != rcfg or \
                self._resident.device != self.device:
            self._resident = ResidentStream(
                self.app, self.cfg, rcfg, device=self.device,
                telemetry=self.telemetry, stream_id=self.stream_id,
                column=self.column, injector=self.injector,
                retry=self._retry)
        return self._resident.process(signal)
