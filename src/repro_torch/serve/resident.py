"""Resident streaming loop: the steady state as one loop over a device
buffer.

The host-driven runtime (`serve.stream.BiosignalStream`) slices a chunk,
dispatches, waits for the retire and updates telemetry once per
`batch_windows` frames. This module runs the steady state differently:

* the raw signal is copied ONCE into one preallocated device buffer,
  padded to whole ring sweeps, and every sweep launches the fused ring
  kernel on an overlapping strided view of that buffer (row r starts
  ``r * batch_windows * hop`` samples into the sweep) — no per-slot copy,
  no gather;
* the outputs are preallocated once for all sweeps and each launch writes
  its rows in place;
* the retired-window counter lives on the device, one slot per sweep:
  the ring kernel itself adds the valid frames it wrote (pad frames past
  the signal never count), so the counter witnesses the device's work
  and costs no extra device operation. The host reads it once, takes
  the running sum (the per-sweep snapshots of the reference's counter)
  and drains it into `serve.stream.StreamTelemetry` every
  `ResidentConfig.drain_interval` sweeps (`_drain`).

Outputs are bit-identical to `BiosignalStream.process` on the same
device, and the drained deltas sum to the host path's per-batch retire
total. Capturing the loop in a CUDA graph is later work.
``ResidentConfig(autotune=True)`` measures the ring depth
(`core.autotune.tuned_ring_depth`) on a zero signal of the call's shape;
the search runs no fault hook and leaves ``last_drains`` alone.

Fault hooks, at the reference's points: the whole loop is ONE dispatch,
so the injector's `on_dispatch` fires once per `process`, before any
launch (a retried transient has launched nothing), and its `on_drain`
fires at each drain point before that point's retire is recorded — a
`ColumnDeadError` there is the "death mid-resident-sweep" of
`serve/fault.py`: earlier drains already fed the telemetry, the
outputs are lost with the column.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.autotune import tuned_ring_depth
from repro_torch.device import resolve_device
from repro_torch.kernels.pipeline.graph import (default_app,
                                                get_graph_factory,
                                                graph_alloc_outputs,
                                                graph_empty_outputs,
                                                graph_ring_call,
                                                ring_chunk_samples,
                                                stream_frame_count)
from repro_torch.serve.stream import (StreamConfig, StreamTelemetry,
                                      _check_stream_config, default_retry,
                                      guarded_dispatch, stream_outputs,
                                      stream_signal)

DEFAULT_RING_DEPTH = 4


@dataclasses.dataclass(frozen=True)
class ResidentConfig:
    """Knobs of the resident loop (the window/hop/batch shape stays in
    `serve.stream.StreamConfig`).

    ``ring_depth`` — dispatch-sized chunks (ring slots) per sweep; one
    sweep = one ring-kernel launch over `ring_depth * batch_windows`
    frames (`None`: `DEFAULT_RING_DEPTH`, or a measured winner when
    ``autotune`` is set: `core.autotune.tuned_ring_depth`, keyed by the
    (window, hop, batch_windows, outputs, drain_interval, batch count)
    shape). ``drain_interval`` — sweeps between telemetry counter drains
    (plus once at end-of-signal). ``autotune`` — measure ring-depth
    candidates instead of the static default."""
    ring_depth: int | None = None
    drain_interval: int = 1
    autotune: bool = False


class ResidentStream:
    """Drives a signal through the fused pipeline with the steady state as
    one loop of ring launches over a device-resident buffer — the
    resident sibling of `serve.stream.BiosignalStream` (same
    `StreamConfig`, same output dict, bit-identical results).

    >>> rs = ResidentStream(make_app(), StreamConfig(hop=256),
    ...                     ResidentConfig(ring_depth=8))
    >>> out = rs.process(signal)       # == BiosignalStream.process(signal)

    The loop is a raw-chunk path (``cfg.framing == "kernel"``) on one
    column (``cfg.n_columns == 1``; `serve.engine.ColumnScheduler` places
    streams on columns). ``last_drains`` keeps the most recent `process`
    call's cumulative drained counts. ``injector`` and ``retry`` are the
    fault hooks of `serve.stream.BiosignalStream`.
    """

    def __init__(self, app=None, cfg: StreamConfig | None = None,
                 rcfg: ResidentConfig | None = None, *, device=None,
                 telemetry: StreamTelemetry | None = None,
                 stream_id=None, column: int = 0, injector=None,
                 retry=None):
        cfg = cfg or StreamConfig()
        self.app = app if app is not None else default_app(
            cfg.graph, device=device if device is not None else "cuda")
        _check_stream_config(cfg, self.app.fft_size)
        if cfg.framing != "kernel":
            raise ValueError("the resident loop is a raw-chunk "
                             "(framing='kernel') path")
        if cfg.n_columns != 1 or cfg.column_weights is not None:
            raise ValueError("resident streams are column-pinned; place "
                             "streams on columns with ColumnScheduler")
        self.rcfg = rcfg or ResidentConfig()
        if self.rcfg.ring_depth is not None and self.rcfg.ring_depth < 1 \
                or self.rcfg.drain_interval < 1:
            raise ValueError(f"bad resident config {self.rcfg}")
        self.device = resolve_device(device) if device is not None \
            else self.app.device
        self._graph, operands = get_graph_factory(cfg.graph)(self.app)
        self._operands = tuple(t.to(self.device) for t in operands)
        self.cfg = dataclasses.replace(
            cfg, outputs=stream_outputs(self._graph, cfg))
        self.telemetry = telemetry
        self.stream_id = stream_id if stream_id is not None else id(self)
        self.column = column
        self.last_drains: list[int] = []
        self.injector = injector
        self._retry = default_retry(injector, retry)
        if telemetry is not None:
            telemetry.attach(self.stream_id, column)

    @property
    def chunk_samples(self) -> int:
        """Raw samples per ring slot (one dispatch's span — identical to
        `BiosignalStream.chunk_samples` for the same config)."""
        return ring_chunk_samples(self.cfg.window, self.cfg.hop,
                                  self.cfg.batch_windows)

    def _ring_depth(self, n: int) -> int:
        """The configured ring depth, else the measured one (over more
        than one batch), else `DEFAULT_RING_DEPTH`. The search runs the
        loop on zeros of this call's length, keyed as the reference's
        (``"resident_ring"`` for the biosignal graph, else
        ``f"{graph}_resident_ring"``)."""
        cfg = self.cfg
        n_batches = -(-n // cfg.batch_windows)
        if self.rcfg.ring_depth is not None:
            return self.rcfg.ring_depth
        if self.rcfg.autotune and n_batches > 1:
            name = "resident_ring" if cfg.graph == "biosignal" \
                else f"{cfg.graph}_resident_ring"
            zeros = torch.zeros(
                self.chunk_samples + (n_batches * cfg.batch_windows - 1) *
                cfg.hop, dtype=torch.float32, device=self.device)
            return tuned_ring_depth(
                name, cfg.window, cfg.hop, cfg.batch_windows, cfg.outputs,
                "float32", self.rcfg.drain_interval, n_batches,
                lambda rd: self._run(zeros, rd))
        return DEFAULT_RING_DEPTH

    def _run(self, sig: torch.Tensor, ring_depth: int):
        """Pad into one device buffer and run the loop of ring launches;
        returns (outputs, per-sweep retired counts), both on the
        device."""
        cfg = self.cfg
        n = stream_frame_count(sig.shape[0], cfg.window, cfg.hop)
        stride = cfg.batch_windows * cfg.hop
        sweep_frames = ring_depth * cfg.batch_windows
        n_sweeps = -(-n // sweep_frames)
        total = (n_sweeps * ring_depth - 1) * stride + self.chunk_samples
        keep = min(sig.shape[0], total)
        buf = torch.zeros(total, dtype=sig.dtype, device=self.device)
        buf[:keep].copy_(sig[:keep])
        retired = torch.zeros(n_sweeps, dtype=torch.int32,
                              device=self.device)
        out = graph_alloc_outputs(self._graph, (n_sweeps * sweep_frames,),
                                  cfg.window, sig.dtype, cfg.outputs,
                                  self.device)
        for s in range(n_sweeps):
            ring = buf.as_strided((ring_depth, self.chunk_samples),
                                  (stride, 1), s * ring_depth * stride)
            rows = slice(s * sweep_frames, (s + 1) * sweep_frames)
            graph_ring_call(ring, self._operands, graph=self._graph,
                            window=cfg.window, hop=cfg.hop,
                            block_frames=cfg.block_rows,
                            outputs=cfg.outputs,
                            out={k: v[rows] for k, v in out.items()},
                            retired=retired[s],
                            valid_frames=n - s * sweep_frames)
        return out, retired

    def _drain(self, retired: torch.Tensor) -> None:
        """Retire the device counter into the telemetry: per-sweep counts
        -> cumulative per-sweep snapshots -> one `record_retire` per drain
        point (every `drain_interval` sweeps, plus the final partial
        interval). The drained DELTAS sum to the host path's per-batch
        retire total."""
        snaps = retired.cumsum(0).cpu().tolist()
        k = self.rcfg.drain_interval
        points = list(range(k - 1, len(snaps), k))
        # the end-of-signal drain always happens, even when the loop ran
        # fewer sweeps than one drain interval
        if not points or points[-1] != len(snaps) - 1:
            points.append(len(snaps) - 1)
        self.last_drains = [int(snaps[p]) for p in points]
        prev = 0
        for cum in self.last_drains:
            # a death here leaves the earlier drains recorded
            if self.injector is not None:
                self.injector.on_drain(self.column)
            if self.telemetry is not None:
                self.telemetry.record_retire(self.stream_id, cum - prev)
            prev = cum

    def process(self, signal) -> dict:
        """All framed outputs for `signal`, bit-identical to the
        host-driven `BiosignalStream.process` on the same device."""
        cfg = self.cfg
        sig = stream_signal(signal, self.device)
        n = stream_frame_count(sig.shape[0], cfg.window, cfg.hop)
        if n == 0:
            # same degenerate contract as the host path: no frames, no
            # retires, the canonical empty dict
            self.last_drains = []
            return graph_empty_outputs(self._graph, cfg.window, sig.dtype,
                                       cfg.outputs, self.device)
        ring_depth = self._ring_depth(n)
        outs, retired = guarded_dispatch(
            lambda: self._run(sig, ring_depth), injector=self.injector,
            retry=self._retry, column=self.column)
        self._drain(retired)
        return {k: v[:n] for k, v in outs.items()}
