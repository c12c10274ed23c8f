"""Multi-column deal for the fused biosignal pipeline.

VWR2A scales throughput by replicating columns: the array deals passes
across identical column slices, and the paper's flexibility claim rests
on those columns being interchangeable. This module deals one signal's
frames across ``n_columns`` columns the way the reference's
`kernels/pipeline/shard.py` does:

* the raw-signal deal splits on HOP boundaries: column d owns a
  contiguous run of frames starting at frame ``offset_d`` and its chunk
  is ``signal[offset_d*hop : offset_d*hop + share_d*hop + window - hop]``
  — its body samples plus one ``window - hop`` halo from its right
  neighbour;
* ``weights`` generalises the equal deal to shares proportional to each
  column's weight (largest-remainder apportionment, so shares sum to
  exactly the frame count; a zero weight deals a column nothing);
* the pre-framed deal gives column d the row block
  ``[d*r_d, (d+1)*r_d)``, ``r_d = ceil(R / D)``.

Each column runs the single-column entry (`graph.py:graph_stream_call` /
`graph_frames_call`, so the biosignal kernel on a CUDA tensor and its
plain version on a CPU tensor) on exactly the frames it owns, and the
outputs join in column order. Where the equal deal's padded share runs
past the signal, the reference computes pad frames and trims them; here a
column computes only the frames that exist, and a column that owns none
launches nothing. Each frame reads only its own window, so every deal is
bit-identical to the single-column call.

Without a mesh (``mesh=None``) the D columns run one after another on the
input's device — the reference's path when D exceeds the device count.
With a COLUMN MESH, a tuple of D `torch.device`s (`serve.stream.
column_mesh` builds one over the host's cards), column d runs on
``mesh[d]``, as the reference's `shard_map` runs it on the d-th device of
its ``data`` axis: its chunk (or row block) goes to that device, copied
only when it differs from the input's; its operands are the app's tables
on that device, which the caller holds (`mesh_operands`, one copy a
device); on a card it launches on a CUDA stream of its own (one per
(device, column)) after the caller's stream has reached the dispatch,
and the caller's stream waits for every column before the join. The
outputs come back to the input's device. A device may repeat:
``(cuda:0,) * 4`` runs four columns on four streams of one card. A CPU
mesh is one device, so its columns run the serial path.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.pipeline.graph import (StageGraph,
                                                canonical_graph_outputs,
                                                graph_empty_outputs,
                                                graph_frames_call,
                                                graph_stream_call,
                                                staged_signal,
                                                stream_frame_count)
from repro_torch.kernels.pipeline.kernel import (OUTPUTS,
                                                 _biosignal_graph_operands)

__all__ = ["Deal", "column_frames", "column_shares", "column_chunks",
           "requeue_ranges", "pipeline_sharded", "pipeline_stream_sharded",
           "graph_sharded", "graph_stream_sharded", "data_mesh_size",
           "mesh_operands"]


def _check_columns(n_columns: int) -> None:
    if n_columns < 1:
        raise ValueError(f"n_columns must be >= 1, got {n_columns}")


def data_mesh_size(mesh) -> int:
    """The columns of a column mesh: one per device."""
    return len(mesh)


def _check_mesh(mesh, n_columns: int) -> None:
    """``mesh=None`` is the serial path by design; a given mesh whose size
    is not ``n_columns`` is a misconfiguration, refused rather than run
    serially."""
    if mesh is not None and data_mesh_size(mesh) != n_columns:
        raise ValueError(f"column mesh of {data_mesh_size(mesh)} devices for "
                         f"{n_columns} columns; build it with "
                         f"serve.stream.column_mesh(n_columns) or pass "
                         f"mesh=None for the serial columns")


def column_frames(n_frames: int, n_columns: int) -> int:
    """Frames per column of the equal deal: ceil(n_frames / D), at least
    one."""
    _check_columns(n_columns)
    return -(-max(n_frames, 1) // n_columns)


def column_shares(n_frames: int, n_columns: int,
                  weights=None) -> tuple[int, ...]:
    """Per-column frame counts of the deal.

    ``weights=None``: the equal deal — every column the padded
    `column_frames` count (the sum may exceed n_frames). With
    ``weights`` (n_columns non-negative finite numbers, sum > 0): column
    d's share is proportional to weights[d], quantised by
    largest-remainder apportionment (ties to the lower column) so the
    shares sum to EXACTLY n_frames; a zero weight gets zero frames.
    """
    _check_columns(n_columns)
    if weights is None:
        return (column_frames(n_frames, n_columns),) * n_columns
    w = [float(x) for x in weights]
    if len(w) != n_columns:
        raise ValueError(f"{len(w)} weights for {n_columns} columns")
    if not all(x >= 0.0 and x == x and x != float("inf") for x in w):
        raise ValueError(f"weights must be finite and >= 0, got {w}")
    total = sum(w)
    if total <= 0.0:
        raise ValueError("weights must not all be zero")
    ideal = [n_frames * x / total for x in w]
    base = [int(i) for i in ideal]
    # the leftover frames go to the largest fractional remainders
    order = sorted(range(n_columns), key=lambda d: (base[d] - ideal[d], d))
    for d in order[: n_frames - sum(base)]:
        base[d] += 1
    return tuple(base)


def requeue_ranges(ranges, n_columns: int,
                   weights=None) -> list[list[tuple[int, int]]]:
    """Deal a dead column's unretired frame ranges across columns.

    ``ranges`` is an ordered list of ``(start, count)`` frame runs. Their
    total is apportioned by `column_shares` (equal weights when
    ``weights`` is None, so the shares sum to exactly the total; a zero
    weight — a dead column — receives nothing), then the runs are walked
    in order and split at share boundaries. Column d gets a list of
    ``(start, count)`` runs covering exactly its share; concatenating
    the columns' runs in column order gives back the input frames in
    order, and runs landing adjacent on one column coalesce.
    """
    ranges = [(int(s), int(c)) for s, c in ranges if c > 0]
    total = sum(c for _, c in ranges)
    if total == 0:
        return [[] for _ in range(n_columns)]
    shares = column_shares(total, n_columns,
                           weights if weights is not None
                           else (1.0,) * n_columns)
    out: list[list[tuple[int, int]]] = [[] for _ in range(n_columns)]
    it = iter(ranges)
    cur_start, cur_count = 0, 0
    for d, share in enumerate(shares):
        need = share
        while need > 0:
            if cur_count == 0:
                cur_start, cur_count = next(it)
            take = min(need, cur_count)
            if out[d] and out[d][-1][0] + out[d][-1][1] == cur_start:
                out[d][-1] = (out[d][-1][0], out[d][-1][1] + take)
            else:
                out[d].append((cur_start, take))
            cur_start += take
            cur_count -= take
            need -= take
    return out


@dataclasses.dataclass(frozen=True)
class Deal:
    """One column deal (`column_chunks`): ``chunks`` the (D, L) staged
    signal (None when the signal frames to nothing), ``n_frames`` the
    global frame count, ``shares`` the per-column frame counts. Unpacks
    as ``(chunks, n_frames, shares)``."""
    chunks: torch.Tensor | None
    n_frames: int
    shares: tuple[int, ...]

    def __iter__(self):
        return iter((self.chunks, self.n_frames, self.shares))


def _offsets(shares) -> list[int]:
    """Each column's first frame."""
    out, acc = [], 0
    for s in shares:
        out.append(acc)
        acc += s
    return out


def column_chunks(signal, window: int, hop: int, n_columns: int,
                  weights=None) -> Deal:
    """Split a raw 1-D signal into per-column chunks on hop boundaries.

    ``Deal.chunks`` is (D, L) with ``L = max(shares)*hop + window - hop``:
    row d starts at sample ``offset_d*hop`` and carries its right halo,
    zero-padded past the signal's end, so row d's first ``shares[d]``
    windows are the global frames [offset_d, offset_d + shares[d]). A
    signal shorter than one window gives ``Deal(None, 0, (0,)*D)``.
    """
    sig = torch.as_tensor(signal)
    if sig.ndim != 1:
        raise ValueError(f"signal must be 1-D, got {tuple(sig.shape)}")
    n = stream_frame_count(sig.shape[0], window, hop)
    if n == 0:
        return Deal(None, 0, (0,) * n_columns)
    shares = column_shares(n, n_columns, weights)
    L = max(shares) * hop + (window - hop)
    offsets = _offsets(shares)
    total = max(off * hop + L for off in offsets)
    if total > sig.shape[0]:
        sig = torch.cat([sig, sig.new_zeros(total - sig.shape[0])])
    return Deal(torch.stack([sig[off * hop: off * hop + L]
                             for off in offsets]), n, shares)


def _join(outs: list, outputs: tuple, n: int) -> dict:
    """The columns' outputs in column order, trimmed to ``n`` rows."""
    if len(outs) == 1:
        return {k: v[:n] for k, v in outs[0].items()}
    return {k: torch.cat([o[k] for o in outs])[:n] for k in outputs}


# ---------------------------------------------------------------------------
# The column mesh
# ---------------------------------------------------------------------------

# (device, column) -> the column's CUDA stream
_STREAMS: dict = {}


def _mesh_devices(mesh, home: torch.device) -> tuple:
    """The mesh's devices, each a `torch.device` of the input's type (a
    CUDA mesh on a host without a card raises)."""
    devs = tuple(_indexed(resolve_device(d)) for d in mesh)
    if any(d.type != home.type for d in devs):
        raise ValueError(f"column mesh {devs} for an input on {home}: the "
                         f"columns run on the input's kind of device")
    return devs


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` is the current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_operands(operands, mesh) -> dict:
    """``{device: operands there}`` for each device of a column mesh, the
    form the sharded entries take for a mesh that leaves the operands'
    device: each copy is made here, once, by whoever holds the result."""
    devs = _mesh_devices(mesh, operands[0].device)
    return {dev: tuple(t.to(dev) for t in operands)
            for dev in dict.fromkeys(devs)}


def _operands_for(operands, dev: torch.device) -> tuple:
    """The operands a column on ``dev`` reads: ``operands[dev]`` of a
    `mesh_operands` mapping, else the tuple itself."""
    return operands[dev] if isinstance(operands, dict) else operands


def _column_stream(dev: torch.device, d: int):
    key = (dev, d)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(dev)
    return _STREAMS[key]


def _run_columns(parts: list, operands, mesh, home: torch.device,
                 call) -> list:
    """``call(x, operands)`` for each column's ``(d, x)`` part, in column
    order: one after another on ``home`` without a mesh or off the card
    (a CPU mesh is one device), else column d on ``mesh[d]`` with its
    outputs back on ``home``.

    On a card each column waits on an event of the caller's stream and
    runs on a stream of its own, and the caller's stream waits on every
    column's event. A column off ``home`` also takes a stream of its own
    on ``home``: cross-device copies run on the current streams of both
    devices, so with both current its input and output copies order
    against that column only, never against the caller's stream or
    another column. Memory one stream allocated and another reads is
    recorded on the reader (`record_stream`), so the caching allocator
    hands it out again only once the reader is done: the stream keeps
    dispatches in flight.
    """
    if mesh is None:
        return [call(x, operands) for _, x in parts]
    devs = _mesh_devices(mesh, home)
    if home.type != "cuda":
        ops = _operands_for(operands, home)
        return [call(x, ops) for _, x in parts]
    caller = torch.cuda.current_stream(home)
    ready = torch.cuda.Event()
    ready.record(caller)
    outs, done = [], []
    for d, x in parts:
        dev = devs[d]
        ops = _operands_for(operands, dev)
        if any(t.device != dev for t in ops):
            raise ValueError(f"operands on {ops[0].device} for a column on "
                             f"{dev}: pass shard.mesh_operands(operands, "
                             f"mesh)")
        stream = _column_stream(dev, d)
        near = stream if dev == home else _column_stream(home, d)
        stream.wait_event(ready)
        if near is not stream:
            near.wait_event(ready)
        with torch.cuda.stream(near), torch.cuda.stream(stream):
            x.record_stream(near)
            for t in ops:
                t.record_stream(stream)
            if dev != home:
                x = x.to(dev)
            out = call(x, ops)
            if dev != home:
                out = {k: v.to(home) for k, v in out.items()}
            ev = torch.cuda.Event()
            ev.record(near)
        outs.append(out)
        done.append(ev)
    for ev in done:
        caller.wait_event(ev)
    for out in outs:
        for v in out.values():
            v.record_stream(caller)
    return outs


def _check_weights(weights, n_columns: int) -> None:
    _check_columns(n_columns)
    if weights is not None and len(weights) != n_columns:
        raise ValueError(f"{len(weights)} column weights for "
                         f"{n_columns} columns")


def graph_stream_sharded(signal: torch.Tensor, operands, *,
                         graph: StageGraph, window: int, hop: int,
                         n_columns: int, weights=None,
                         block_frames: int | None = None,
                         outputs=None, mesh=None) -> dict:
    """`graph_stream_call` dealt across ``n_columns`` columns: column d
    gets exactly the frames of its `column_shares` share that exist, on
    ``mesh[d]`` when a column mesh is given, else one after another on the
    signal's device. ``operands`` lie on the signal's device, or are a
    `mesh_operands` mapping for a mesh that leaves it. Bit-identical to
    the single-column call for any valid weight vector and mesh; one
    column is that call (a single weight deals nothing)."""
    outputs = canonical_graph_outputs(graph, outputs)
    _check_weights(weights, n_columns)
    _check_mesh(mesh, n_columns)
    if signal.ndim != 1:
        raise ValueError(f"signal must be 1-D, got {tuple(signal.shape)}")
    signal = staged_signal(signal)
    n = stream_frame_count(signal.shape[0], window, hop)
    if n_columns == 1:
        operands = _operands_for(operands, signal.device)
        return graph_stream_call(signal, operands, graph=graph,
                                 window=window, hop=hop,
                                 block_frames=block_frames, outputs=outputs)
    if n == 0:
        return graph_empty_outputs(graph, window, signal.dtype, outputs,
                                   signal.device)
    shares = column_shares(n, n_columns, weights)
    parts = []
    for d, (off, share) in enumerate(zip(_offsets(shares), shares)):
        own = min(share, n - off)       # the equal deal pads past n
        if own > 0:                     # a zero share launches nothing
            parts.append((d, signal[off * hop:
                                    off * hop + (own - 1) * hop + window]))
    return _join(_run_columns(
        parts, operands, mesh, signal.device,
        lambda x, ops: graph_stream_call(
            x, ops, graph=graph, window=window, hop=hop,
            block_frames=block_frames, outputs=outputs)), outputs, n)


def graph_sharded(frames: torch.Tensor, operands, *, graph: StageGraph,
                  n_columns: int, block_rows: int | None = None,
                  outputs=None, mesh=None) -> dict:
    """`graph_frames_call` on pre-framed (R, S) windows, row block d of
    ceil(R / D) rows on column d: on ``mesh[d]`` when a column mesh is
    given, else the columns one after another on the frames' device; a
    block past the last row launches nothing. ``operands`` as in
    `graph_stream_sharded`."""
    outputs = canonical_graph_outputs(graph, outputs)
    _check_columns(n_columns)
    _check_mesh(mesh, n_columns)
    if frames.ndim != 2:
        raise ValueError(f"frames must be (R, S), got {tuple(frames.shape)}")
    R = frames.shape[0]
    if R == 0 or n_columns == 1:
        operands = _operands_for(operands, frames.device)
        return graph_frames_call(frames, operands, graph=graph,
                                 block_rows=block_rows, outputs=outputs)
    r_d = column_frames(R, n_columns)
    parts = [(d, frames[r0: r0 + r_d])
             for d, r0 in enumerate(range(0, R, r_d))]
    return _join(_run_columns(
        parts, operands, mesh, frames.device,
        lambda x, ops: graph_frames_call(
            x, ops, graph=graph, block_rows=block_rows, outputs=outputs)),
        outputs, R)


def _entry_operands(taps, w, b, fft_size: int, device, mesh,
                    n_columns: int):
    """(graph, operands) of a (taps, w, b) app for a deal over ``mesh``:
    on each of its devices (`mesh_operands`) when it has several columns,
    else on ``device``."""
    graph, operands = _biosignal_graph_operands(taps, w, b, fft_size, device)
    if mesh is not None and n_columns > 1:
        _check_mesh(mesh, n_columns)
        operands = mesh_operands(operands, mesh)
    return graph, operands


def pipeline_stream_sharded(signal, taps, w, b, *, window: int, hop: int,
                            n_columns: int, mesh=None, fft_size: int = 512,
                            block_frames: int | None = None,
                            outputs=OUTPUTS, weights=None) -> dict:
    """The biosignal pipeline over a RAW 1-D signal dealt across
    ``n_columns`` columns (`graph_stream_sharded`), on the column mesh
    ``mesh`` when given; ``weights`` makes the deal non-uniform (e.g.
    measured per-column rates)."""
    graph, operands = _entry_operands(taps, w, b, fft_size, signal.device,
                                      mesh, n_columns)
    return graph_stream_sharded(signal, operands, graph=graph,
                                window=window, hop=hop, n_columns=n_columns,
                                weights=weights, block_frames=block_frames,
                                outputs=outputs, mesh=mesh)


def pipeline_sharded(frames, taps, w, b, *, n_columns: int, mesh=None,
                     fft_size: int = 512, block_rows: int | None = None,
                     outputs=OUTPUTS) -> dict:
    """The biosignal pipeline on pre-framed (R, S) windows, row blocks
    dealt across ``n_columns`` columns (`graph_sharded`), on the column
    mesh ``mesh`` when given."""
    graph, operands = _entry_operands(taps, w, b, fft_size, frames.device,
                                      mesh, n_columns)
    return graph_sharded(frames, operands, graph=graph, n_columns=n_columns,
                         block_rows=block_rows, outputs=outputs, mesh=mesh)
