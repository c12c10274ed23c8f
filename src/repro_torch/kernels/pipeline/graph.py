"""Graph compiler and entries: registered stages -> one fused application.

A `StageGraph` names a chain of registered stages, binds their table
operands, and declares the per-frame outputs. Three entries run a graph:

* `graph_frames_call` — pre-framed (R, S) window batches;
* `graph_stream_call` — a RAW 1-D signal cut into overlapping
  (window, hop) frames;
* `graph_ring_call` — a (ring_depth, span) ring of raw chunks, the
  dispatch of the resident loop (`serve/resident.py`).

Each entry dispatches on the device of its input tensor: a CUDA tensor
launches the graph's registered kernel (`csrc/biosignal_graph.cu` for
``"biosignal"``, `csrc/asr_graph.cu` for ``"asr"``, both through
`cuda.py`), a CPU tensor runs the plain
PyTorch version — the FIR, then the stage bodies in dataflow order. There
is no fallback between the two: a CUDA tensor whose graph has no kernel
raises.

Frame ``f`` of slot ``r`` starts at sample ``r*slot_stride +
f*frame_stride`` of the input: ``frame_stride`` is the window for
pre-framed rows and the hop for a raw signal, ``slot_stride`` the row
stride of a ring. Every entry runs the same per-frame code, each frame
filtered with zero history before its first sample, so on one device
stream == framed == ring slot to the last bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.fir import fir_direct
from repro_torch.device import resolve_device
from repro_torch.kernels.pipeline.stages import (OperandMismatchError,
                                                 StageGraphError,
                                                 UnknownGraphError,
                                                 get_stage, register_stage)

__all__ = ["OutputSpec", "StageGraph", "build_graph", "stages_to_run",
           "canonical_graph_outputs", "graph_empty_outputs",
           "register_graph_factory", "get_graph_factory", "default_app",
           "registered_graphs", "graph_frames_call", "graph_stream_call",
           "graph_ring_call", "graph_frames_plain", "graph_stream_plain",
           "graph_ring_plain", "graph_alloc_outputs", "stream_frame_count",
           "min_stream_block_frames", "resolve_stream_block_frames",
           "ring_chunk_samples", "block_frames_pool"]


# ---------------------------------------------------------------------------
# Framing arithmetic
# ---------------------------------------------------------------------------

def stream_frame_count(n_samples: int, window: int, hop: int) -> int:
    return 0 if n_samples < window else 1 + (n_samples - window) // hop


def min_stream_block_frames(window: int, hop: int) -> int:
    """Smallest legal frame-block of the reference's chunked schedule (the
    body chunk must cover the window - hop overlap spill). Kept for the
    framing arithmetic's callers; the CUDA kernel has no such floor."""
    return 1 if window <= hop else -(-(window - hop) // hop)


def resolve_stream_block_frames(n_frames: int, window: int, hop: int,
                                override: int | None = None) -> int:
    """The reference's frames-per-grid-step rule: ``override`` or
    min(n_frames, 8), never below `min_stream_block_frames`."""
    rb = override or min(max(n_frames, 1), 8)
    return max(1, rb, min_stream_block_frames(window, hop))


def ring_chunk_samples(window: int, hop: int, batch_windows: int) -> int:
    """Samples per ring slot: one `batch_windows`-frame dispatch's span —
    the same arithmetic as `serve.stream.BiosignalStream.chunk_samples`."""
    return (batch_windows - 1) * hop + window


@register_stage("fir", kind="fir", operands=("fir_taps",),
                produces=("filtered",))
def _fir_body(state, tables, params):
    """The mandatory first stage: a causal k-tap FIR over each frame with
    zero history before the frame's first sample."""
    return {"filtered": fir_direct(state["raw"], tables["fir_taps"])}


# ---------------------------------------------------------------------------
# Graph definition
# ---------------------------------------------------------------------------

_DTYPES = {"float32": torch.float32, "int32": torch.int32}


@dataclasses.dataclass(frozen=True)
class OutputSpec:
    """Shape/dtype contract of one per-frame graph output.

    ``shape`` is the TRAILING shape per frame: a tuple of ints or
    symbolic keys — ``"window"`` (the runtime frame length) or the name
    of a graph param (e.g. ``"n_features"``). The empty tuple means a
    scalar per frame (an (R,) tensor, like the biosignal ``class``).
    ``dtype`` is ``"float32"`` | ``"int32"`` | ``"input"`` (the signal's
    own dtype — the big elidable ``filtered`` output uses it)."""
    shape: tuple
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in ("float32", "int32", "input"):
            raise StageGraphError(f"OutputSpec dtype {self.dtype!r}")

    def resolve(self, window: int, params: dict) -> tuple:
        out = []
        for d in self.shape:
            if isinstance(d, str):
                d = window if d == "window" else params[d]
            out.append(int(d))
        return tuple(out)

    def torch_dtype(self, input_dtype: torch.dtype) -> torch.dtype:
        return input_dtype if self.dtype == "input" else _DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class StageGraph:
    """A fused application: registered stages + operand binding + outputs.
    ``params`` must carry ``n_taps`` and ``fft_size`` (the rFFT segment
    length, also the minimum legal window). Build via `build_graph`,
    which validates the wiring with the typed `stages.py` errors."""
    name: str
    stages: tuple                    # Stage objects, dataflow order
    outputs: tuple                   # ((name, OutputSpec), ...)
    operands: tuple                  # table names, binding order
    params: tuple                    # ((key, value), ...) static scalars

    def param(self, key: str):
        return dict(self.params)[key]

    @property
    def n_taps(self) -> int:
        return int(self.param("n_taps"))

    @property
    def fft_size(self) -> int:
        return int(self.param("fft_size"))

    @property
    def output_names(self) -> tuple:
        return tuple(n for n, _ in self.outputs)

    @property
    def output_specs(self) -> dict:
        return dict(self.outputs)


def build_graph(name: str, stage_names, outputs, operands,
                params) -> StageGraph:
    """Resolve + validate a `StageGraph`.

    Checks, each with a typed error from `stages.py`:
    unknown stage name (`UnknownStageError`); first stage not a FIR, a
    later FIR, an output no stage produces, duplicate state keys, or a
    missing required param (`StageGraphError`); a stage operand the
    graph doesn't bind, an operand no stage reads, or a stage requiring
    state nothing earlier produced (`OperandMismatchError`)."""
    stages = tuple(get_stage(s) if isinstance(s, str) else s
                   for s in stage_names)
    outputs = tuple((n, spec) for n, spec in outputs)
    operands = tuple(operands)
    params = tuple(params)
    if not stages:
        raise StageGraphError(f"graph {name!r}: needs at least one stage")
    if stages[0].kind != "fir":
        raise StageGraphError(
            f"graph {name!r}: first stage must be kind='fir', got "
            f"{stages[0].name!r}")
    if any(s.kind == "fir" for s in stages[1:]):
        raise StageGraphError(
            f"graph {name!r}: only the first stage may be kind='fir'")
    pdict = dict(params)
    for need in ("n_taps", "fft_size"):
        if need not in pdict:
            raise StageGraphError(f"graph {name!r}: missing param {need!r}")
    bound = set(operands)
    read: set = set()
    produced: set = set()
    for s in stages:
        missing = [o for o in s.operands if o not in bound]
        if missing:
            raise OperandMismatchError(
                f"graph {name!r}: stage {s.name!r} reads operands "
                f"{missing} the graph does not bind (bound: "
                f"{list(operands)})")
        read |= set(s.operands)
        unmet = [r for r in s.requires if r not in produced]
        if unmet:
            raise OperandMismatchError(
                f"graph {name!r}: stage {s.name!r} requires state {unmet} "
                f"no earlier stage produces")
        dup = [p for p in s.produces if p in produced]
        if dup:
            raise StageGraphError(
                f"graph {name!r}: stage {s.name!r} re-produces {dup}")
        produced |= set(s.produces)
    unread = [o for o in operands if o not in read]
    if unread:
        raise OperandMismatchError(
            f"graph {name!r}: bound operands {unread} are read by no stage")
    for n, _spec in outputs:
        if n not in produced:
            raise StageGraphError(
                f"graph {name!r}: output {n!r} is produced by no stage")
    return StageGraph(name=name, stages=stages, outputs=outputs,
                      operands=operands, params=params)


def stages_to_run(graph: StageGraph, outputs: tuple) -> tuple:
    """The MAP stages that must execute for this output selection: a
    reverse dataflow walk — a stage runs iff a requested output
    transitively depends on its products. (The FIR always runs.)"""
    needed = set(outputs)
    run = []
    for s in reversed(graph.stages[1:]):
        if needed & set(s.produces):
            run.append(s)
            needed |= set(s.requires)
    return tuple(reversed(run))


def canonical_graph_outputs(graph: StageGraph, outputs) -> tuple:
    """Validate + canonically order an output selection against the
    graph's declared outputs (`None` = all of them)."""
    names = graph.output_names
    if outputs is None:
        return names
    sel = tuple(outputs)
    bad = [o for o in sel if o not in names]
    if bad:
        raise StageGraphError(
            f"graph {graph.name!r}: unknown outputs {bad}; choose from "
            f"{names}")
    if not sel:
        raise StageGraphError("outputs selection must not be empty")
    return tuple(o for o in names if o in sel)


def _output_shapes(graph: StageGraph, rows: tuple, window: int,
                   dtype: torch.dtype, outputs: tuple) -> dict:
    params = dict(graph.params)
    specs = graph.output_specs
    return {o: (rows + specs[o].resolve(window, params),
                specs[o].torch_dtype(dtype)) for o in outputs}


def graph_empty_outputs(graph: StageGraph, window: int, dtype,
                        outputs=None, device="cuda") -> dict:
    """The zero-frame result for a graph, with the SAME keys/shapes/
    dtypes as a non-empty call, on ``device`` (raises for the default
    ``"cuda"`` on a host without a card)."""
    outputs = canonical_graph_outputs(graph, outputs)
    device = resolve_device(device)
    return {o: torch.zeros(shape, dtype=dt, device=device)
            for o, (shape, dt) in _output_shapes(graph, (0,), window, dtype,
                                                 outputs).items()}


def graph_alloc_outputs(graph: StageGraph, rows: tuple, window: int,
                        dtype, outputs: tuple, device) -> dict:
    """Uninitialised output tensors of leading shape ``rows`` — what an
    entry hands the kernel to write into."""
    return {o: torch.empty(shape, dtype=dt, device=device)
            for o, (shape, dt) in _output_shapes(graph, rows, window, dtype,
                                                 outputs).items()}


# ---------------------------------------------------------------------------
# Graph factory registry (name -> factory building (graph, operands))
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Registration:
    factory: Callable            # factory(app) -> (StageGraph, operands)
    default_app: Callable | None  # default_app(device=...) -> app
    kernel: Callable | None      # the graph's CUDA launcher (see _launch)
    block_pool: Callable | None  # block_pool(graph) -> (default, max)


_GRAPHS: dict[str, _Registration] = {}


def register_graph_factory(name: str, factory: Callable, *,
                           default_app: Callable | None = None,
                           kernel: Callable | None = None,
                           block_pool: Callable | None = None) -> None:
    """Register a named graph: ``factory(app) -> (graph, operands)``
    binds an application's tables to the graph's operand list;
    ``default_app(device=...)`` builds the app used when a caller passes
    none; ``kernel`` is the graph's CUDA launcher, called for CUDA
    tensors with the framing of `_launch`; ``block_pool(graph)`` gives
    the kernel's (default, largest useful) frames a block, from which
    `core.autotune` draws its candidates (required with a ``kernel``)."""
    if name in _GRAPHS:
        raise StageGraphError(f"graph {name!r} is already registered")
    if (kernel is None) != (block_pool is None):
        raise StageGraphError(f"graph {name!r}: a kernel and its block_pool "
                              f"come together")
    _GRAPHS[name] = _Registration(factory, default_app, kernel, block_pool)


def _registration(name: str) -> _Registration:
    if name not in _GRAPHS:
        import repro_torch.kernels.pipeline.asr  # noqa: F401 (registers "asr")
        import repro_torch.kernels.pipeline.kernel  # noqa: F401 (biosignal)
    try:
        return _GRAPHS[name]
    except KeyError:
        raise UnknownGraphError(
            f"unknown graph {name!r}; registered: "
            f"{sorted(_GRAPHS)}") from None


def get_graph_factory(name: str) -> Callable:
    """Resolve a graph name to its factory; raises the typed
    `UnknownGraphError` on a miss."""
    return _registration(name).factory


def default_app(name: str, *, device="cuda"):
    """The registered default application instance for a graph name."""
    builder = _registration(name).default_app
    if builder is None:
        raise StageGraphError(f"graph {name!r} registered no default app")
    return builder(device=device)


def block_frames_pool(graph: StageGraph) -> tuple:
    """(default, largest useful or None) frames a CUDA block of the
    graph's kernel runs — the pool `core.autotune` tunes over."""
    pool = _registration(graph.name).block_pool
    if pool is None:
        raise StageGraphError(f"graph {graph.name!r} registered no kernel "
                              f"to tune")
    return pool(graph)


def registered_graphs() -> tuple:
    return tuple(sorted(_GRAPHS))


# ---------------------------------------------------------------------------
# The plain version: FIR, then the elided stage chain
# ---------------------------------------------------------------------------

def graph_frames_plain(frames: torch.Tensor, operands, *,
                       graph: StageGraph, outputs=None) -> dict:
    """The graph on (R, S) frames in plain PyTorch, on any device: the FIR
    stage, the map stages the selection needs, then the requested outputs
    cast to their declared dtypes. The CPU path of the entries, and what
    the kernel is held to on the card."""
    outputs = canonical_graph_outputs(graph, outputs)
    tables = dict(zip(graph.operands, operands))
    params = dict(graph.params)
    state = {"raw": frames.to(torch.float32)}
    state.update(graph.stages[0].body(state, tables, params))
    for stage in stages_to_run(graph, outputs):
        state.update(stage.body(state, tables, params))
    specs = graph.output_specs
    return {o: state[o].to(specs[o].torch_dtype(frames.dtype))
            for o in outputs}


def graph_stream_plain(signal: torch.Tensor, operands, *, graph: StageGraph,
                       window: int, hop: int, outputs=None) -> dict:
    """`graph_frames_plain` on the materialised (window, hop) frames of a
    1-D signal (at least one frame)."""
    frames = signal.unfold(0, window, hop).contiguous()
    return graph_frames_plain(frames, operands, graph=graph, outputs=outputs)


def graph_ring_plain(ring: torch.Tensor, operands, *, graph: StageGraph,
                     window: int, hop: int, outputs=None) -> dict:
    """`graph_stream_plain` per ring slot, stacked to (D, n, ...)."""
    slots = [graph_stream_plain(ring[r], operands, graph=graph,
                                window=window, hop=hop, outputs=outputs)
             for r in range(ring.shape[0])]
    return {o: torch.stack([s[o] for s in slots]) for o in slots[0]}


# ---------------------------------------------------------------------------
# Entries
# ---------------------------------------------------------------------------

def _launch(graph: StageGraph, x: torch.Tensor, operands, *, entry: str,
            window: int, n_frames: int, frame_stride: int, n_slots: int,
            slot_stride: int, outputs: tuple, block_frames: int | None,
            out: dict | None, retired: torch.Tensor | None = None,
            valid_rows: int | None = None) -> dict:
    """Launch the graph's CUDA kernel over ``n_slots * n_frames`` frames
    of ``x``; returns flat (n_slots * n_frames, ...) outputs. The kernel
    adds to ``retired`` the frames it wrote among the first
    ``valid_rows``."""
    kernel = _registration(graph.name).kernel
    if kernel is None:
        raise NotImplementedError(
            f"graph {graph.name!r} has no CUDA kernel in this port")
    if out is None:
        out = graph_alloc_outputs(graph, (n_slots * n_frames,), window,
                                  x.dtype, outputs, x.device)
    kernel(x, operands, graph=graph, entry=entry, window=window,
           n_frames=n_frames, frame_stride=frame_stride, n_slots=n_slots,
           slot_stride=slot_stride, outputs=outputs,
           block_frames=block_frames, out=out, retired=retired,
           valid_rows=valid_rows)
    return out


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"tensor on unsupported device {x.device}")
    return x.device.type


def _check_window(graph: StageGraph, window: int, hop: int) -> None:
    if window < graph.fft_size:
        raise ValueError(f"window {window} < fft_size {graph.fft_size}")
    if not 0 < hop <= window:
        raise ValueError(f"hop {hop} must be in (0, window={window}]")


def graph_frames_call(frames: torch.Tensor, operands, *, graph: StageGraph,
                      block_rows: int | None = None, outputs=None) -> dict:
    """The graph on pre-framed (R, S) windows, S >= fft_size. Returns the
    requested outputs over the R rows. ``block_rows`` is the frames each
    CUDA block runs (default 1); the CPU path ignores it."""
    outputs = canonical_graph_outputs(graph, outputs)
    if frames.ndim != 2:
        raise ValueError(f"frames must be (R, S), got {tuple(frames.shape)}")
    R, S = frames.shape
    _check_window(graph, S, S)
    if R == 0:
        return graph_empty_outputs(graph, S, frames.dtype, outputs,
                                   frames.device)
    if _device_kind(frames) == "cuda":
        if not frames.is_contiguous():
            raise ValueError("frames must be contiguous on the card")
        return _launch(graph, frames, operands, entry="frames", window=S,
                       n_frames=R, frame_stride=S, n_slots=1, slot_stride=0,
                       outputs=outputs, block_frames=block_rows, out=None)
    return graph_frames_plain(frames, operands, graph=graph, outputs=outputs)


def graph_stream_call(signal: torch.Tensor, operands, *, graph: StageGraph,
                      window: int, hop: int, block_frames: int | None = None,
                      outputs=None) -> dict:
    """The graph over a RAW 1-D signal: frame f is samples
    [f*hop, f*hop + window). Returns the `graph_frames_call` dict over
    the signal's `stream_frame_count` frames, to the last bit."""
    outputs = canonical_graph_outputs(graph, outputs)
    if signal.ndim != 1:
        raise ValueError(f"signal must be 1-D, got {tuple(signal.shape)}")
    _check_window(graph, window, hop)
    n = stream_frame_count(signal.shape[0], window, hop)
    if n == 0:
        return graph_empty_outputs(graph, window, signal.dtype, outputs,
                                   signal.device)
    if _device_kind(signal) == "cuda":
        return _launch(graph, signal, operands, entry="stream",
                       window=window, n_frames=n, frame_stride=hop,
                       n_slots=1, slot_stride=0, outputs=outputs,
                       block_frames=block_frames, out=None)
    return graph_stream_plain(signal, operands, graph=graph, window=window,
                              hop=hop, outputs=outputs)


def graph_ring_call(ring: torch.Tensor, operands, *, graph: StageGraph,
                    window: int, hop: int, block_frames: int | None = None,
                    outputs=None, out: dict | None = None,
                    retired: torch.Tensor | None = None,
                    valid_frames: int | None = None) -> dict:
    """The graph over a (ring_depth, span) ring of raw chunks in one
    launch. The ring may be a strided view (row stride = slot stride, the
    resident loop's overlapping view of one buffer); its last axis must
    be contiguous. Returns (ring_depth, frames_per_slot, ...) outputs;
    slot r is bit-identical to `graph_stream_call(ring[r])`. ``out``
    (flat (ring_depth * frames_per_slot, ...) tensors) receives the
    result in place — the resident loop's preallocated outputs.

    ``retired`` (a one-element int32 tensor on the ring's device) is the
    resident loop's retire counter: the call adds the frames it computed
    among the first ``valid_frames`` in slot-major order (default: all),
    so a tail sweep's pad frames never count. On the card the kernel
    itself does the adding."""
    outputs = canonical_graph_outputs(graph, outputs)
    if ring.ndim != 2:
        raise ValueError(f"ring must be (D, span), got {tuple(ring.shape)}")
    _check_window(graph, window, hop)
    D, span = ring.shape
    n = stream_frame_count(span, window, hop)
    if n == 0:
        raise ValueError(f"ring span {span} shorter than one {window}-window")
    if _device_kind(ring) == "cuda":
        if ring.stride(1) != 1:
            raise ValueError("ring rows must be contiguous")
        flat = _launch(graph, ring, operands, entry="ring", window=window,
                       n_frames=n, frame_stride=hop, n_slots=D,
                       slot_stride=ring.stride(0), outputs=outputs,
                       block_frames=block_frames, out=out, retired=retired,
                       valid_rows=valid_frames)
        return {o: v.reshape((D, n) + v.shape[1:]) for o, v in flat.items()}
    res = graph_ring_plain(ring, operands, graph=graph, window=window,
                           hop=hop, outputs=outputs)
    if out is not None:
        for o in outputs:
            out[o].copy_(res[o].reshape(out[o].shape))
    if retired is not None:
        retired += D * n if valid_frames is None else \
            min(max(valid_frames, 0), D * n)
    return res
