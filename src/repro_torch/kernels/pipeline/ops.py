"""Public API of the fused stage-graph pipeline.

* ``biosignal_pipeline`` — pre-framed (R, S) window batches;
* ``biosignal_pipeline_stream`` — the RAW 1-D signal, overlapping
  (window, hop) frames cut by the kernel itself;
* ``biosignal_pipeline_ring`` — a (ring_depth, span) ring of raw chunks.

The ``app_pipeline*`` trio takes a `core.biosignal.BiosignalApp`; the
``graph_pipeline*`` trio takes any registered graph by name. Every entry
dispatches on the device of its input: CUDA launches the kernel, CPU runs
the plain PyTorch version. ``n_columns > 1`` deals the biosignal entries'
frames across column replicas (`shard.py`, the columns one after another
on the input's device); the other graphs are single-column, as in the
reference.

``autotune=True`` (with no explicit ``block_rows`` / ``block_frames``)
times the kernel's candidate blocks on the call's own tensors
(`core.autotune`) and caches the winner under the reference's key:
``"biosignal_pipeline[_stream]"`` for the biosignal entries (with the
column count and the weighted deal's share signature) and
``f"{graph}_pipeline[_stream]"`` for the graph entries, so winners never
leak across graphs. The block changes the speed, never the result.
"""
from __future__ import annotations

from repro_torch.core.autotune import (candidate_block_rows, dtype_name,
                                       tuned_block_rows,
                                       tuned_stream_block_frames)
from repro_torch.kernels.pipeline.graph import (block_frames_pool,
                                                default_app,
                                                get_graph_factory,
                                                graph_frames_call,
                                                graph_ring_call,
                                                graph_stream_call,
                                                ring_chunk_samples,
                                                stream_frame_count)
from repro_torch.kernels.pipeline.kernel import (OUTPUTS, biosignal_graph,
                                                 canonical_outputs,
                                                 pipeline_frames,
                                                 pipeline_ring,
                                                 pipeline_stream)
from repro_torch.kernels.pipeline.shard import (column_shares,
                                                pipeline_sharded,
                                                pipeline_stream_sharded)

__all__ = ["OUTPUTS", "canonical_outputs", "biosignal_pipeline",
           "biosignal_pipeline_stream", "biosignal_pipeline_ring",
           "app_pipeline", "app_pipeline_stream", "app_pipeline_ring",
           "graph_pipeline", "graph_pipeline_stream", "graph_pipeline_ring",
           "ring_chunk_samples", "stream_frame_count", "default_app",
           "tune_frames_block", "tune_stream_block"]


def tune_frames_block(graph, frames, outputs, run, *, n_columns: int = 1,
                      app_key: bool = False) -> int:
    """The measured frames a block for a pre-framed (R, S) call of
    ``graph``; ``run(rb)`` runs the call at that block. The key is the
    reference's: ``("biosignal_pipeline", ceil(R / D), S, fft_size,
    outputs, dtype[, D])`` for the biosignal entries (``app_key``), else
    ``(f"{graph.name}_pipeline", R, S, graph.params, outputs, dtype)``."""
    R, S = frames.shape
    dt = dtype_name(frames.dtype)
    if app_key:
        rows = -(-R // n_columns)
        name, extras = "biosignal_pipeline", (S, graph.fft_size, outputs,
                                              dt) + (
            (n_columns,) if n_columns > 1 else ())
    else:
        rows, name = R, f"{graph.name}_pipeline"
        extras = (S, graph.params, outputs, dt)
    default, max_frames = block_frames_pool(graph)
    return tuned_block_rows(name, rows, extras, run,
                            candidates=candidate_block_rows(
                                rows, default=default, max_rows=max_frames))


def tune_stream_block(graph, signal, window: int, hop: int, outputs, run, *,
                      n_columns: int = 1, weights=None) -> int | None:
    """The measured frames a block for a raw-signal call of ``graph``
    (None for a call of at most one frame, as the reference skips it);
    ``run(rb)`` runs the call at that block. The key is the reference's
    ``(f"{graph.name}_pipeline_stream", n_frames, window, hop, outputs,
    dtype[, D][, "w", *shares])``."""
    n = stream_frame_count(signal.shape[0], window, hop)
    if n <= 1:
        return None
    shares = column_shares(n, n_columns, weights) \
        if weights is not None and n_columns > 1 else None
    default, max_frames = block_frames_pool(graph)
    return tuned_stream_block_frames(
        f"{graph.name}_pipeline_stream", n, window, hop, outputs,
        dtype_name(signal.dtype), run, n_columns=n_columns, shares=shares,
        default=default, max_frames=max_frames)


def biosignal_pipeline(signal, taps, w, b, *, fft_size: int = 512,
                       block_rows: int | None = None,
                       autotune: bool = False, outputs=None,
                       n_columns: int = 1) -> dict:
    """The full MBioTracker pipeline on (R, S) windows in one fused launch
    (CUDA) or the plain version (CPU). Returns the staged app's output
    dict restricted to ``outputs`` (default: all four keys).
    ``n_columns > 1`` deals row blocks across column replicas
    (`shard.pipeline_sharded`), one launch per column. ``autotune=True``
    measures ``block_rows`` (`tune_frames_block`; the key carries D)."""
    outputs = canonical_outputs(outputs)

    def run(rb):
        if n_columns > 1:
            return pipeline_sharded(signal, taps, w, b, n_columns=n_columns,
                                    fft_size=fft_size, block_rows=rb,
                                    outputs=outputs)
        return pipeline_frames(signal, taps, w, b, fft_size=fft_size,
                               block_rows=rb, outputs=outputs)
    if autotune and block_rows is None:
        graph = biosignal_graph(len(taps), len(w), len(b), fft_size)
        block_rows = tune_frames_block(graph, signal, outputs, run,
                                       n_columns=n_columns, app_key=True)
    return run(block_rows)


def biosignal_pipeline_stream(signal, taps, w, b, *, window: int, hop: int,
                              fft_size: int = 512,
                              block_frames: int | None = None,
                              autotune: bool = False, outputs=None,
                              n_columns: int = 1,
                              column_weights=None) -> dict:
    """The pipeline over a RAW 1-D signal with (window, hop) framing.
    Equals ``biosignal_pipeline`` on the host-framed windows, to the last
    bit on one device. ``n_columns > 1`` deals hop-aligned chunks across
    column replicas (`shard.pipeline_stream_sharded`); ``column_weights``
    (one per column) makes that deal non-uniform. ``autotune=True``
    measures ``block_frames`` (`tune_stream_block`; the key carries D and
    the weighted deal's shares)."""
    if column_weights is not None and len(column_weights) != n_columns:
        raise ValueError(f"{len(column_weights)} column weights for "
                         f"{n_columns} columns")
    outputs = canonical_outputs(outputs)
    if n_columns == 1:
        # a single weight is the identity deal: it must neither reach the
        # kernel nor split the autotune key of the identical computation
        column_weights = None

    def run(rb):
        if n_columns > 1:
            return pipeline_stream_sharded(
                signal, taps, w, b, window=window, hop=hop,
                n_columns=n_columns, fft_size=fft_size, block_frames=rb,
                outputs=outputs, weights=column_weights)
        return pipeline_stream(signal, taps, w, b, window=window, hop=hop,
                               fft_size=fft_size, block_frames=rb,
                               outputs=outputs)
    if autotune and block_frames is None:
        graph = biosignal_graph(len(taps), len(w), len(b), fft_size)
        block_frames = tune_stream_block(graph, signal, window, hop, outputs,
                                         run, n_columns=n_columns,
                                         weights=column_weights)
    return run(block_frames)


def biosignal_pipeline_ring(ring, taps, w, b, *, window: int, hop: int,
                            fft_size: int = 512,
                            block_frames: int | None = None,
                            outputs=None) -> dict:
    """The pipeline over a (ring_depth, span) RING of raw chunks in one
    launch — the dispatch of the resident loop. Slot r of the result is
    bit-identical to the single-chunk call on ``ring[r]``."""
    return pipeline_ring(ring, taps, w, b, window=window, hop=hop,
                         fft_size=fft_size, block_frames=block_frames,
                         outputs=canonical_outputs(outputs))


def _bind(name: str, app, device):
    factory = get_graph_factory(name)
    return factory(app if app is not None
                   else default_app(name, device=device))


def graph_pipeline(name: str, app, frames, *,
                   block_rows: int | None = None, autotune: bool = False,
                   outputs=None) -> dict:
    """A REGISTERED stage graph on pre-framed (R, S) windows. ``app``
    binds the graph's operand tables (``None``: the graph's default app,
    on the frames' device). ``autotune=True`` measures ``block_rows``
    under ``f"{name}_pipeline"``."""
    graph, operands = _bind(name, app, frames.device)

    def run(rb):
        return graph_frames_call(frames, operands, graph=graph,
                                 block_rows=rb, outputs=outputs)
    if autotune and block_rows is None:
        block_rows = tune_frames_block(graph, frames, outputs, run)
    return run(block_rows)


def graph_pipeline_stream(name: str, app, signal, *, window: int, hop: int,
                          block_frames: int | None = None,
                          autotune: bool = False, outputs=None) -> dict:
    """A registered stage graph over a RAW 1-D signal with (window, hop)
    framing. ``autotune=True`` measures ``block_frames`` under
    ``f"{name}_pipeline_stream"``."""
    graph, operands = _bind(name, app, signal.device)

    def run(rb):
        return graph_stream_call(signal, operands, graph=graph,
                                 window=window, hop=hop, block_frames=rb,
                                 outputs=outputs)
    if autotune and block_frames is None:
        block_frames = tune_stream_block(graph, signal, window, hop, outputs,
                                         run)
    return run(block_frames)


def graph_pipeline_ring(name: str, app, ring, *, window: int, hop: int,
                        block_frames: int | None = None,
                        outputs=None) -> dict:
    """A registered stage graph over a (ring_depth, span) ring of raw
    chunks in one launch."""
    graph, operands = _bind(name, app, ring.device)
    return graph_ring_call(ring, operands, graph=graph, window=window,
                           hop=hop, block_frames=block_frames,
                           outputs=outputs)


def app_pipeline(app, signal, *, block_rows: int | None = None,
                 autotune: bool = False, outputs=None,
                 n_columns: int = 1) -> dict:
    """Fused execution of a `core.biosignal.BiosignalApp` on pre-framed
    windows."""
    return biosignal_pipeline(signal, app.fir_taps, app.svm_w, app.svm_b,
                              fft_size=app.fft_size, block_rows=block_rows,
                              autotune=autotune, outputs=outputs,
                              n_columns=n_columns)


def app_pipeline_stream(app, signal, *, window: int, hop: int,
                        block_frames: int | None = None,
                        autotune: bool = False, outputs=None,
                        n_columns: int = 1, column_weights=None) -> dict:
    """Fused raw-signal streaming execution of a `BiosignalApp`."""
    return biosignal_pipeline_stream(signal, app.fir_taps, app.svm_w,
                                     app.svm_b, window=window, hop=hop,
                                     fft_size=app.fft_size,
                                     block_frames=block_frames,
                                     autotune=autotune, outputs=outputs,
                                     n_columns=n_columns,
                                     column_weights=column_weights)


def app_pipeline_ring(app, ring, *, window: int, hop: int,
                      block_frames: int | None = None, outputs=None) -> dict:
    """Fused ring-of-chunks execution of a `BiosignalApp`."""
    return biosignal_pipeline_ring(ring, app.fir_taps, app.svm_w, app.svm_b,
                                   window=window, hop=hop,
                                   fft_size=app.fft_size,
                                   block_frames=block_frames,
                                   outputs=outputs)
