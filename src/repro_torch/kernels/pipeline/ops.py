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

Not in this slice: ``autotune=True`` (`repro/core/autotune.py`) raises
`NotImplementedError`.
"""
from __future__ import annotations

from repro_torch.kernels import not_in_slice
from repro_torch.kernels.pipeline.graph import (default_app,
                                                get_graph_factory,
                                                graph_frames_call,
                                                graph_ring_call,
                                                graph_stream_call,
                                                ring_chunk_samples,
                                                stream_frame_count)
from repro_torch.kernels.pipeline.kernel import (OUTPUTS, canonical_outputs,
                                                 pipeline_frames,
                                                 pipeline_ring,
                                                 pipeline_stream)
from repro_torch.kernels.pipeline.shard import (pipeline_sharded,
                                                pipeline_stream_sharded)

__all__ = ["OUTPUTS", "canonical_outputs", "biosignal_pipeline",
           "biosignal_pipeline_stream", "biosignal_pipeline_ring",
           "app_pipeline", "app_pipeline_stream", "app_pipeline_ring",
           "graph_pipeline", "graph_pipeline_stream", "graph_pipeline_ring",
           "ring_chunk_samples", "stream_frame_count", "default_app"]


def biosignal_pipeline(signal, taps, w, b, *, fft_size: int = 512,
                       block_rows: int | None = None,
                       autotune: bool = False, outputs=None,
                       n_columns: int = 1) -> dict:
    """The full MBioTracker pipeline on (R, S) windows in one fused launch
    (CUDA) or the plain version (CPU). Returns the staged app's output
    dict restricted to ``outputs`` (default: all four keys).
    ``n_columns > 1`` deals row blocks across column replicas
    (`shard.pipeline_sharded`), one launch per column."""
    not_in_slice(autotune)
    if n_columns > 1:
        return pipeline_sharded(signal, taps, w, b, n_columns=n_columns,
                                fft_size=fft_size, block_rows=block_rows,
                                outputs=canonical_outputs(outputs))
    return pipeline_frames(signal, taps, w, b, fft_size=fft_size,
                           block_rows=block_rows,
                           outputs=canonical_outputs(outputs))


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
    (one per column) makes that deal non-uniform."""
    not_in_slice(autotune)
    if column_weights is not None and len(column_weights) != n_columns:
        raise ValueError(f"{len(column_weights)} column weights for "
                         f"{n_columns} columns")
    if n_columns > 1:
        return pipeline_stream_sharded(
            signal, taps, w, b, window=window, hop=hop, n_columns=n_columns,
            fft_size=fft_size, block_frames=block_frames,
            outputs=canonical_outputs(outputs), weights=column_weights)
    return pipeline_stream(signal, taps, w, b, window=window, hop=hop,
                           fft_size=fft_size, block_frames=block_frames,
                           outputs=canonical_outputs(outputs))


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
    on the frames' device)."""
    not_in_slice(autotune)
    graph, operands = _bind(name, app, frames.device)
    return graph_frames_call(frames, operands, graph=graph,
                             block_rows=block_rows, outputs=outputs)


def graph_pipeline_stream(name: str, app, signal, *, window: int, hop: int,
                          block_frames: int | None = None,
                          autotune: bool = False, outputs=None) -> dict:
    """A registered stage graph over a RAW 1-D signal with (window, hop)
    framing."""
    not_in_slice(autotune)
    graph, operands = _bind(name, app, signal.device)
    return graph_stream_call(signal, operands, graph=graph, window=window,
                             hop=hop, block_frames=block_frames,
                             outputs=outputs)


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
