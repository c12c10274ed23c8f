"""Serving runtimes: the host-driven stream and the resident loop, the
fault-tolerant column runner, the LM engines (dense `Engine`, paged
`PagedEngine`, the supervised `FaultTolerantEngine` and
`FaultTolerantPagedEngine`), the unified front-end `ServeFrontend` and
the serving steps over a mesh (`make_serve_step`).

The public names below load their module on first use, so importing one
serving module does not import the others."""
import importlib

_EXPORTS = {
    "Request": "engine", "Engine": "engine", "PagedEngine": "engine",
    "ColumnScheduler": "engine",
    "FaultTolerantEngine": "engine_fault",
    "FaultTolerantPagedEngine": "engine_fault",
    "StreamOpen": "frontend", "AsrTranscribe": "frontend",
    "AsrResult": "frontend", "Ticket": "frontend",
    "ServeFrontend": "frontend",
    "PagePool": "paged", "PageTable": "paged", "SCRATCH_PAGE": "paged",
    "FaultInjector": "fault", "VirtualClock": "fault",
    "FaultTolerantColumnRunner": "fault",
    "BiosignalStream": "stream", "StreamConfig": "stream",
    "ResidentStream": "resident", "ResidentConfig": "resident",
    "ServeBundle": "step", "make_serve_step": "step",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
