"""Serving runtimes: the host-driven stream and the resident loop."""
