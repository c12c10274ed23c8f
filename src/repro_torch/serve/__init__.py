"""Serving runtimes: the host-driven stream and the resident loop, the
fault-tolerant column runner, and the LM `Engine` (`serve/engine.py`)."""
