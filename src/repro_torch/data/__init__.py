"""Deterministic sharded data (`pipeline`): batches as a pure function of
(seed, step, host), numpy only."""
