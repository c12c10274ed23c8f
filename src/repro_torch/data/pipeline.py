"""Deterministic sharded data pipeline (the port's own copy of the JAX
package's `data/pipeline.py`; numpy only, so both packages make the same
batches bit for bit).

Fault tolerance by construction: a batch is a PURE FUNCTION of
(seed, step, host_id), so a restarted or rescheduled worker regenerates
its exact shard without coordination; elastic re-sharding only changes
(host_id, num_hosts) and the indexing stays disjoint and exhaustive.

Sources: ``synthetic`` (a hash-mixed token stream with local n-gram
structure, so the loss can actually decrease) or ``memmap`` (a binary
uint16 token file). Batches are numpy int32 arrays on the host; the
train step moves them to the device.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["DataConfig", "ShardedLoader"]

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64: a cheap stateless hash of uint64 values."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _MASK64
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _MASK64
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _MASK64
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | memmap
    path: Optional[str] = None
    structure: int = 97                # synthetic: n-gram period (learnable)


class ShardedLoader:
    """Yields this host's shard of the global batch for any step."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self._mm = None
        if cfg.source == "memmap":
            if not (cfg.path and Path(cfg.path).exists()):
                raise FileNotFoundError(f"token file {cfg.path!r}")
            self._mm = np.memmap(cfg.path, dtype=np.uint16, mode="r")
        elif cfg.source != "synthetic":
            raise ValueError(f"data source {cfg.source!r}")

    def _synthetic_row(self, row_key: np.ndarray) -> np.ndarray:
        c = self.cfg
        pos = np.arange(c.seq_len + 1, dtype=np.uint64)
        h = _mix(row_key[None] ^ _mix(pos // np.uint64(c.structure)))
        # a token depends on its block's hash and its place in the block,
        # so it is learnable
        tok = (h + pos % np.uint64(c.structure)) % np.uint64(c.vocab_size)
        return tok.astype(np.int32)

    def batch(self, step: int) -> dict:
        """{"tokens", "labels"}: (local_batch, seq_len) int32, the labels
        the tokens shifted by one."""
        c = self.cfg
        rows = np.arange(self.local_batch, dtype=np.uint64)
        gidx = (np.uint64(step) * np.uint64(c.global_batch)
                + np.uint64(self.host_id) * np.uint64(self.local_batch) + rows)
        if self._mm is not None:
            n = self._mm.shape[0] - (c.seq_len + 1)
            starts = (_mix(gidx ^ np.uint64(c.seed)) % np.uint64(n)).astype(
                np.int64)
            toks = np.stack([self._mm[s: s + c.seq_len + 1] for s in starts]
                            ).astype(np.int32)
        else:
            keys = _mix(gidx ^ _mix(np.full_like(gidx, c.seed)))
            toks = np.stack([self._synthetic_row(k) for k in keys])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
