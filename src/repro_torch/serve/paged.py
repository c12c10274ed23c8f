"""Paged KV cache: fixed-size pages in one preallocated pool, per-request
block tables, and the gather/scatter that turns pages back into dense
attention views (the port's counterpart of the JAX package's
`serve/paged.py`).

The pool is the software analogue of VWR2A's scratchpad banks: one fixed
physical memory, time-shared between tenants through an indirection
table, where the dense engine's per-slot caches are private memories
sized for the worst case (``slots * max_len`` rows, mostly empty). Under
paging a request holds exactly ``ceil(need / page_size)`` pages, so
ADMISSION IS BOUNDED BY FREE PAGES, not by the decode batch width
(`serve/engine.py:PagedEngine`).

LAYOUT. One logical page-id space is shared by ALL cache leaves: page j
is row j of every pool leaf (`models.transformer.paged_pool_schema`
shapes each leaf ``(n_pages, page_size, *rest)``; a stacked leaf's
"layers" axis sits in ``rest``). A request holding pages ``(p0, p1,
...)`` stores the K/V of positions ``[i*page_size, (i+1)*page_size)`` in
page ``p_i``; for a ring (sliding-window) leaf the positions are its W
ring slots, so the ring decode path runs unchanged on the gathered view.
PAGE 0 IS SCRATCH: never allocated; block-table padding for empty lanes
and positions past a request's allocation point at it, and those
positions are always masked. Pool leaves start as zeros (never
uninitialised memory): a masked position adds ``0 * V[row]``, which a
NaN or an infinity in a stale row would poison.

DISPATCH. `paged_prefill` and `paged_decode` each run one engine
dispatch: gather the views through the block table, run the model's
prefill or decode on them, scatter the written rows back to their pages.
The reference fuses the three in one jit; here they are plain PyTorch
calls on the pool's device.

Allocation is lowest-id-first off a heap, `free` returns pages for
immediate reuse, and `PageTable.defrag` compacts the allocated set onto
the lowest ids (one row permutation per pool leaf). Allocation never
fragments (the table makes pages interchangeable), so defrag is a
compaction pass, and decoding through it continues bitwise.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as att
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import tree_from_items, tree_items
from repro_torch.serve.errors import InsufficientPages, PagedCacheUnsupported

__all__ = ["SCRATCH_PAGE", "LeafSpec", "leaf_specs", "PagePool",
           "PageTable", "paged_decode", "paged_prefill",
           "prefill_table_width"]

SCRATCH_PAGE = 0


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Per-leaf paging metadata.

    ``shape``/``dtype`` are the per-request dense leaf (batch size 1);
    ``seq_len`` its sequence capacity (max_len, or W for a ring leaf);
    ``ring`` whether the leaf is a sliding-window ring (its view must be
    exactly W long for the ring decode path to trigger)."""
    batch_ax: int
    seq_ax: int
    seq_len: int
    ring: bool
    shape: tuple
    dtype: torch.dtype


def leaf_specs(model, max_len: int):
    """(paths, specs) of a model's cache tree, leaves in sorted-key order;
    raises the typed `PagedCacheUnsupported` for a model whose cache
    cannot be paged (recurrent state has no sequence axis; an
    encoder-decoder admits token at a time against its encoder context)
    before any view is built."""
    cfg = model.cfg
    if getattr(cfg, "ssm", None) is not None:
        raise PagedCacheUnsupported(
            "recurrent state (rwkv/mamba) has no sequence axis to page "
            "over; serve SSM models on the dense Engine")
    if getattr(cfg, "is_encdec", False):
        raise PagedCacheUnsupported(
            "enc-dec decoders admit token-at-a-time against an encoder "
            "context; serve them on the dense Engine")
    paths, specs = [], []
    for path, p in tree_items(model.cache_schema(1, max_len)):
        if "batch" not in p.axes or "seq" not in p.axes:
            raise PagedCacheUnsupported(
                f"cache leaf with axes {p.axes} has no (batch, seq) pair")
        b, s = p.axes.index("batch"), p.axes.index("seq")
        if b > s:
            raise PagedCacheUnsupported(
                f"cache leaf with axes {p.axes}: the paged gather needs "
                f"batch before seq")
        seq_len = p.shape[s]
        paths.append(path)
        specs.append(LeafSpec(b, s, seq_len, seq_len < max_len,
                              tuple(p.shape), p.dtype or torch.float32))
    return tuple(paths), tuple(specs)


class PagePool:
    """The preallocated physical pool on ``device``: one zeroed leaf per
    cache leaf, a shared free list over the logical page-id space, page 0
    reserved as scratch. ``capacity`` is the allocatable page count."""

    def __init__(self, model, *, page_size: int = 16, n_pages: int = 64,
                 max_len: int = 256, device="cuda"):
        if page_size < 1 or n_pages < 2:
            raise ValueError(f"page_size {page_size} and n_pages {n_pages}: "
                             f"need at least 1 and 2")
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.max_len = int(max_len)
        self.device = resolve_device(device)
        self.paths, self.specs = leaf_specs(model, max_len)
        pool_schema = tfm.paged_pool_schema(
            model.cfg, model.plan, n_pages=n_pages, page_size=page_size,
            max_len=max_len)
        self.leaves = [torch.zeros(p.shape, dtype=p.dtype or torch.float32,
                                   device=self.device)
                       for _, p in tree_items(pool_schema)]
        self._free: list[int] = list(range(1, n_pages))  # heap, 0=scratch
        self._held: set[int] = set()

    @property
    def capacity(self) -> int:
        return self.n_pages - 1          # page 0 is scratch

    @property
    def n_free(self) -> int:
        return len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        """Worst-case page footprint of a sequence of ``n_tokens``: the
        max over leaves of the pages covering the leaf's share of it (a
        ring leaf never needs more than its W slots)."""
        ps = self.page_size
        return max(-(-min(int(n_tokens), sp.seq_len) // ps)
                   for sp in self.specs)

    def alloc(self, n: int) -> tuple[int, ...]:
        """Allocate ``n`` pages, lowest ids first (the same admission
        order always yields the same tables). Raises the typed
        `InsufficientPages` on over-allocation."""
        if n > len(self._free):
            raise InsufficientPages(n, len(self._free), self.capacity)
        ids = tuple(heapq.heappop(self._free) for _ in range(n))
        self._held.update(ids)
        return ids

    def free(self, ids) -> None:
        for i in ids:
            if i not in self._held:
                raise ValueError(f"freeing unallocated page {i}")
            self._held.discard(i)
            heapq.heappush(self._free, i)


class PageTable:
    """Per-request block tables over a `PagePool`: who holds which pages,
    and the (lanes, Q) int32 tables the dispatches gather through."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._pages: dict = {}          # rid -> tuple of page ids

    def assign(self, rid, n_pages: int) -> tuple[int, ...]:
        if rid in self._pages:
            raise ValueError(f"rid {rid} already holds pages")
        ids = self.pool.alloc(n_pages)
        self._pages[rid] = ids
        return ids

    def release(self, rid) -> None:
        self.pool.free(self._pages.pop(rid))

    def pages(self, rid) -> tuple[int, ...]:
        return self._pages[rid]

    def holds(self, rid) -> bool:
        return rid in self._pages

    def holders(self) -> list:
        return sorted(self._pages)

    def block_table(self, rids, width: int | None = None) -> np.ndarray:
        """(len(rids), width) int32 table; ``None`` entries (empty lanes)
        and columns past a request's allocation pad with the scratch
        page. ``width`` defaults to the widest holder present (min 1); a
        narrower one truncates (a prefill table addresses only the pages
        its prompt touches)."""
        rows = [self._pages.get(r, ()) if r is not None else ()
                for r in rids]
        q = width if width is not None else max(
            [len(r) for r in rows] + [1])
        bt = np.full((len(rows), q), SCRATCH_PAGE, np.int32)
        for i, r in enumerate(rows):
            k = min(len(r), q)
            bt[i, :k] = r[:k]
        return bt

    def defrag(self) -> dict[int, int]:
        """Compact the allocated set onto the lowest page ids. Returns the
        ``{old: new}`` moves applied; block tables are rewritten and every
        pool leaf's moved rows copied in one permutation. Decode through
        a defrag continues bitwise: every view has the same rows."""
        held = sorted(self.pool._held)
        targets = list(range(1, len(held) + 1))
        moves = {old: new for old, new in zip(held, targets) if old != new}
        if not moves:
            return moves
        dev = self.pool.device
        src = torch.as_tensor(list(moves.keys()), device=dev)
        dst = torch.as_tensor(list(moves.values()), device=dev)
        _permute_pages(self.pool.leaves, src, dst)
        self._pages = {rid: tuple(moves.get(p, p) for p in pages)
                       for rid, pages in self._pages.items()}
        self.pool._held = set(targets)
        self.pool._free = [p for p in range(1, self.pool.n_pages)
                           if p not in self.pool._held]
        heapq.heapify(self.pool._free)
        return moves


def _permute_pages(pools, src, dst) -> None:
    """Copy rows ``src`` onto rows ``dst`` in every pool leaf, in place.
    The right-hand side gathers ``src`` into a new tensor before the
    scatter, so overlapping src/dst sets permute correctly."""
    for pool in pools:
        pool[dst] = pool[src]


# ---------------------------------------------------------------------------
# The two dispatches
# ---------------------------------------------------------------------------

def _gather_views(pools, bt, specs):
    return [att.gather_page_view(pool, bt, batch_ax=sp.batch_ax,
                                 seq_ax=sp.seq_ax, seq_len=sp.seq_len)
            for pool, sp in zip(pools, specs)]


def paged_decode(decode_fn, paths, specs, params, batch, pools, bt):
    """One decode step through the block table ``bt`` ((lanes, Q) integer
    tensor on the pools' device): gather per-leaf views, run the model's
    decode on them (the linear and ring cache paths unchanged), write
    each lane's new row back to its page in place. Returns
    ``(logits, pools)``."""
    bt = bt.long()
    views = _gather_views(pools, bt, specs)
    logits, new_cache = decode_fn(params, batch,
                                  tree_from_items(zip(paths, views)))
    pos = torch.as_tensor(batch["cache_len"], device=bt.device)
    pos = pos.reshape(-1).expand(bt.shape[0])
    for pool, (_, view), sp in zip(pools, tree_items(new_cache), specs):
        att.scatter_page_token(pool, view, bt, pos, batch_ax=sp.batch_ax,
                               seq_ax=sp.seq_ax)
    return logits, pools


def paged_prefill(prefill_fn, paths, specs, params, batch, pools, bt):
    """One prefill through the block table: run the model's prefill into
    a zero view sized to the batch's token width (a ring leaf views its
    full W), then ASSIGN the written rows to the pages the table names,
    in place (the paged replacement for the dense engine's slot merge).
    Returns ``(last_logits, pools)``."""
    bt = bt.long()
    L = bt.shape[0]
    ps = pools[0].shape[1]
    width = batch["tokens"].shape[1]
    views = []
    for pool, sp in zip(pools, specs):
        sv = sp.seq_len if sp.ring else min(sp.seq_len, -(-width // ps) * ps)
        shape = list(sp.shape)
        shape[sp.batch_ax] = L
        shape[sp.seq_ax] = sv
        views.append(torch.zeros(shape, dtype=sp.dtype, device=pool.device))
    logits, new_cache = prefill_fn(params, batch,
                                   tree_from_items(zip(paths, views)))
    for pool, (_, view), sp in zip(pools, tree_items(new_cache), specs):
        att.scatter_page_prefill(pool, view, bt, batch_ax=sp.batch_ax,
                                 seq_ax=sp.seq_ax)
    return logits, pools


def prefill_table_width(specs, page_size: int, width: int) -> int:
    """Block-table width a prefill of ``width`` tokens needs: the max over
    leaves of the pages its prefill view covers."""
    return max(
        -(-(sp.seq_len if sp.ring
            else min(sp.seq_len, -(-width // page_size) * page_size))
          // page_size)
        for sp in specs)
