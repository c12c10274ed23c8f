"""Attention for the port's models: GQA/MHA with the kv-major padded head
layout, RoPE and M-RoPE, sliding windows, the blockwise (online-softmax)
train and prefill path, the cached decode paths (linear and ring) and
the O(S^2) oracle (`reference_attention`) that the flash-attention
kernel is held to. The JAX package's `models/attention.py`, in PyTorch.

Like the reference, the LM path calls no hand-written kernel: RoPE is
applied here in plain PyTorch and attention runs through
`blockwise_attention` / `decode_attention`. Products of activations and
weights run in the activations' dtype (bfloat16 at full width, with
float32 accumulation); scores, softmax and the value product run in
float32.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.models.layers import P, fanin_std
from repro_torch.sharding.ctx import pin
from repro_torch.sharding.local import local_call

__all__ = ["NEG_INF", "padded_heads", "head_mask", "attention_schema",
           "apply_rope", "blockwise_attention", "decode_attention",
           "decode_attention_ring", "gather_page_view",
           "scatter_page_token", "scatter_page_prefill", "project",
           "qkv_project", "out_project", "attention_block",
           "reference_attention"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Schema (with grouped head padding)
# ---------------------------------------------------------------------------

def padded_heads(cfg) -> tuple[int, int]:
    """(H_padded, group_padded): pad the per-KV-group query-head count so
    H_padded = KV * G_p is divisible by cfg.tp_pad. Head index layout is
    kv-major (h = kv * G_p + g) so GQA grouping survives the padding."""
    H, KV, tp = cfg.num_heads, cfg.num_kv_heads, max(1, cfg.tp_pad)
    G = H // KV
    Gp = G
    while (KV * Gp) % tp:
        Gp += 1
    return KV * Gp, Gp


def head_mask(cfg, dtype=torch.float32, device="cpu"):
    """(H_padded,) 1.0 for real heads, 0.0 for padding."""
    Hp, Gp = padded_heads(cfg)
    G = cfg.num_heads // cfg.num_kv_heads
    m = (np.arange(Hp) % Gp) < G
    return torch.as_tensor(m, dtype=dtype, device=device)


def attention_schema(cfg):
    d, KV, dh = cfg.d_model, cfg.num_kv_heads, cfg.hd
    Hp, _ = padded_heads(cfg)
    s = {
        "wq": P((d, Hp, dh), ("embed", "heads", "head_dim"), fanin_std(d)),
        "wk": P((d, KV, dh), ("embed", "kv_heads", "head_dim"), fanin_std(d)),
        "wv": P((d, KV, dh), ("embed", "kv_heads", "head_dim"), fanin_std(d)),
        "wo": P((Hp, dh, d), ("heads", "head_dim", "embed"),
                fanin_std(cfg.num_heads * dh)),
    }
    if cfg.qkv_bias:
        s["bq"] = P((Hp, dh), ("heads", "head_dim"), 0.0)
        s["bk"] = P((KV, dh), ("kv_heads", "head_dim"), 0.0)
        s["bv"] = P((KV, dh), ("kv_heads", "head_dim"), 0.0)
    if cfg.proj_bias:
        s["bo"] = P((d,), ("embed",), 0.0)
    return s


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _inv_freq(dh: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, dh, 2, dtype=np.float64) / dh))


@functools.lru_cache(maxsize=32)
def _inv_freq_table(dh: int, theta: float, device: torch.device):
    """The (dh/2,) float32 frequencies, taken in float64 and cast once."""
    return torch.as_tensor(_inv_freq(dh, theta).astype(np.float32),
                           device=device)


def _mrope_segments(dh: int, sections) -> np.ndarray:
    """The position stream (0 = t, 1 = h, 2 = w) of each rotary
    frequency index."""
    n = dh // 2
    total = sum(sections)
    counts = [int(round(n * s / total)) for s in sections]
    counts[0] = n - sum(counts[1:])
    return np.repeat(np.arange(len(sections)), counts)


def apply_rope(x, positions, *, theta, style="neox", sections=(2, 1, 1)):
    """x: (B, S, H, dh); positions: (B, S) integers, or (B, S, 3) for
    ``mrope``, whose rotary frequencies are split between the t, h and w
    position streams in the ratio ``sections``. ``neox`` and ``mrope``
    rotate the two halves of each head; ``none`` returns x. The angles
    and the rotation are float32; the result is cast back to x's
    dtype."""
    if style == "none":
        return x
    dh = x.shape[-1]
    inv = _inv_freq_table(dh, float(theta), x.device)
    if style == "mrope":
        seg = torch.as_tensor(_mrope_segments(dh, sections),
                              device=x.device)
        # (B, S, dh/2): each frequency's position, from its stream
        pos = positions.float()[..., seg]
        ang = pos * inv
    elif style == "neox":
        ang = positions.float()[..., None] * inv           # (B, S, dh/2)
    else:
        raise ValueError(f"rope_style {style!r}")
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention — train / prefill
# ---------------------------------------------------------------------------

def _groups(q, k, v):
    """(k, v, KV, G) of grouped-query attention of q's H heads over k's
    and v's KV heads (dim 2), G = H / KV. Where q is a ``DTensor`` whose
    heads a mesh dim splits but whose KV groups it does not (its size
    does not divide KV), each kv head is repeated over its G query heads
    (KV = H, G = 1): DTensor cannot cut a (KV, G) view of a head dim
    split inside a group, and so the query heads stay split."""
    from torch.distributed.tensor import DTensor

    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    if G > 1 and isinstance(q, DTensor) and any(
            p.is_shard(2) and KV % q.device_mesh.size(i)
            for i, p in enumerate(q.placements)):
        def rep(t):
            # split as q's heads are (a local slice of the repeat); the
            # gradient is gathered before the repeat's backward sums it
            # over G
            B, S, _, dh = t.shape
            r = _keep_layout(t[:, :, :, None].expand(
                B, S, KV, G, dh).reshape(B, S, H, dh))
            return pin(r, [p if p.is_shard(2) else r.placements[i]
                           for i, p in enumerate(q.placements)])
        return rep(k), rep(v), H, 1
    return k, v, KV, G


def _local_placements(q, k, v):
    """Where attention over ``DTensor``s q, k, v is exact on each rank's
    shards alone, their placements; else None. That holds when every
    mesh dim splits all three alike over the batch (dim 0) or the heads
    (dim 2), or none of them: rows and heads attend independently (a
    rank's query heads read its kv heads, G to one, as on one device).
    The shards then run the one-device code, with no DTensor dispatch in
    the chunk loops; a cache split over the sequence is not local."""
    from torch.distributed.tensor import DTensor, Replicate

    if not all(isinstance(t, DTensor) for t in (q, k, v)):
        return None
    pl = tuple(q.placements)
    if tuple(k.placements) != pl or tuple(v.placements) != pl:
        return None
    if all(p == Replicate() or (p.is_shard() and p.dim in (0, 2))
           for p in pl):
        return pl
    return None


def _from_local(out, like, placements):
    """This rank's attention output as a ``DTensor`` laid out as ``like``
    (q) is, with ``out``'s global shape."""
    from torch.distributed.tensor import DTensor

    shape = (like.shape[0], out.shape[1], like.shape[2], out.shape[3])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(out, like.device_mesh, placements,
                              run_check=False, shape=shape, stride=stride)


def _local_rows(cl, like):
    """This rank's rows of the (B,) integer tensor ``cl`` (replicated, a
    ``DTensor`` or a plain tensor), split over the batch as ``like``'s
    dim 0 is."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    pl = [Shard(0) if p.is_shard() and p.dim == 0 else Replicate()
          for p in like.placements]
    if isinstance(cl, DTensor):
        return cl.redistribute(like.device_mesh, pl).to_local()
    return distribute_tensor(cl, like.device_mesh, pl,
                             src_data_rank=None).to_local()


def _seq_split_dim(q, k, v):
    """The mesh dim that splits a ``DTensor`` cache k, v over its
    sequence (dim 1) while q is whole or split over its heads there, when
    that is the only difference (every other mesh dim splits q, k and v
    alike over the batch or the heads, or none of them); else None."""
    from torch.distributed.tensor import DTensor

    if not all(isinstance(t, DTensor) for t in (q, k, v)) or \
            tuple(k.placements) != tuple(v.placements):
        return None
    seq = [i for i, p in enumerate(k.placements) if p.is_shard(1)]
    if len(seq) != 1:
        return None
    for i, (a, b) in enumerate(zip(q.placements, k.placements)):
        if i == seq[0]:
            if not (a.is_replicate() or a.dim == 2):
                return None
        elif a != b or not (a.is_replicate() or a.dim in (0, 2)):
            return None
    return seq[0]


def _decode_split_sequence(q, k_cache, v_cache, cl, seq_dim: int, live):
    """Decode attention over a cache split over its sequence on mesh dim
    ``seq_dim`` (the flash-decoding layout): each rank scores every
    query head (gathered there: one token's) against its slice of the
    positions (``live(positions, cache_len)`` masks them), then
    the max, the sum of exponentials and the weighted values are reduced
    over that dim's group, the reference's softmax combine, where
    DTensor would gather the whole cache. Decode only: no gradient
    passes the reductions."""
    import torch.distributed as dist

    from torch.distributed.tensor import Replicate

    mesh, placements = q.device_mesh, q.placements
    q = q.redistribute(mesh, [Replicate() if i == seq_dim else p
                              for i, p in enumerate(placements)])
    ql, kl, vl = q.to_local(), k_cache.to_local(), v_cache.to_local()
    B, _, H, dh = ql.shape
    S_l, KV = kl.shape[1], kl.shape[2]
    pos = mesh.get_local_rank(seq_dim) * S_l + torch.arange(
        S_l, device=ql.device)
    qr = ql.reshape(B, KV, H // KV, dh).float() * (1.0 / math.sqrt(dh))
    s = torch.einsum("bkgd,bskd->bkgs", qr, kl.float())
    s = torch.where(live(pos, _local_rows(cl, q))[:, None, None, :], s,
                    NEG_INF)
    group = mesh.get_group(seq_dim)
    m = s.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, vl.float())
    dist.all_reduce(l, group=group)
    dist.all_reduce(o, group=group)
    out = (o / torch.clamp(l, min=1e-30)).reshape(B, 1, H, dh)
    return _from_local(out.to(q.dtype), q, q.placements).redistribute(
        mesh, placements)


def blockwise_attention(q, k, v, *, causal=True, window=None,
                        q_chunk=1024, kv_chunk=1024):
    """Online-softmax chunked attention.

    q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh) with H % KV == 0.
    Returns (B, Sq, H, dh) in q's dtype. Never materializes (Sq x Skv):
    one (q chunk, kv chunk) score block at a time, and chunk pairs wholly
    outside the causal or window band are skipped, as the reference's
    ``lax.cond`` skips them."""
    B, Sq, H, dh = q.shape
    _, Skv, _, _ = k.shape
    k, v, KV, G = _groups(q, k, v)
    local = _local_placements(q, k, v)
    if local is not None:
        return _from_local(blockwise_attention(
            q.to_local(), k.to_local(), v.to_local(), causal=causal,
            window=window, q_chunk=q_chunk, kv_chunk=kv_chunk), q, local)
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    sq_valid, skv_valid = Sq, Skv
    nq, nk = -(-Sq // qc), -(-Skv // kc)
    scale = 1.0 / math.sqrt(dh)
    dev = q.device
    # queries past Sq and keys past Skv are the reference's zero padding
    # up to whole chunks: padded keys are masked, padded rows dropped
    q = _pad_seq(q, nq * qc)
    k, v = _pad_seq(k, nk * kc), _pad_seq(v, nk * kc)
    qr = q.reshape(B, nq * qc, KV, G, dh)
    outs = []
    for i in range(nq):
        qb = qr[:, i * qc:(i + 1) * qc].float() * scale   # (B,qc,KV,G,dh)
        q_pos = torch.arange(i * qc, (i + 1) * qc, device=dev)
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, qc, dh), dtype=torch.float32, device=dev)
        for j in range(nk):
            if window is not None and \
                    j * kc < i * qc - (window - 1) - (kc - 1):
                continue
            if causal and j * kc > i * qc + (qc - 1):
                continue
            kb = k[:, j * kc:(j + 1) * kc].float()        # (B,kc,KV,dh)
            vb = v[:, j * kc:(j + 1) * kc].float()
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb)  # (B,KV,G,qc,kc)
            k_pos = torch.arange(j * kc, (j + 1) * kc, device=dev)
            mask = (k_pos < skv_valid)[None, :].expand(qc, kc)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]   # (B,KV,G,qc,dh)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B,qc,KV,G,dh)
    out = torch.cat(outs, dim=1).reshape(B, nq * qc, H, dh)
    return out[:, :sq_valid].to(q.dtype)


def _pad_seq(x, n: int):
    """Zero-pad axis 1 of x up to n rows."""
    if x.shape[1] == n:
        return x
    pad = x.new_zeros((x.shape[0], n - x.shape[1]) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


# ---------------------------------------------------------------------------
# Cached decode attention (one new token)
# ---------------------------------------------------------------------------

def _softmax_value(s, mask, v_cache, B, H, dh, dtype):
    """Masked softmax over the cache axis of s (B, KV, G, S) and the value
    product, in float32, with the reference's guards."""
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / torch.clamp(l, min=1e-30),
                       v_cache.float())
    return out.reshape(B, 1, H, dh).to(dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None):
    """q: (B, 1, H, dh); caches: (B, S, KV, dh); cache_len: scalar or (B,)
    integer tensor, the index of the new token (per slot under continuous
    batching). Positions past cache_len, or at least ``window`` behind
    it, are masked."""
    def live(pos, c):
        mask = pos[None, :] <= c[:, None]
        if window is not None:
            mask = mask & (pos[None, :] > c[:, None] - window)
        return mask
    return _decode(q, k_cache, v_cache, cache_len, live)


def decode_attention_ring(q, k_cache, v_cache, cl):
    """Sliding-window decode over a RING cache of W slots: slot i holds the
    key of absolute position p == i (mod W), p <= cache_len. All slots are
    in-window once warm; cold slots (p would be negative) are masked."""
    W = k_cache.shape[1]

    def live(slots, c):
        # absolute position held by slot i: largest p <= cl, p % W == i
        return c[:, None] - torch.remainder(c[:, None] - slots[None, :],
                                            W) >= 0
    return _decode(q, k_cache, v_cache, cl, live)


def _decode(q, k_cache, v_cache, cache_len, live):
    """One token's attention over the cache, ``live(positions,
    cache_len)`` masking (B, S) of them. ``DTensor`` inputs run on each
    rank's shards (`_local_placements`), or with the softmax combined
    over the mesh dim that splits the sequence
    (`_decode_split_sequence`), else through DTensor's own rules."""
    B, _, H, dh = q.shape
    S = k_cache.shape[1]
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(B)
    seq_dim = _seq_split_dim(q, k_cache, v_cache)
    if seq_dim is not None:
        return _decode_split_sequence(q, k_cache, v_cache, cl, seq_dim,
                                      live)
    k_cache, v_cache, KV, G = _groups(q, k_cache, v_cache)
    local = _local_placements(q, k_cache, v_cache)
    if local is not None:
        return _from_local(_decode(
            q.to_local(), k_cache.to_local(), v_cache.to_local(),
            _local_rows(cl, q), live), q, local)
    qr = q.reshape(B, KV, G, dh).float() * (1.0 / math.sqrt(dh))
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float())
    return _softmax_value(s, live(torch.arange(S, device=q.device), cl),
                          v_cache, B, H, dh, q.dtype)


# ---------------------------------------------------------------------------
# Paged cache views
# ---------------------------------------------------------------------------
#
# The paged twin of the dense decode cache (`serve/paged.py`): K/V rows
# live in fixed-size pages of a preallocated pool leaf shaped
# (n_pages, page_size, *rest), and a per-request block table maps view
# positions to pages. The three helpers below are the only tensor ops the
# paging layer needs: gather a contiguous attention view through the
# block table, and scatter freshly written rows back (one row per lane
# after a decode step, whole pages after a prefill). Both decode paths
# (`decode_attention`'s linear mask, `decode_attention_ring`'s modulo
# slots) run unchanged on the gathered view; a ring leaf's view is sliced
# to exactly its window so that the ring path triggers as on the dense
# cache. Page 0 is reserved as scratch: block-table entries past a
# request's allocation (and whole rows of empty lanes) point at it, and
# the positions they back are always masked, so they add exactly zero to
# the softmax's sums. (The view is shorter than the dense cache, so the
# sums run over another length: on the card another kernel shape, close
# to the dense result rather than bitwise.)


def gather_page_view(pool, block_table, *, batch_ax, seq_ax, seq_len):
    """One leaf's dense attention view through a block table.

    ``pool``: (n_pages, page_size, *rest); ``block_table``: (L, Q) integer
    page ids per lane. Returns a new tensor laid out as the leaf's dense
    twin (lanes at ``batch_ax``, the sequence at ``seq_ax``) with view
    length ``min(seq_len, Q * page_size)``: a ring leaf (seq_len = W) is
    sliced to exactly W; a linear leaf spans only the pages allocated."""
    L, Q = block_table.shape
    ps = pool.shape[1]
    v = pool[block_table]                            # (L, Q, ps, *rest)
    v = v.reshape((L, Q * ps) + tuple(pool.shape[2:]))
    v = v[:, :min(seq_len, Q * ps)]
    return torch.movedim(v, (0, 1), (batch_ax, seq_ax))


def scatter_page_token(pool, view, block_table, pos, *, batch_ax, seq_ax):
    """Write each lane's one decoded K/V row of ``view`` back to its page,
    in place. ``pos`` is the (L,) absolute cache position the decode step
    wrote; the view row is ``pos % view_len`` (the identity for a linear
    view, the ring slot for a ring view). Lanes whose row lands on the
    scratch page (empty lanes) collide there: which write wins is
    undefined, and scratch rows only ever back masked positions."""
    ps = pool.shape[1]
    vm = torch.movedim(view, (batch_ax, seq_ax), (0, 1))  # (L, Sv, *rest)
    L, sv = vm.shape[0], vm.shape[1]
    lanes = torch.arange(L, device=pool.device)
    p = torch.remainder(pos.to(device=pool.device, dtype=torch.long), sv)
    rows = vm[lanes, p]                              # (L, *rest)
    page = block_table[lanes, torch.div(p, ps, rounding_mode="floor")]
    pool[page, torch.remainder(p, ps)] = rows.to(pool.dtype)
    return pool


def scatter_page_prefill(pool, view, block_table, *, batch_ax, seq_ax):
    """Write a freshly prefilled view into pages, whole pages at a time,
    in place: the view is zero-padded up to a whole page and every page
    the first ``ceil(view_len / page_size)`` block-table columns name is
    overwritten; rows past a request's allocation land on scratch. What
    the dense engine's slot merge becomes under paging."""
    ps = pool.shape[1]
    vm = torch.movedim(view, (batch_ax, seq_ax), (0, 1))  # (L, Sv, *rest)
    L, sv = vm.shape[0], vm.shape[1]
    npg = -(-sv // ps)
    if npg * ps != sv:
        vm = torch.cat([vm, vm.new_zeros((L, npg * ps - sv)
                                         + tuple(vm.shape[2:]))], dim=1)
    vm = vm.reshape((L, npg, ps) + tuple(vm.shape[2:]))
    pool[block_table[:, :npg]] = vm.to(pool.dtype)
    return pool


# ---------------------------------------------------------------------------
# Full attention block
# ---------------------------------------------------------------------------

def project(x, w, b=None):
    """x: (B, S, d) times a (d, heads, dh) weight, plus a (heads, dh) bias
    where given, in x's dtype (weights cast to it, as the reference's
    ``.astype``): (B, S, heads, dh)."""
    B, S, d = x.shape
    w2 = _keep_layout(w.to(x.dtype).reshape(d, -1))
    y = _heads_split(torch.matmul(x, w2), w).view(B, S, *w.shape[1:])
    return y + b.to(x.dtype) if b is not None else y


def _write_rows(cache, slot, new):
    """cache[b, slot[b]] = new[b, 0] for every row b, in place (cache:
    (B, S, KV, dh); new: (B, 1, KV, dh)): a scatter along the sequence.
    A ``DTensor`` cache is written on each rank's shard, its own rows at
    their slots (DTensor has no rule for an indexed or scattered write
    into a split tensor); where the sequence is split (the
    flash-decoding layout), each rank writes the rows whose slot lies in
    its slice."""
    from torch.distributed.tensor import DTensor

    from torch.distributed.tensor import Replicate

    new = new.to(cache.dtype)
    seq = []
    if isinstance(cache, DTensor):
        mesh = cache.device_mesh
        seq = [i for i, p in enumerate(cache.placements) if p.is_shard(1)]
        new = new.redistribute(mesh, [Replicate() if i in seq else p for
                                      i, p in enumerate(cache.placements)])
        slot, new, cache = _local_rows(slot, cache), new.to_local(), \
            cache.to_local()
    if seq:        # rows whose slot lies elsewhere rewrite what they read
        slot = slot - mesh.get_local_rank(seq[0]) * cache.shape[1]
        inside = (slot >= 0) & (slot < cache.shape[1])
        slot = torch.clamp(slot, 0, cache.shape[1] - 1)
    idx = slot.reshape(-1, 1, 1, 1).expand(cache.shape[0], 1,
                                           *cache.shape[2:])
    if seq:
        new = torch.where(inside[:, None, None, None], new,
                          cache.gather(1, idx))
    cache.scatter_(1, idx, new)


def _write_prefix(cache, new):
    """cache[:, :S] = new in place (new: (B, S, KV, dh), S at most the
    cache's length). A ``DTensor`` cache is written on each rank's
    shard: where the sequence is split, each rank writes the rows of
    ``new`` that fall in its slice (a slice assignment across a split
    dim is not DTensor's to get right), or its own rows of ``new`` where
    ``new`` is as long as the cache and split over the sequence alike."""
    from torch.distributed.tensor import DTensor, Replicate

    new = new.to(cache.dtype)
    if not isinstance(cache, DTensor):
        cache[:, :new.shape[1]] = new
        return
    mesh = cache.device_mesh
    seq = [i for i, p in enumerate(cache.placements) if p.is_shard(1)
           and (new.shape[1] != cache.shape[1] or new.placements[i] != p)]
    new = new.redistribute(mesh, [Replicate() if i in seq else p for
                                  i, p in enumerate(cache.placements)])
    new, cache = new.to_local(), cache.to_local()
    off = mesh.get_local_rank(seq[0]) * cache.shape[1] if seq else 0
    n = max(0, min(cache.shape[1], new.shape[1] - off))
    cache[:, :n] = new[:, off:off + n]


def _keep_layout(t):
    """``t``, whose gradient is laid out as ``t`` when it is a
    ``DTensor``: put after a view that merges the heads with another dim,
    so that the view's backward never splits a gradient that DTensor
    split otherwise (unevenly: a split inside a head)."""
    from torch.distributed.tensor import DTensor

    return pin(t, t.placements) if isinstance(t, DTensor) else t


def _heads_split(y, w):
    """A ``DTensor`` product (B, S, heads x dh) split over a mesh dim on
    which the weight's heads are not (DTensor may split the flat output
    of a replicated weight, where the heads do not divide the mesh dim
    and no head view can carry a split inside a head) gathered on that
    dim; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(y, DTensor) or not isinstance(w, DTensor):
        return y
    last = y.ndim - 1
    want = [Replicate() if p.is_shard(last) and not q.is_shard(1) else p
            for p, q in zip(y.placements, w.placements)]
    return y if tuple(want) == tuple(y.placements) else pin(y, want)


def qkv_project(params, x, cfg):
    """x: (B, S, d) -> q (B, S, Hp, dh), k and v (B, S, KV, dh)."""
    return (project(x, params["wq"], params.get("bq")),
            project(x, params["wk"], params.get("bk")),
            project(x, params["wv"], params.get("bv")))


def _rope(t, positions, cfg):
    return apply_rope(t, positions, theta=cfg.rope_theta,
                      style=cfg.rope_style, sections=cfg.mrope_sections)


def _kv_on_rows(params, x, positions, cfg, k_cache):
    """A prefill's K and V (RoPE applied) projected on each rank's share
    of the positions, split over the sequence (dim 1) on the mesh dim
    that splits the ``DTensor`` cache ``k_cache`` so, where the mesh dim
    does not split ``wk``'s kv heads (they do not divide it: the rules'
    fallback); else None. ``x`` (whole over that dim) and the positions
    are sliced locally, with no communication. The replicated weights
    would otherwise run over every position on every rank of that dim,
    which keeps only its slice."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(k_cache, DTensor):
        return None
    wk = params["wk"]
    seq = [i for i, p in enumerate(k_cache.placements)
           if p.is_shard(1) and not wk.placements[i].is_shard(1)]
    if not seq:
        return None
    xs = pin(x, [Shard(1) if i == seq[0] else p
                 for i, p in enumerate(x.placements)])
    biases = [params[n] for n in ("bk", "bv") if n in params]

    def rows(x, pos, wk, wv, *b):
        return (_rope(project(x, wk, b[0] if b else None), pos, cfg),
                project(x, wv, b[1] if b else None))

    # roles: 0 the batch, 1 the sequence, 2 the kv heads
    return local_call(rows, (xs, positions, wk, params["wv"], *biases),
                      [(0, 1, None), (0, 1, None), (None, None, 1),
                       (None, None, 1)] + [(None, None, 0)] * len(biases),
                      [(0, 1, 2), (0, 1, 2)])


def _whole_seq(t):
    """A ``DTensor`` split over its sequence (dim 1) gathered there."""
    from torch.distributed.tensor import Replicate

    return pin(t, [Replicate() if p.is_shard(1) else p for p in t.placements])


def _heads_as_queries(t, q):
    """K or V of `_kv_on_rows` (split over the sequence on one mesh dim,
    of size M) made whole over the sequence, each rank holding only the
    kv heads its query heads read: each of the KV heads is repeated r =
    M / gcd(KV, M) times (kv-major, as the query heads are padded), so
    that the KV r heads split over that dim as q's Hp heads do, G / r
    query heads to one, and an all-to-all takes the sequence split to
    the heads. A rank receives 1 / gcd(KV, M) of the gather's bytes.
    Where q's heads are not split over that dim, or KV r does not divide
    Hp, it is gathered over the sequence instead."""
    from torch.distributed.tensor import Shard

    m = next(i for i, p in enumerate(t.placements) if p.is_shard(1))
    B, S, KV, dh = t.shape
    r = t.device_mesh.size(m) // math.gcd(KV, t.device_mesh.size(m))
    if not q.placements[m].is_shard(2) or q.shape[2] % (KV * r):
        return _whole_seq(t)
    t = t[:, :, :, None].expand(B, S, KV, r, dh).reshape(B, S, KV * r, dh)
    return pin(t, [Shard(2) if i == m else p
                   for i, p in enumerate(t.placements)])


def _as_cache(t, cache):
    """``t`` of `_heads_as_queries` (or anything with the cache's kv
    heads, as it is), as long as ``cache``, laid out as the cache is:
    an all-to-all from the heads back to the sequence, then one of each
    kv head's r copies."""
    KV = cache.shape[2]
    if t.shape[2] == KV:
        return t
    B, S, H, dh = t.shape
    return pin(t, cache.placements).view(B, S, KV, H // KV, dh)[:, :, :, 0]


def out_project(params, o, x_dtype, cfg):
    """o: (B, S, Hp, dh) -> (B, S, d). Padded heads are zeroed first (the
    multiply is skipped where there is no padding: a mask of ones)."""
    B, S, Hp, dh = o.shape
    if Hp != cfg.num_heads:
        o = o * head_mask(cfg, o.dtype, o.device)[None, None, :, None]
    out = torch.matmul(o.reshape(B, S, Hp * dh),
                       params["wo"].to(o.dtype).reshape(Hp * dh, -1))
    if "bo" in params:
        out = out + params["bo"].to(out.dtype)
    return out.to(x_dtype)


def attention_block(params, x, *, cfg, positions, causal=True, cross_kv=None,
                    cache=None, cache_len=None):
    """One attention sub-layer (no norm/residual — the caller owns those).

    Returns (out, cache). ``cache`` is a (k, v) pair of one layer's
    (B, S_cache, KV, dh) tensors, or None:

      * train: no cache, returns (out, None);
      * prefill (x is (B, S, d), S > 1, cache given): the fresh K/V are
        written into ``cache`` IN PLACE at rows [0:S] — for a ring of W =
        sliding_window slots, the last W keys rotated so that the key of
        position p sits in slot p % W — and the same pair is returned;
        callers that need the reference's fresh-array semantics pass a
        copy (`models.transformer.apply_stack` does);
      * decode (x is (B, 1, d), cache given): each row b's K/V is written
        in place at position ``cache_len[b]`` (slot cache_len % W for a
        ring), then attends over the cache;
      * ``cross_kv`` = (k, v), precomputed (B, S_enc, KV, dh) encoder keys
        and values: cross-attention of x's queries over them, unmasked,
        returning (out, None).

    Over a mesh, a prefill into a cache split over the sequence on a mesh
    dim that does not split the kv heads projects K and V on each rank's
    positions and moves to each rank the kv heads its query heads read
    (`_kv_on_rows`, `_heads_as_queries`).
    """
    if cross_kv is not None:
        k, v = cross_kv
        q = project(x, params["wq"], params.get("bq"))
        o = blockwise_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                                kv_chunk=cfg.kv_chunk)
        return out_project(params, o, x.dtype, cfg), None

    # a prefill into a cache split over the sequence projects K and V
    # on each rank's own positions, then moves the heads each rank reads
    rows = _kv_on_rows(params, x, positions, cfg, cache[0]) \
        if cache is not None and x.shape[1] > 1 else None
    if rows is None:
        q, k, v = qkv_project(params, x, cfg)
        k = _rope(k, positions, cfg)
    else:
        q = project(x, params["wq"], params.get("bq"))
        k, v = (_heads_as_queries(t, q) for t in rows)
    q = _rope(q, positions, cfg)

    if cache is not None and x.shape[1] == 1:  # decode
        k_cache, v_cache = cache
        B = x.shape[0]
        S_cache = k_cache.shape[1]
        cl = torch.as_tensor(cache_len, device=x.device).reshape(-1)
        cl = cl.expand(B).long()
        ring = bool(cfg.sliding_window) and S_cache == cfg.sliding_window
        # ring buffer: slot i holds the key of absolute position p with
        # p == i (mod W); the new token at cache_len lands in slot cl % W
        slot = torch.remainder(cl, S_cache) if ring else cl
        _write_rows(k_cache, slot, k)
        _write_rows(v_cache, slot, v)
        if ring:
            o = decode_attention_ring(q, k_cache, v_cache, cl)
        else:
            o = decode_attention(q, k_cache, v_cache, cl,
                                 window=cfg.sliding_window)
        return out_project(params, o, x.dtype, cfg), (k_cache, v_cache)

    o = blockwise_attention(q, k, v, causal=causal,
                            window=cfg.sliding_window,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    if cache is None:
        return out_project(params, o, x.dtype, cfg), None
    k_cache, v_cache = cache
    S_cache = k_cache.shape[1]
    S = k.shape[1]
    if cfg.sliding_window and S_cache == cfg.sliding_window:
        # ring prefill: keep the last W keys, rotated so that the key of
        # absolute position p sits in slot p % W
        W = S_cache
        if S >= W:
            tail_k, tail_v, shift = k[:, -W:], v[:, -W:], (S - W) % W
        else:
            tail_k, tail_v, shift = _pad_seq(k, W), _pad_seq(v, W), 0
        new = [_as_cache(torch.roll(t, shift, dims=1), k_cache)
               for t in (tail_k, tail_v)]
    elif rows is not None:
        # each rank's own rows where they are its rows of the cache
        new = rows if S == S_cache else [_whole_seq(t) for t in rows]
    else:
        new = k, v
    _write_prefix(k_cache, new[0])
    _write_prefix(v_cache, new[1])
    return out_project(params, o, x.dtype, cfg), (k_cache, v_cache)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window=None) -> torch.Tensor:
    """O(S^2)-memory oracle for tests. q: (B, Sq, H, dh); k, v: (B, Skv,
    KV, dh) with H % KV == 0; query head h reads kv head h // (H / KV).
    Positions count from 0 in q and in k (the causal mask is aligned
    top-left); masked scores are filled with `NEG_INF`; computed in
    float32, returned in q's dtype."""
    B, Sq, H, dh = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float())
    s = s / math.sqrt(dh)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, dh).to(q.dtype)
