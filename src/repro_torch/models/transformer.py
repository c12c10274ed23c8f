"""Config-driven layer-stack assembler (the port's counterpart of the JAX
package's `models/transformer.py`), covering every family.

A stack is a list of Segments; each Segment is a repeated *pattern* of
layers whose parameters are stacked on a leading "layers" axis. A layer
is an ordered tuple of sublayer kinds:

    ("attn", "mlp")            dense transformer layer (and whisper's
                               encoder layer, run without a causal mask)
    ("attn", "moe")            MoE transformer layer
    ("attn", "cross", "mlp")   whisper decoder layer
    ("rwkv",)                  RWKV-6 block
    ("mamba",)                 Mamba2 block
    ("mamba", "shared_attn")   zamba2: Mamba2, then the weight-SHARED
                               attention block

The shared attention block's weights live outside the stacks
(``params["shared_attn"]``, passed in `Ctx.shared`), so every
application reads one copy; each application has its own KV cache.
Where the reference scans the layer axis with ``lax.scan``
(remat-wrapped for training), the port loops over it, each repeat under
`torch.utils.checkpoint` in training.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as att
from repro_torch.models import layers as L
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwk
from repro_torch.models.layers import P

__all__ = ["Segment", "stack_plan", "encoder_plan", "stack_schema",
           "shared_attn_schema", "cache_schema", "paged_pool_schema", "Ctx",
           "apply_stack"]


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: tuple  # tuple of layer tuples
    repeats: int


def stack_plan(cfg) -> list[Segment]:
    Lc = cfg.num_layers
    if cfg.ssm is not None and cfg.shared_attn_every:
        k = cfg.shared_attn_every
        pattern = (("mamba",),) * (k - 1) + (("mamba", "shared_attn"),)
        full, tail = divmod(Lc, k)
        segs = []
        if full:
            segs.append(Segment(pattern, full))
        if tail:
            segs.append(Segment((("mamba",),), tail))
        return segs
    if cfg.ssm is not None:
        kind = "rwkv" if cfg.ssm.kind == "rwkv6" else "mamba"
        return [Segment(((kind,),), Lc)]
    if cfg.moe is not None:
        m = cfg.moe
        segs = []
        rest = Lc - m.first_dense
        if m.first_dense:
            segs.append(Segment((("attn", "mlp"),), m.first_dense))
        if m.every_k_layers > 1:
            pat = (("attn", "mlp"),) * (m.every_k_layers - 1) + \
                (("attn", "moe"),)
            segs.append(Segment(pat, rest // m.every_k_layers))
        else:
            segs.append(Segment((("attn", "moe"),), rest))
        return segs
    if cfg.is_encdec:
        return [Segment((("attn", "cross", "mlp"),), Lc)]  # decoder
    return [Segment((("attn", "mlp"),), Lc)]


def encoder_plan(cfg) -> list[Segment]:
    return [Segment((("attn", "mlp"),), cfg.encoder_layers)]


# ---------------------------------------------------------------------------
# Schemas
# ---------------------------------------------------------------------------

def _sublayer_schema(kind: str, cfg):
    if kind in ("attn", "cross"):
        return {"norm": L.norm_schema(cfg.d_model, cfg.norm_type),
                "attn": att.attention_schema(cfg)}
    if kind == "mlp":
        return {"norm": L.norm_schema(cfg.d_model, cfg.norm_type),
                "mlp": L.mlp_schema(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated,
                                    bias=cfg.proj_bias)}
    if kind == "moe":
        return {"norm": L.norm_schema(cfg.d_model, cfg.norm_type),
                "moe": moe_mod.moe_schema(cfg)}
    if kind == "rwkv":
        return rwk.rwkv_block_schema(cfg)
    if kind == "mamba":
        return mam.mamba_block_schema(cfg)
    if kind == "shared_attn":
        return {}  # the weights are shared: `shared_attn_schema`
    raise ValueError(kind)


def _pattern_schema(pattern, cfg):
    s = {}
    for li, layer in enumerate(pattern):
        for kind in layer:
            sub = _sublayer_schema(kind, cfg)
            if sub:
                s[f"l{li}_{kind}"] = sub
    return s


def stack_schema(cfg, plan) -> dict:
    return {f"seg{i}": L.stack_schema(seg.repeats, _pattern_schema(seg.pattern, cfg))
            for i, seg in enumerate(plan)}


def shared_attn_schema(cfg):
    """zamba2's shared block: attention and an MLP, each behind a norm."""
    return {
        "norm1": L.norm_schema(cfg.d_model, cfg.norm_type),
        "attn": att.attention_schema(cfg),
        "norm2": L.norm_schema(cfg.d_model, cfg.norm_type),
        "mlp": L.mlp_schema(cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated,
                            bias=cfg.proj_bias),
    }


def _sublayer_cache_schema(kind: str, cfg, batch: int, max_len: int):
    KV, dh = cfg.num_kv_heads, cfg.hd
    kv_axes = ("batch", "seq", "kv_heads", "head_dim")
    if kind == "cross":
        # encoder K/V: computed once at prefill, read by every decoded token
        return {"ek": P((batch, cfg.enc_ctx, KV, dh), kv_axes, 0.0,
                        cfg.compute_dtype),
                "ev": P((batch, cfg.enc_ctx, KV, dh), kv_axes, 0.0,
                        cfg.compute_dtype)}
    if kind == "rwkv":
        return rwk.rwkv_state_schema(cfg, batch)
    if kind == "mamba":
        return mam.mamba_state_schema(cfg, batch)
    if kind not in ("attn", "shared_attn"):
        return None  # mlp, moe: stateless
    # sliding-window archs only ever attend to the last `window` keys: a
    # RING of `window` slots when the window is under max_len
    slots = max_len
    if cfg.sliding_window and cfg.sliding_window < max_len:
        slots = cfg.sliding_window
    return {"k": P((batch, slots, KV, dh), kv_axes, 0.0, cfg.compute_dtype),
            "v": P((batch, slots, KV, dh), kv_axes, 0.0, cfg.compute_dtype)}


def cache_schema(cfg, plan, batch: int, max_len: int) -> dict:
    out = {}
    for i, seg in enumerate(plan):
        s = {}
        for li, layer in enumerate(seg.pattern):
            for kind in layer:
                cs = _sublayer_cache_schema(kind, cfg, batch, max_len)
                if cs:
                    s[f"l{li}_{kind}"] = cs
        out[f"seg{i}"] = L.stack_schema(seg.repeats, s)
    return out


def paged_pool_schema(cfg, plan, *, n_pages: int, page_size: int,
                      max_len: int) -> dict:
    """The PAGED view of `cache_schema`: one pool leaf per cache leaf.

    Each dense leaf's named "batch" and "seq" axes are replaced by a
    leading (pages, page) pair (pool shape ``(n_pages, page_size,
    *rest)``, the remaining axes in their order), so that a per-request
    block table and `models.attention.gather_page_view` rebuild the dense
    per-slot layout. A ring leaf pages its W slots the same way; a leaf
    without a "seq" axis cannot be paged and raises ``ValueError`` (the
    serving layer raises its typed `serve.errors.PagedCacheUnsupported`
    before it gets here)."""
    def pool_leaf(p: P) -> P:
        if "batch" not in p.axes or "seq" not in p.axes:
            raise ValueError(
                f"cache leaf with axes {p.axes} has no (batch, seq) pair "
                f"to page over")
        b, s = p.axes.index("batch"), p.axes.index("seq")
        rest = [i for i in range(len(p.shape)) if i not in (b, s)]
        return P((n_pages, page_size) + tuple(p.shape[i] for i in rest),
                 ("pages", "page") + tuple(p.axes[i] for i in rest),
                 0.0, p.dtype)

    return L.tree_map(pool_leaf, cache_schema(cfg, plan, 1, max_len))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ctx:
    cfg: Any
    mode: str                   # train | prefill | decode
    positions: Any              # (B, S) or, for mrope, (B, S, 3) integers
    cache_len: Any = None       # (B,) integer tensor (decode)
    causal: bool = True
    enc_out: Any = None         # encoder output for cross sublayers
    shared: Any = None          # the shared attention block's params (zamba)


def _zero_state(schema, x):
    return L.tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                            device=x.device), schema)


def _recurrent(block, state_schema, params, x, cache, ctx):
    """One rwkv or mamba block: from a zero state without a cache (train),
    else from the cache's state, written back into the cache in place."""
    state = cache if cache is not None else \
        _zero_state(state_schema(ctx.cfg, x.shape[0]), x)
    out, new = block(params, x, state, ctx.cfg, mode=ctx.mode)
    if cache is not None:
        for name, t in new.items():
            cache[name].copy_(t)
    return out


def _attend(params, h, cache, ctx):
    """Self-attention of h; the layer's K/V cache views, where given, are
    written in place (see `apply_stack`)."""
    kv = (cache["k"], cache["v"]) if cache else None
    out, _ = att.attention_block(
        params, h, cfg=ctx.cfg, positions=ctx.positions, causal=ctx.causal,
        cache=kv, cache_len=ctx.cache_len)
    return out


def _apply_sublayer(kind, params, x, cache, ctx):
    """One sublayer: returns (x, aux loss or None)."""
    cfg = ctx.cfg
    if kind == "rwkv":
        return _recurrent(rwk.rwkv_block, rwk.rwkv_state_schema, params, x,
                          cache, ctx), None
    if kind == "mamba":
        return _recurrent(mam.mamba_block, mam.mamba_state_schema, params,
                          x, cache, ctx), None
    if kind == "shared_attn":
        sp = ctx.shared
        h = L.apply_norm(sp["norm1"], x, kind=cfg.norm_type, eps=cfg.norm_eps)
        x = x + _attend(sp["attn"], h, cache, ctx)
        h = L.apply_norm(sp["norm2"], x, kind=cfg.norm_type, eps=cfg.norm_eps)
        return x + L.apply_mlp(sp["mlp"], h, act=cfg.act), None
    h = L.apply_norm(params["norm"], x, kind=cfg.norm_type, eps=cfg.norm_eps)
    if kind == "attn":
        return x + _attend(params["attn"], h, cache, ctx), None
    if kind == "cross":
        if ctx.mode == "decode" and cache is not None:
            ek, ev = cache["ek"], cache["ev"]     # prefilled encoder K/V
        else:
            ek = att.project(ctx.enc_out, params["attn"]["wk"],
                             params["attn"].get("bk"))
            ev = att.project(ctx.enc_out, params["attn"]["wv"],
                             params["attn"].get("bv"))
        out, _ = att.attention_block(params["attn"], h, cfg=cfg,
                                     positions=ctx.positions,
                                     cross_kv=(ek, ev))
        if cache is not None and ctx.mode == "prefill":
            if ek.shape[1] != cache["ek"].shape[1]:
                raise ValueError(
                    f"{ek.shape[1]} encoder frames, the cache holds "
                    f"enc_ctx = {cache['ek'].shape[1]}")
            cache["ek"].copy_(ek)
            cache["ev"].copy_(ev)
        return x + out, None
    if kind == "mlp":
        return x + L.apply_mlp(params["mlp"], h, act=cfg.act), None
    if kind == "moe":
        out, aux = moe_mod.moe_layer(params["moe"], h, cfg)
        return x + out, aux
    raise ValueError(kind)


def _layers(tree, n: int) -> list:
    """Split a tree of stacked (n, ...) tensors into n trees of views."""
    parts = L.tree_map(lambda t: t.unbind(0), tree)
    return [L.tree_map(lambda t: t[i], parts) for i in range(n)]


def _repeat(pattern, layer_params, layer_cache, x, ctx):
    """One repeat of a segment's pattern: (x, its MoE aux loss or None)."""
    total = None
    for li, layer in enumerate(pattern):
        for kind in layer:
            key = f"l{li}_{kind}"
            x, aux = _apply_sublayer(kind, layer_params.get(key), x,
                                     layer_cache.get(key), ctx)
            if aux is not None:
                total = aux if total is None else total + aux
    return x, total


# the reference's `dots_with_no_batch_dims_saveable`: keep the outputs of
# the 2-D matrix products (activations times weights), recompute the rest
_SAVED_PRODUCTS = [torch.ops.aten.mm.default]


def _remat(cfg):
    """The keyword arguments of `torch.utils.checkpoint.checkpoint` for
    ``cfg.remat`` (``full``: save nothing in a repeat; ``dots``: save the
    2-D products), or None for ``none``."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "full":
        return {"use_reentrant": False}
    if cfg.remat == "dots":
        return {"use_reentrant": False, "context_fn": functools.partial(
            create_selective_checkpoint_contexts, _SAVED_PRODUCTS)}
    raise ValueError(f"remat {cfg.remat!r}")


def apply_stack(stack_params, x, plan, ctx, cache=None):
    """Run all segments. Returns (x, cache, the summed MoE aux loss).

    Prefill writes into a COPY of ``cache`` (every slot's rows [0:S] and
    every slot's recurrent state, the reference's fresh array; the
    recurrent layers start from the state the cache held), so the
    caller's cache is left as it was; decode writes each row's new K/V
    and state into ``cache`` in place and returns it. Without a cache
    (train) returns (x, None, aux). In train mode with gradients on,
    each repeat runs under `torch.utils.checkpoint` by ``cfg.remat``, as
    the reference wraps each scanned repeat in ``jax.checkpoint``: its
    backward recomputes what the policy did not save."""
    if cache is not None and ctx.mode == "prefill":
        cache = L.tree_map(torch.clone, cache)
    remat = _remat(ctx.cfg) if ctx.mode == "train" and \
        torch.is_grad_enabled() else None
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, seg in enumerate(plan):
        seg_params = _layers(stack_params[f"seg{i}"], seg.repeats)
        seg_cache = _layers(cache[f"seg{i}"], seg.repeats) \
            if cache is not None else [{}] * seg.repeats
        for layer_params, layer_cache in zip(seg_params, seg_cache):
            if remat is None:
                x, aux = _repeat(seg.pattern, layer_params, layer_cache, x,
                                 ctx)
            else:
                x, aux = checkpoint(_repeat, seg.pattern, layer_params,
                                    layer_cache, x, ctx, **remat)
            if aux is not None:
                total_aux = total_aux + aux
    return x, cache, total_aux
