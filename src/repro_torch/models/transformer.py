"""Config-driven layer-stack assembler (the port's counterpart of the JAX
package's `models/transformer.py`), dense and encoder-decoder families.

A stack is a list of Segments; each Segment is a repeated *pattern* of
layers whose parameters are stacked on a leading "layers" axis. A layer
is an ordered tuple of sublayer kinds:

    ("attn", "mlp")            dense transformer layer (and whisper's
                               encoder layer, run without a causal mask)
    ("attn", "cross", "mlp")   whisper decoder layer

Where the reference scans the layer axis with ``lax.scan``
(remat-wrapped for training), the port loops over it. The MoE, RWKV,
Mamba and shared-attention layers come with their own slices
(`unsupported_family`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import attention as att
from repro_torch.models import layers as L
from repro_torch.models.layers import P

__all__ = ["Segment", "stack_plan", "encoder_plan", "stack_schema",
           "cache_schema", "paged_pool_schema", "Ctx", "apply_stack",
           "unsupported_family"]

# the slice of the port that brings each family the dense slice lacks
LATER_SLICES = {
    "moe": "the MoE slice (models/moe.py)",
    "ssm": "the RWKV slice (models/rwkv.py)",
    "hybrid": "the Mamba2 hybrid slice (models/mamba.py)",
    "vlm": "the vision-language slice (mrope)",
}


def unsupported_family(cfg) -> None:
    """Raise `NotImplementedError` for a config outside the dense and
    encoder-decoder families, naming the slice that brings it."""
    if cfg.family not in ("dense", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; it comes "
            f"with {LATER_SLICES.get(cfg.family, 'a later slice')}")


@dataclasses.dataclass(frozen=True)
class Segment:
    pattern: tuple  # tuple of layer tuples
    repeats: int


def stack_plan(cfg) -> list[Segment]:
    unsupported_family(cfg)
    if cfg.is_encdec:
        return [Segment((("attn", "cross", "mlp"),), cfg.num_layers)]  # decoder
    return [Segment((("attn", "mlp"),), cfg.num_layers)]


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
    raise ValueError(kind)


def _pattern_schema(pattern, cfg):
    return {f"l{li}_{kind}": _sublayer_schema(kind, cfg)
            for li, layer in enumerate(pattern) for kind in layer}


def stack_schema(cfg, plan) -> dict:
    return {f"seg{i}": L.stack_schema(seg.repeats, _pattern_schema(seg.pattern, cfg))
            for i, seg in enumerate(plan)}


def _sublayer_cache_schema(kind: str, cfg, batch: int, max_len: int):
    KV, dh = cfg.num_kv_heads, cfg.hd
    kv_axes = ("batch", "seq", "kv_heads", "head_dim")
    if kind == "cross":
        # encoder K/V: computed once at prefill, read by every decoded token
        return {"ek": P((batch, cfg.enc_ctx, KV, dh), kv_axes, 0.0,
                        cfg.compute_dtype),
                "ev": P((batch, cfg.enc_ctx, KV, dh), kv_axes, 0.0,
                        cfg.compute_dtype)}
    if kind != "attn":
        return None  # mlp: stateless
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
    positions: Any              # (B, S) integer tensor
    cache_len: Any = None       # (B,) integer tensor (decode)
    causal: bool = True
    enc_out: Any = None         # encoder output for cross sublayers


def _apply_sublayer(kind, params, x, cache, ctx):
    cfg = ctx.cfg
    h = L.apply_norm(params["norm"], x, kind=cfg.norm_type, eps=cfg.norm_eps)
    if kind == "attn":
        # the layer's cache views are written in place (see apply_stack)
        kv = (cache["k"], cache["v"]) if cache else None
        out, _ = att.attention_block(
            params["attn"], h, cfg=cfg, positions=ctx.positions,
            causal=ctx.causal, cache=kv, cache_len=ctx.cache_len)
        return x + out
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
        return x + out
    if kind == "mlp":
        return x + L.apply_mlp(params["mlp"], h, act=cfg.act)
    raise ValueError(kind)


def _layers(tree, n: int) -> list:
    """Split a tree of stacked (n, ...) tensors into n trees of views."""
    parts = L.tree_map(lambda t: t.unbind(0), tree)
    return [L.tree_map(lambda t: t[i], parts) for i in range(n)]


def apply_stack(stack_params, x, plan, ctx, cache=None):
    """Run all segments. Returns (x, cache).

    Prefill writes into a COPY of ``cache`` (every slot's rows [0:S], the
    reference's fresh array), so the caller's cache is left as it was;
    decode writes each row's new K/V into ``cache`` in place and returns
    it. Without a cache (train) returns (x, None)."""
    if cache is not None and ctx.mode == "prefill":
        cache = L.tree_map(torch.clone, cache)
    for i, seg in enumerate(plan):
        seg_params = _layers(stack_params[f"seg{i}"], seg.repeats)
        seg_cache = _layers(cache[f"seg{i}"], seg.repeats) \
            if cache is not None else [{}] * seg.repeats
        for layer_params, layer_cache in zip(seg_params, seg_cache):
            for li, layer in enumerate(seg.pattern):
                for kind in layer:
                    key = f"l{li}_{kind}"
                    x = _apply_sublayer(kind, layer_params[key], x,
                                        layer_cache.get(key), ctx)
    return x, cache
