"""Public model API: ``build_model(cfg) -> Model`` with forward, prefill,
decode and the cache schema (the port's counterpart of the JAX package's
`models/api.py`), for every family: dense, MoE, RWKV-6, the Mamba2
hybrid with its shared attention block, the vision-language model's
M-RoPE and the encoder-decoder.

The entry points are plain functions of (params, batch[, cache]) on
tensors. A batch is a dict: ``tokens`` (B, S) integer tensor and, for
decode, ``cache_len`` (a scalar or (B,) integer tensor: the position of
each row's new token). An M-RoPE model (qwen2-vl) also takes
``positions`` (B, S, 3), the t/h/w position streams, in every mode, and
in forward and prefill an optional ``patch_emb`` (B, vlm_patches,
d_model) that replaces the first positions' token embeddings. An
encoder-decoder model (whisper) also takes ``frames`` (B, S_enc,
d_model), the encoder's input embeddings, in forward and prefill
(prefill stores the cross-attention K/V of ``enc_ctx`` frames in the
cache; decode reads them from there), and decode takes an optional
``enc_out`` override of the encoder output, as the reference's.
``prefill`` returns a fresh cache and leaves the one it was given as it
was (recurrent layers start from the state that cache holds); ``decode``
writes each row's new K/V and state into the given cache in place and
returns it. ``forward`` returns (logits, the MoE layers' summed aux
loss); ``loss`` takes a batch with ``labels`` (B, S) as well (-1 masks a
position) and returns (ce + aux, {"loss", "ce", "aux"}), differentiable
in the parameters (the tied embedding's gradient sums the lookup's part
and the head's).

Parameters are float32 (``cfg.param_dtype``) and compute runs in
``cfg.compute_dtype``; the reference casts each weight at each product,
and `cast_params` casts those weights once, the same bits (for serving:
training keeps the float32 leaves and casts at each product).
`init_cast_params` draws and casts one leaf at a time, for models whose
float32 tree does not fit beside its cast copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm

__all__ = ["Model", "build_model", "init_model_params", "init_cache",
           "params_from_numpy", "cast_params", "init_cast_params"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    schema: dict
    plan: list
    forward: Callable      # (params, batch) -> (logits, aux)
    prefill: Callable      # (params, batch, cache) -> (last logits, new cache)
    decode: Callable       # (params, batch, cache) -> (logits, cache)
    cache_schema: Callable  # (batch_size, max_len) -> schema tree
    loss: Callable         # (params, batch) -> (total, metrics)


# the decode position table's rows (the reference's)
DECODE_POSITIONS = 8192


def _embed_tokens(params, batch, cfg, *, mode):
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens).to(cfg.compute_dtype)
    if cfg.vlm_patches and mode != "decode" and "patch_emb" in batch:
        # a new tensor, not a write into the lookup: training
        # differentiates through it
        x = torch.cat([batch["patch_emb"].to(x.dtype),
                       x[:, cfg.vlm_patches:]], dim=1)
    if cfg.is_encdec:  # whisper decoder: absolute sinusoidal positions
        if mode == "decode":
            # the new token's position is cache_len (scalar or per slot)
            B = tokens.shape[0]
            cl = torch.as_tensor(batch["cache_len"], device=tokens.device)
            tab = L.sinusoidal_positions(DECODE_POSITIONS, cfg.d_model,
                                         x.dtype, x.device)
            x = x + tab[cl.reshape(-1).expand(B).long()][:, None, :]
        else:
            x = x + L.sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                           x.dtype, x.device)[None]
    if "embed_norm" in params:
        x = L.apply_norm(params["embed_norm"], x, kind="layernorm",
                         eps=cfg.norm_eps)
    return x


def _cache_len(batch, B: int, device):
    return torch.as_tensor(batch["cache_len"], device=device).reshape(-1) \
        .expand(B)


def _positions(batch, cfg, *, mode):
    tokens = batch["tokens"]
    B, S = tokens.shape
    if cfg.rope_style == "mrope":
        return torch.as_tensor(batch["positions"], device=tokens.device)
    if mode == "decode":
        return _cache_len(batch, B, tokens.device)[:, None]
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


def _final_logits(params, x, cfg):
    x = L.apply_norm(params["final_norm"], x, kind=cfg.norm_type,
                     eps=cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.linear_head(params["head"], x)


def _encode(params, batch, cfg, enc_plan):
    """The encoder over ``frames``: sinusoidal positions, the encoder
    stack without a causal mask, the final encoder norm."""
    frames = batch["frames"].to(cfg.compute_dtype)
    B, S = frames.shape[:2]
    x = frames + L.sinusoidal_positions(S, cfg.d_model, frames.dtype,
                                        frames.device)[None]
    pos = torch.arange(S, device=frames.device)[None, :].expand(B, S)
    ctx = tfm.Ctx(cfg=cfg, mode="train", positions=pos, causal=False)
    x, _, _ = tfm.apply_stack(params["encoder"], x, enc_plan, ctx)
    return L.apply_norm(params["enc_norm"], x, kind=cfg.norm_type,
                        eps=cfg.norm_eps)


def build_model(cfg, *, device="cuda") -> Model:
    """The model of ``cfg``, meant for ``device`` (default the card;
    raises on a host without one unless given ``device="cpu"``); its
    functions run where their tensors are."""
    resolve_device(device)
    plan = tfm.stack_plan(cfg)
    enc_plan = tfm.encoder_plan(cfg) if cfg.is_encdec else None
    schema: dict = {
        "embed": L.embed_schema(cfg.vocab_size, cfg.d_model),
        "stack": tfm.stack_schema(cfg, plan),
        "final_norm": L.norm_schema(cfg.d_model, cfg.norm_type),
    }
    if not cfg.tie_embeddings:
        schema["head"] = L.linear_head_schema(cfg.d_model, cfg.vocab_size)
    if cfg.shared_attn_every:
        schema["shared_attn"] = tfm.shared_attn_schema(cfg)
    if cfg.is_encdec:
        schema["encoder"] = tfm.stack_schema(cfg, enc_plan)
        schema["enc_norm"] = L.norm_schema(cfg.d_model, cfg.norm_type)
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        schema["embed_norm"] = L.norm_schema(cfg.d_model, "layernorm")

    def _run(params, batch, cache, mode):
        x = _embed_tokens(params, batch, cfg, mode=mode)
        pos = _positions(batch, cfg, mode=mode)
        enc_out = None
        if cfg.is_encdec and mode != "decode":
            enc_out = _encode(params, batch, cfg, enc_plan)
        elif cfg.is_encdec and "enc_out" in batch:   # optional override
            enc_out = batch["enc_out"].to(cfg.compute_dtype)
        cache_len = _cache_len(batch, x.shape[0], x.device) \
            if mode == "decode" else None
        ctx = tfm.Ctx(cfg=cfg, mode=mode, positions=pos, cache_len=cache_len,
                      causal=True, enc_out=enc_out,
                      shared=params.get("shared_attn"))
        return tfm.apply_stack(params["stack"], x, plan, ctx, cache=cache)

    def forward(params, batch):
        x, _, aux = _run(params, batch, None, "train")
        return _final_logits(params, x, cfg), aux

    def prefill(params, batch, cache):
        x, new_cache, _ = _run(params, batch, cache, "prefill")
        # the head runs on the last position only: the reference's
        # logits[:, -1:], without the (B, S, vocab) float32 product
        return _final_logits(params, x[:, -1:], cfg), new_cache

    def decode(params, batch, cache):
        x, cache, _ = _run(params, batch, cache, "decode")
        return _final_logits(params, x, cfg), cache

    def cache_schema_fn(batch_size: int, max_len: int):
        return tfm.cache_schema(cfg, plan, batch_size, max_len)

    def loss(params, batch):
        logits, aux = forward(params, batch)
        ce = L.cross_entropy_loss(logits, batch["labels"])
        total = ce + aux
        return total, {"loss": total.detach(), "ce": ce.detach(),
                       "aux": aux.detach()}

    return Model(cfg=cfg, schema=schema, plan=plan, forward=forward,
                 prefill=prefill, decode=decode, cache_schema=cache_schema_fn,
                 loss=loss)


# ---------------------------------------------------------------------------
# Parameters and caches
# ---------------------------------------------------------------------------

def init_model_params(model: Model, seed: int = 0, *, device="cuda"):
    """Random parameters from ``torch.Generator(seed)`` on ``device``,
    by the reference's per-leaf rules (the draws are torch's)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return L.init_params(gen, model.schema, model.cfg.param_dtype)


def init_cache(model: Model, batch_size: int, max_len: int, *,
               device="cuda"):
    """Zeroed decode cache for ``batch_size`` slots of ``max_len`` rows
    (a ring of ``sliding_window`` rows where the window is shorter)."""
    dev = resolve_device(device)
    return L.tree_map(
        lambda p: torch.zeros(p.shape, dtype=p.dtype or torch.float32,
                              device=dev),
        model.cache_schema(batch_size, max_len))


def params_from_numpy(model: Model, tree, *, device="cuda"):
    """The port's parameters from another package's parameter tree as
    numpy arrays (the JAX package's, same nesting and names): every leaf
    is checked against the schema's shape and becomes a tensor of the
    schema's dtype on ``device``."""
    dev = resolve_device(device)
    want = dict(L.tree_items(model.schema))
    got = dict(L.tree_items(tree))
    if want.keys() != got.keys():
        raise ValueError(
            f"parameter tree differs from the schema: missing "
            f"{sorted(want.keys() - got.keys())}, unexpected "
            f"{sorted(got.keys() - want.keys())}")

    def leaf(p, a):
        a = np.asarray(a)
        if a.shape != p.shape:
            raise ValueError(f"leaf of shape {a.shape}, schema {p.shape}")
        dtype = p.dtype or model.cfg.param_dtype
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=dev, dtype=dtype)

    return L.tree_map(leaf, model.schema, tree)


# the leaves the reference keeps in float32 at their products, by their
# parent's name: the router, and RWKV's decay, bonus and group norm
_FLOAT32_LEAVES = {"moe": ("router",),
                   "att": ("w0", "wA", "wB", "u", "gn_scale", "gn_bias")}
# a Mamba2 block's leaves that it casts to the compute dtype
_MAMBA_CAST = ("in_proj", "conv_w", "conv_b", "out_proj")


def _cast_at_product(path) -> bool:
    """Does the reference cast this parameter to the compute dtype
    (``.astype(x.dtype)`` / ``.astype(cd)``) wherever it reads it?"""
    parent, name = path[-2], path[-1]
    if parent in ("attn", "mlp", "shared", "ffn"):
        return True
    if parent in _FLOAT32_LEAVES:
        return name not in _FLOAT32_LEAVES[parent]
    return parent.endswith("_mamba") and name in _MAMBA_CAST


def cast_params(model: Model, params):
    """``params`` with every weight that the reference casts to
    ``cfg.compute_dtype`` at its product cast once: the attention, MLP
    and expert weights and biases, RWKV's projections, token-shift mixes
    and LoRA, Mamba2's projections and convolution. One rounding from
    float32 gives the same bits wherever it happens. Norm scales, the
    embedding (which the float32 ``unembed`` reads), the head, the MoE
    router and the float32 decay parameters stay as they are. A tensor
    already in the compute dtype is kept, not copied."""
    dt = model.cfg.compute_dtype
    return L.tree_from_items(
        (path, t.to(dt) if _cast_at_product(path) else t)
        for path, t in L.tree_items(params))


def init_cast_params(model: Model, seed: int = 0, *, device="cuda"):
    """``cast_params(model, init_model_params(model, seed))``, bitwise,
    drawn and cast one leaf at a time: the float32 draw of a leaf is
    freed before the next is made, so the peak is the cast tree so far
    plus one float32 leaf and its cast copy (deepseek-moe-16b's stacked
    expert weights are 19.9 GB in float32; its whole float32 tree and
    cast copy would not fit on an 80 GB card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = model.cfg.compute_dtype
    items = []
    for path, p in L.tree_items(model.schema):
        t = L.init_leaf(p, model.cfg.param_dtype, gen, dev)
        items.append((path, t.to(dt) if _cast_at_product(path) else t))
        del t
    return L.tree_from_items(items)
