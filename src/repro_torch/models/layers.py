"""Parameter-schema system and common layers (the port's counterpart of the
JAX package's `models/layers.py`).

Every module describes its parameters as a *schema*: a nested dict whose
leaves are :class:`P` entries carrying (shape, logical axes, init rule,
dtype). One schema drives `init_params` (materialize a tree of tensors),
`param_count` and the weight carrier `models.api.params_from_numpy`
(check another package's tree leaf by leaf). The logical axis names are
the reference's: layers, embed, vocab, heads, kv_heads, head_dim, mlp,
batch, seq, None.

Trees are plain nested dicts; `tree_map` and `tree_items` walk them in
sorted key order, the order in which the JAX package flattens them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["P", "fanin_std", "stack_schema", "tree_map", "tree_items",
           "tree_from_items", "init_leaf", "init_params", "param_count",
           "norm_schema", "apply_norm", "embed_schema", "embed", "unembed",
           "linear_head_schema", "linear_head", "mlp_schema", "apply_mlp",
           "sinusoidal_positions", "cross_entropy_loss"]


@dataclasses.dataclass(frozen=True)
class P:
    """Schema leaf: one parameter (or cache) tensor."""

    shape: tuple
    axes: tuple  # logical axis name (str) or None per dim
    std: Any = 0.02  # float stddev | 0.0 => zeros | "ones" | ("uniform", lo, hi)
    dtype: Any = None  # None => use the param_dtype passed to init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_leaf(x) -> bool:
    return not isinstance(x, dict)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of ``tree`` (and the matching leaves of
    ``rest``), keeping the nesting."""
    if is_leaf(tree):
        return fn(tree, *rest)
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            for k in sorted(tree)}


def tree_items(tree, prefix: tuple = ()):
    """(path, leaf) pairs of ``tree`` in sorted key order."""
    if is_leaf(tree):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from tree_items(tree[k], prefix + (k,))


def tree_from_items(items) -> dict:
    """The nested dict whose leaves are the (path, leaf) pairs ``items``
    (the inverse of `tree_items`)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def fanin_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(max(1, fan_in))


def stack_schema(n: int, schema):
    """Prepend a 'layers' dim of size n to every P in `schema`."""
    return tree_map(lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.std,
                                p.dtype), schema)


def init_leaf(p: P, param_dtype, gen: torch.Generator, device):
    """One leaf of `init_params`, the next draw from ``gen``."""
    dtype = p.dtype or param_dtype
    if p.std == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if isinstance(p.std, tuple) and p.std and p.std[0] == "uniform":
        _, lo, hi = p.std
        u = torch.rand(p.shape, generator=gen, device=device)
        return (u * (hi - lo) + lo).to(dtype)
    std = float(p.std)
    if std == 0.0:
        return torch.zeros(p.shape, dtype=dtype, device=device)
    x = torch.randn(p.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)   # in place: one float32 copy at a time


def init_params(gen: torch.Generator, schema, param_dtype=torch.float32):
    """Materialize the parameter tree for `schema` on ``gen``'s device,
    drawing the leaves in sorted key order from ``gen``. The per-leaf
    rules are the reference's; the draws are torch's, not JAX's."""
    dev = gen.device
    return tree_map(lambda p: init_leaf(p, param_dtype, gen, dev), schema)


def param_count(schema) -> int:
    return sum(math.prod(p.shape) for _, p in tree_items(schema))


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def norm_schema(d: int, kind: str = "rmsnorm"):
    if kind == "rmsnorm":
        return {"scale": P((d,), ("embed",), "ones")}
    return {"scale": P((d,), ("embed",), "ones"), "bias": P((d,), ("embed",), 0.0)}


def apply_norm(params, x, *, kind: str = "rmsnorm", eps: float = 1e-5):
    """RMS or layer norm over the last axis, computed in float32 and cast
    back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + eps) * params["scale"].float()
    else:  # layernorm
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_schema(vocab: int, d: int):
    return {"embedding": P((vocab, d), ("vocab", "embed"), fanin_std(d))}


def embed(params, tokens):
    return params["embedding"][tokens]


def unembed(params, x):
    """Tied-embedding logits, in float32 for a stable softmax."""
    return torch.matmul(x.float(), params["embedding"].float().t())


def linear_head_schema(d: int, vocab: int):
    return {"w": P((d, vocab), ("embed", "vocab"), fanin_std(d))}


def linear_head(params, x):
    return torch.matmul(x.float(), params["w"].float())


# ---------------------------------------------------------------------------
# MLP (gated or plain), optionally biased
# ---------------------------------------------------------------------------

def mlp_schema(d: int, d_ff: int, *, gated: bool = True, bias: bool = False):
    s = {"w_in": P((d, d_ff), ("embed", "mlp"), fanin_std(d)),
         "w_out": P((d_ff, d), ("mlp", "embed"), fanin_std(d_ff))}
    if gated:
        s["w_gate"] = P((d, d_ff), ("embed", "mlp"), fanin_std(d))
    if bias:
        s["b_in"] = P((d_ff,), ("mlp",), 0.0)
        s["b_out"] = P((d,), ("embed",), 0.0)
    return s


# jax.nn.gelu is the tanh approximation by default; torch's is exact
# unless asked for it
_ACTS = {"silu": F.silu, "relu": F.relu,
         "gelu": lambda x: F.gelu(x, approximate="tanh")}


def apply_mlp(params, x, *, act: str = "silu"):
    """Gated (``w_gate`` present) or plain MLP in ``x``'s dtype; weights
    are cast to it at each product, as the reference's ``.astype``."""
    dt = x.dtype
    h = torch.matmul(x, params["w_in"].to(dt))
    if "b_in" in params:
        h = h + params["b_in"].to(dt)
    if "w_gate" in params:
        g = torch.matmul(x, params["w_gate"].to(dt))
        h = _ACTS[act](g) * h
    else:
        h = _ACTS[act](h)
    out = torch.matmul(h, params["w_out"].to(dt))
    if "b_out" in params:
        out = out + params["b_out"].to(dt)
    return out


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def sinusoidal_positions(seq_len: int, d: int, dtype=torch.float32,
                         device="cpu"):
    """(seq_len, d) absolute positions, sines then cosines, computed in
    float64 (numpy, as the reference) and cast once to ``dtype`` on
    ``device``; row p is the same for every ``seq_len`` > p."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = 1.0 / (10000 ** (2 * dim / d))
    ang = pos * inv
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out).to(device=device, dtype=dtype)


def cross_entropy_loss(logits, labels, *, z_loss: float = 0.0):
    """Mean next-token cross entropy in float32; ``labels == -1`` are
    masked out; ``z_loss`` adds z_loss * logsumexp^2 per token."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
