"""Parameter-schema system and common layers (the port's counterpart of the
JAX package's `models/layers.py`).

Every module describes its parameters as a *schema*: a nested dict whose
leaves are :class:`P` entries carrying (shape, logical axes, init rule,
dtype). One schema drives `init_params` (materialize a tree of tensors),
`axes_tree` (the matching tree of logical-axis tuples, which the
sharding rules read), `abstract_params` (the matching tree of "meta"
tensors: shapes and dtypes, no storage), `param_count` and the weight
carrier `models.api.params_from_numpy` (check another package's tree
leaf by leaf). The logical axis names are
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

from repro_torch.sharding.ctx import split_axis
from repro_torch.sharding.local import local_call

__all__ = ["P", "fanin_std", "stack_schema", "tree_map", "tree_items",
           "tree_from_items", "init_leaf", "init_params", "axes_tree",
           "abstract_params", "param_count",
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


def axes_tree(schema):
    """The tree of logical-axis tuples matching the parameter tree."""
    return tree_map(lambda p: p.axes, schema)


def abstract_params(schema, param_dtype=torch.float32):
    """The parameter tree's shapes and dtypes as tensors on the "meta"
    device (no storage): the reference's ``ShapeDtypeStruct`` tree."""
    meta = torch.device("meta")
    return tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype or
                                          param_dtype, device=meta), schema)


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
    """The table's rows at ``tokens`` (``F.embedding``). Over a mesh the
    lookup runs on local shards (`_embed_local`)."""
    local = _embed_local(params["embedding"], tokens)
    if local is not None:
        return local
    return F.embedding(tokens, params["embedding"])


def _embed_local(table, tokens):
    """The vocabulary-parallel lookup of a ``DTensor`` table, on this
    rank's shards: where a mesh dim splits the vocabulary, each rank
    looks up the tokens in its slice, zeroes the rows of tokens outside
    it, and the rows are a partial sum over that dim (one all-reduce
    where the caller's layout asks); a table split over the model width
    is gathered where the tokens' rows are split on the same dim (the
    ZeRO-3 gather a product runs too), else its width stays split. It is
    the lookup ``DTensor``'s own rule makes, without its mask buffers,
    which other operations compare with ``torch.equal`` (no kernel on
    "meta"). None for a plain table, or a layout this does not cover."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    if not isinstance(table, DTensor):
        return None
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = distribute_tensor(tokens, mesh,
                                   [Replicate()] * mesh.ndim,
                                   src_data_rank=None)
    if tokens.device_mesh != mesh:
        return None
    want, grad, out = [], [], []
    for tp, kp in zip(table.placements, tokens.placements):
        rows = type(kp) is Shard and kp.dim == 0
        if not (rows or kp.is_replicate()):
            return None
        if tp.is_replicate():
            want.append(tp)
            grad.append(Partial() if rows else tp)
            out.append(Shard(0) if rows else tp)
        elif type(tp) is Shard and tp.dim == 0 and not rows:
            want.append(tp)
            grad.append(tp)
            out.append(Partial())
        elif type(tp) is Shard and tp.dim == 1:
            want.append(Replicate() if rows else tp)
            grad.append(Partial() if rows else tp)
            out.append(Shard(0) if rows else Shard(2))
        else:
            return None
    if tuple(table.placements) != tuple(want):
        table = table.redistribute(mesh, want)
    (n, _), (off, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, want)
    tl = table.to_local(grad_placements=grad)
    idx = tokens.to_local() - off
    live = (idx >= 0) & (idx < n)
    rows = F.embedding(torch.where(live, idx, 0), tl)
    rows = torch.where(live[..., None], rows, 0.0)
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(rows, mesh, out, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _unembed(x, table):
    return torch.matmul(x.float(), table.float().t())


def unembed(params, x):
    """Tied-embedding logits, in float32 for a stable softmax."""
    return _head(x, params["embedding"], 0, _unembed)


def linear_head_schema(d: int, vocab: int):
    return {"w": P((d, vocab), ("embed", "vocab"), fanin_std(d))}


def _linear_head(x, w):
    return torch.matmul(x.float(), w.float())


def linear_head(params, x):
    return _head(x, params["w"], 1, _linear_head)


def _head(x, w, vocab_dim: int, fn):
    """``fn(x, w)``, the logits. Where the mesh axis the installed "btv"
    layout names does not divide the vocabulary (whisper's 51,865 over
    16), the weight, whole on that axis by the rules, is cut into
    ``DTensor``'s uneven chunks there (the first ranks ceil(V / n)
    columns, as XLA pads the split) and each rank computes its columns
    on local shards (`local_call`); the logits stay split so. Elsewhere
    (a plain tensor, no such axis, or one that divides the vocabulary,
    which ``DTensor``'s own rule splits) ``fn(x, w)`` as it is."""
    from torch.distributed.tensor import DTensor, Shard

    axis = split_axis("btv", 2)
    if axis is not None and isinstance(w, DTensor):
        mesh = w.device_mesh
        i = tuple(mesh.mesh_dim_names).index(axis)
        if w.shape[vocab_dim] % mesh.size(i) and \
                w.placements[i].is_replicate():
            placements = list(w.placements)
            placements[i] = Shard(vocab_dim)
            # roles (rows, vocabulary); the weight gathered where ZeRO-3
            # splits its width
            local = local_call(fn, (x, w.redistribute(mesh, placements)),
                               ((0, None), (None, vocab_dim)), ((0, 2),),
                               gather=(1,))
            if local is not None:
                return local
    return fn(x, w)


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
    masked out; ``z_loss`` adds z_loss * logsumexp^2 per token.

    Logits that are a ``DTensor`` (a step over a mesh, the vocabulary
    split over "model") take `_cross_entropy_parallel`: the max, the sum
    of exponentials and the gold logit each all-reduced over the
    vocabulary's shards. DTensor's ``logsumexp`` would gather the whole
    vocabulary on every rank, its ``gather`` over a split dim fails, and
    its ``loss_parallel`` takes a one-dimensional mesh only in some
    versions."""
    from torch.distributed.tensor import DTensor

    logits = logits.float()
    if isinstance(logits, DTensor):
        return _cross_entropy_parallel(logits, labels, z_loss)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


class _SumOver(torch.autograd.Function):
    """The sum of ``x`` over a process group's ranks; its backward hands
    each rank the gradient of its own term (every rank computes the same
    loss from the sum, so an all-reduce there would scale it by the
    group's size)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _cross_entropy_parallel(logits, labels, z_loss: float):
    """`cross_entropy_loss` of ``DTensor`` logits split over the batch
    and the vocabulary (at most one mesh dim), on each rank's shard with
    explicit collectives, never gathering the vocabulary: the max, the
    sum of exponentials and the gold logit each reduced over the
    vocabulary's group, then the masked sum and the token count over the
    batch's groups. Returns a replicated 0-d ``DTensor``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [i for i, p in enumerate(logits.placements) if p.is_shard(last)]
    batch = [i for i, p in enumerate(logits.placements) if p.is_shard(0)]
    if len(vocab) > 1 or len(vocab) + len(batch) != sum(
            not p.is_replicate() for p in logits.placements):
        raise ValueError(f"cross entropy over logits laid out as "
                         f"{logits.placements}")
    x = logits.to_local()
    rows = [Replicate() if i in vocab else p
            for i, p in enumerate(logits.placements)]
    lab = labels.redistribute(mesh, rows).to_local() \
        if isinstance(labels, DTensor) else \
        distribute_tensor(labels, mesh, rows, src_data_rank=None).to_local()
    m = x.detach().amax(dim=-1, keepdim=True)
    idx = torch.clamp(lab, min=0).long()
    if vocab:
        group = mesh.get_group(vocab[0])
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        # this rank's first column (the chunks may be uneven: the head's
        # split of a vocabulary the axis does not divide)
        idx = idx - compute_local_shape_and_global_offset(
            logits.shape, mesh, logits.placements)[1][last]
    inside = (idx >= 0) & (idx < x.shape[-1])
    gold = torch.where(inside, torch.gather(
        x, -1, torch.clamp(idx, 0, x.shape[-1] - 1)[..., None])[..., 0], 0.0)
    se = torch.exp(x - m).sum(dim=-1)
    if vocab:
        se, gold = _SumOver.apply(se, group), _SumOver.apply(gold, group)
    lse = torch.log(se) + m[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = (lab >= 0).float()
    total, count = torch.sum(nll * mask), torch.sum(mask)
    for i in batch:
        total = _SumOver.apply(total, mesh.get_group(i))
        count = _SumOver.apply(count, mesh.get_group(i))
    # replicated, so that it meets the other DTensor terms of the loss
    # (MoE's aux) as one
    return DTensor.from_local(total / torch.clamp(count, min=1.0), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)
