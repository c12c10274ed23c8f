"""Mixture-of-Experts layer with GShard-style capacity-based dispatch (the
port's counterpart of the JAX package's `models/moe.py`).

Tokens are split into groups; in each group every token picks its top-k
experts and a slot in each one's capacity buffer, slot by slot over the
k choices in token order. Dispatch and combine are dense products over
one-hot (group, token, expert, slot) tensors in the compute dtype, so
every expert's weights are read at every call, as in the reference.
Tokens that overflow an expert's capacity are dropped (the caller's
residual carries them); ``capacity_factor`` sets the drop rate.

The top-k order is the reference's: ties between equal router
probabilities go to the lower expert index first (a stable descending
sort), because the order of the k slots decides which tokens overflow.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import _ACTS as ACTS, P, fanin_std
from repro_torch.sharding.local import local_call

__all__ = ["moe_schema", "moe_layer", "moe_layer_dense_oracle", "top_k"]


def moe_schema(cfg):
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_ff_expert
    s = {
        "router": P((d, E), ("embed", "experts"), fanin_std(d),
                    torch.float32),
        "w_gate": P((E, d, f), ("experts", "embed", "expert_mlp"),
                    fanin_std(d)),
        "w_in": P((E, d, f), ("experts", "embed", "expert_mlp"),
                  fanin_std(d)),
        "w_out": P((E, f, d), ("experts", "expert_mlp", "embed"),
                   fanin_std(f)),
    }
    if m.num_shared:
        fs = m.d_ff_shared * m.num_shared  # the shared experts as one MLP
        s["shared"] = {
            "w_gate": P((d, fs), ("embed", "mlp"), fanin_std(d)),
            "w_in": P((d, fs), ("embed", "mlp"), fanin_std(d)),
            "w_out": P((fs, d), ("mlp", "embed"), fanin_std(fs)),
        }
    return s


def _capacity(sg: int, k: int, E: int, factor: float) -> int:
    c = int(math.ceil(sg * k * factor / E))
    return max(4, ((c + 3) // 4) * 4)


def top_k(probs, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    in ascending index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int):
    """float32 one-hot of ``idx`` over ``n`` classes; an index outside
    [0, n) gives a zero row (``jax.nn.one_hot``'s rule)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(logits, k: int):
    """Softmax router probabilities, the top-k gates renormalised to sum
    to one, and the top-k expert indices."""
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def _shared_mlp(sp, x, act: str, cd):
    h = ACTS[act](torch.matmul(x, sp["w_gate"].to(cd)))
    h = h * torch.matmul(x, sp["w_in"].to(cd))
    return torch.matmul(h, sp["w_out"].to(cd))


def _dispatch(dispatch, xg, experts):
    """The tokens gathered into their experts' slots: the one-hot
    dispatch (G, sg, E, C) and the tokens (G, sg, d) give (E, G, C, d).
    Over a mesh that splits the experts (where ``experts``, an expert
    weight, is split on its first dim), each rank gathers its own
    experts' slots on local shards (`local_call`: the dispatch, whole
    there, is cut on its experts without communication), and the sum
    over a group's tokens is a partial one where they are split. XLA
    splits this product over the expert ranks; ``DTensor``'s own rule
    ran it for every expert on each of them and cut the result after."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(dispatch, DTensor) and isinstance(experts, DTensor) and \
            experts.device_mesh == dispatch.device_mesh:
        placements = [Shard(2) if type(e) is Shard and e.dim == 0 and
                      p.is_replicate() else p
                      for p, e in zip(dispatch.placements,
                                      experts.placements)]
        # roles (group, token, expert); the output's sum over the tokens
        local = local_call(
            lambda c, x: torch.einsum("gsec,gsd->egcd", c, x),
            (dispatch.redistribute(dispatch.device_mesh, placements), xg),
            ((0, 1, 2), (0, 1, None)), ((1, None, 0),))
        if local is not None:
            return local
    return torch.einsum("gsec,gsd->egcd", dispatch, xg)


def _combine(combine, eo):
    """The experts' outputs ``eo`` (E, G, C, d) gathered back to their
    tokens by the combine weights (G, sg, E, C): (G, sg, d). Over a mesh
    that splits the groups and the experts, it runs on each rank's
    groups and experts (`local_call`) and the sum over the experts is a
    partial one over the ranks that split them (reduced by the caller's
    layout). ``DTensor``'s own rule gathered ``eo`` over the expert ranks
    and ran the product on each of them, and choosing that layout on the
    two-pod mesh took most of a MoE cell's trace."""
    local = local_call(
        lambda c, e: torch.einsum("gsec,egcd->gsd", c, e), (combine, eo),
        ((0, 2), (1, 0)), ((0, None),))
    if local is not None:
        return local
    return torch.einsum("gsec,egcd->gsd", combine, eo)


def moe_layer(params, x, cfg):
    """x: (B, S, d) -> (y, aux_loss). Overflowing tokens are dropped
    (their identity path is the caller's residual)."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.top_k
    T = B * S
    sg = min(m.group_size, T)
    while T % sg:  # largest divisor of T <= group_size (odd lengths)
        sg -= 1
    G = T // sg
    xg = x.reshape(G, sg, d)

    # routing in float32 (a stable softmax)
    logits = torch.matmul(xg.float(), params["router"].float())
    probs, gates, idx = _route(logits, k)                  # (G, sg, k)

    # the Switch load-balancing loss: mean probability x top-1 share
    me = probs.mean(dim=(0, 1))
    ce = _one_hot(idx[..., 0], E).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce) * m.aux_loss_weight

    # capacity assignment, slot by slot over the k choices
    C = _capacity(sg, k, E, m.capacity_factor)
    counts = torch.zeros((G, E), dtype=torch.float32, device=x.device)
    combine = torch.zeros((G, sg, E, C), dtype=torch.float32,
                          device=x.device)
    for slot in range(k):
        oh = _one_hot(idx[..., slot], E)                   # (G, sg, E)
        pos = torch.cumsum(oh, dim=1) - 1.0 + counts[:, None, :]
        keep = (pos < C) & (oh > 0)
        pos_oh = _one_hot(pos.to(torch.int32), C)          # (G, sg, E, C)
        combine = combine + (gates[..., slot, None, None]
                             * torch.where(keep, oh, 0.0)[..., None]
                             * pos_oh)
        counts = counts + oh.sum(dim=1)

    cd = cfg.compute_dtype
    dispatch = (combine > 0).to(cd)
    # dispatch -> every expert's FFN over its C slots -> combine
    xin = _dispatch(dispatch, xg.to(cd), params["w_gate"])
    h = ACTS[cfg.act](torch.einsum("egcd,edf->egcf", xin,
                                   params["w_gate"].to(cd)))
    h = h * torch.einsum("egcd,edf->egcf", xin, params["w_in"].to(cd))
    eo = torch.einsum("egcf,efd->egcd", h, params["w_out"].to(cd))
    y = _combine(combine.to(cd), eo)
    if "shared" in params:
        y = y + _shared_mlp(params["shared"], xg, cfg.act, cd)
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_layer_dense_oracle(params, x, cfg):
    """O(E) oracle for tests: EVERY expert runs on every token, weighted
    by the full top-k gates, without capacity drops."""
    m = cfg.moe
    logits = torch.matmul(x.float(), params["router"].float())
    probs, gates, idx = _route(logits, m.top_k)
    w = torch.zeros_like(probs).scatter(-1, idx, gates)
    act = ACTS[cfg.act]
    h = act(torch.einsum("bsd,edf->besf", x, params["w_gate"]))
    h = h * torch.einsum("bsd,edf->besf", x, params["w_in"])
    eo = torch.einsum("besf,efd->besd", h, params["w_out"])
    y = torch.einsum("bse,besd->bsd", w.to(x.dtype), eo)
    if "shared" in params:
        y = y + _shared_mlp(params["shared"], x, cfg.act, x.dtype)
    return y
