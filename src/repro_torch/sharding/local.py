"""Run a function on each rank's shards of its ``DTensor`` operands.

A recurrent scan, a token shift or a depthwise convolution treats every
row of the batch and every head (or channel) on its own. Where the mesh
splits its operands over those dims alike, a rank's shards are exact on
their own: `local_call` hands them to the one-device code as plain
tensors and wraps the results back into ``DTensor``s with their global
shapes. Every operation in between runs once, on the local shard, with
no ``DTensor`` dispatch, which is what a real rank runs and what makes
a chunk loop cost a dry run no more than its operations.

The operands name their dims by role: ``dims[j][r]`` is the dim of
argument j that carries role r (e.g. r = 0 the batch, r = 1 the heads),
or None where it has no such dim. The first argument's layout decides
which role each mesh dim splits (where it is whole there, the first
operand split over one of its roles does), and every operand is laid
out alike first: sliced locally where it is whole (no communication),
moved by an all-to-all where it is split over another dim, reduced
where it is a partial sum. An operand is never gathered to get there,
but for the ``gather`` arguments (the weights of the ZeRO-3 layout),
which are gathered as ``DTensor`` gathers them for a product. An
operand that lacks a role some mesh dim splits (a weight beside a batch
split over "data") is whole on each rank, and its gradient comes back
as a partial sum over that dim. A result that lacks a split role (a MoE
layer's sum over the experts) is a partial sum over that role's ranks;
the caller's layout reduces both. Where the layout is not local (the
first argument a partial sum or split over a dim that carries no role,
or another operand that would have to be gathered), `local_call`
returns None and the caller runs the ``DTensor`` path.
"""
from __future__ import annotations

import torch

__all__ = ["local_call"]


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(1, n)
    return tuple(reversed(stride))


def _roles(args, dims):
    """Per mesh dim, the role it splits: the one the first argument is
    split over there, else the first other operand's, else None; None
    when the first argument is split over a dim that carries no role,
    or is a partial sum."""
    from torch.distributed.tensor import DTensor, Shard

    roles = []
    for i, p in enumerate(args[0].placements):
        if type(p) is Shard and p.dim in dims[0]:   # not a strided split
            roles.append(dims[0].index(p.dim))
            continue
        if not p.is_replicate():
            return None
        roles.append(next((ds.index(q.dim) for a, ds in zip(args, dims)
                           if isinstance(a, DTensor)
                           for q in (a.placements[i],)
                           if type(q) is Shard and q.dim in ds), None))
    return roles


def local_call(fn, args, dims, out_dims, *, gather=()):
    """``fn(*local args)`` on this rank's shards, its result (a tensor or
    a tuple of tensors, ``out_dims`` giving each one's role dims) as
    ``DTensor``s; None when no argument is a ``DTensor`` or their layout
    is not local (see the module's docstring). ``args`` holds tensors
    only; a plain tensor is taken as replicated. An output with no dim
    for a role the mesh splits is a partial sum over that role's ranks
    (``fn`` contracts over it)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    lead = args[0]
    if not isinstance(lead, DTensor):
        return None
    mesh = lead.device_mesh
    if any(isinstance(a, DTensor) and a.device_mesh != mesh for a in args):
        return None
    roles = _roles(args, dims)
    if roles is None:
        return None
    sizes: dict = {}
    for a, ds in zip(args, dims):
        for r, d in enumerate(ds):
            if d is not None and sizes.setdefault(r, a.shape[d]) != \
                    a.shape[d]:
                return None
    wants = [tuple(Replicate() if r is None or ds[r] is None
                   else Shard(ds[r]) for r in roles) for ds in dims]
    for j, (a, want) in enumerate(zip(args, wants)):
        if j not in gather and isinstance(a, DTensor) and any(
                w.is_replicate() and p.is_shard()
                for p, w in zip(a.placements, want)):
            return None                   # no split operand is replicated
    local = []
    for a, ds, want in zip(args, dims, wants):
        if isinstance(a, DTensor):
            if tuple(a.placements) != want:
                a = a.redistribute(mesh, want)
            # an operand with no dim of a role the mesh splits (a weight
            # beside a split batch) gets a partial sum of its gradient
            # from each rank's rows
            local.append(a.to_local(grad_placements=tuple(
                Partial() if r is not None and ds[r] is None else w
                for r, w in zip(roles, want))))
        elif all(p.is_replicate() for p in want):
            local.append(a)
        else:
            local.append(distribute_tensor(a, mesh, want,
                                           src_data_rank=None).to_local())
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = []
    for o, ds in zip(outs, out_dims):
        shape = list(o.shape)
        placements = []
        for r in roles:
            if r is None:
                placements.append(Replicate())
            elif ds[r] is None:           # contracted over that role
                placements.append(Partial())
            else:
                shape[ds[r]] = sizes[r]
                placements.append(Shard(ds[r]))
        # the global stride given is the contiguous one: a permuted
        # local result (an einsum's) is laid out so first
        wrapped.append(DTensor.from_local(
            o.contiguous(), mesh, placements, run_check=False,
            shape=torch.Size(shape), stride=_contiguous_stride(shape)))
    return wrapped[0] if single else tuple(wrapped)

