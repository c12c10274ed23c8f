"""Logical activation-sharding constraints, context-scoped (the port's
counterpart of the JAX package's `sharding/ctx.py`).

A step that runs over a mesh installs a spec table for it; model code
calls ``constrain(x, "btd")`` at the reference's points (the embedded
tokens, every repeat of the layer stack, the logits). ``constrain``
redistributes a ``DTensor`` to the kind's placements (a dim the mesh
does not divide left whole), and its gradient in the backward as well;
it returns its
argument unchanged outside an installed context, on a plain tensor, and
on a tensor whose rank is not the kind's, so single-device runs are
unaffected.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

from repro_torch.launch.mesh import mesh_axis_sizes

__all__ = ["make_activation_specs", "activation_sharding", "install",
           "constrain", "pin", "split_axis"]

# (mesh, {kind: spec}) while a table is installed
_STATE: Optional[tuple] = None


def make_activation_specs(mesh, strategy: str = "train") -> dict:
    """{kind: spec} for ``mesh`` (a `launch.mesh.MeshShape` or a
    ``DeviceMesh``): the batch over the data-parallel axes (every axis
    for the fsdp strategies), the vocabulary and heads over "model"
    otherwise. A spec is the reference's ``PartitionSpec`` entries."""
    names = set(mesh_axis_sizes(mesh))
    if strategy in ("fsdp", "serve_fsdp"):
        dp = tuple(a for a in ("pod", "data", "model") if a in names)
        tp = None            # weights are gathered; no TP-sharded activations
    else:
        dp = tuple(a for a in ("pod", "data") if a in names)
        tp = "model" if "model" in names else None
    dp_entry = dp if len(dp) > 1 else (dp[0] if dp else None)
    return {
        "btd": (dp_entry, None, None),       # (batch, seq, d_model)
        "bt": (dp_entry, None),              # (batch, seq) token planes
        "btv": (dp_entry, None, tp),         # logits: vocab over TP
        "bthd": (dp_entry, None, tp, None),  # heads over TP
    }


@contextlib.contextmanager
def activation_sharding(mesh, strategy: str = "train"):
    """Install the table of ``mesh`` for the ``with`` block."""
    global _STATE
    prev = _STATE
    _STATE = (mesh, make_activation_specs(mesh, strategy))
    try:
        yield
    finally:
        _STATE = prev


def install(mesh, strategy: str = "train") -> None:
    """Install the table of ``mesh`` until the next call (``None``
    removes it)."""
    global _STATE
    _STATE = (mesh, make_activation_specs(mesh, strategy)) \
        if mesh is not None else None


def split_axis(kind: str, dim: int) -> Optional[str]:
    """The one mesh axis the installed table splits dim ``dim`` of
    ``kind`` over, else None (no table, the dim whole or over several
    axes)."""
    if _STATE is None:
        return None
    spec = _STATE[1].get(kind)
    entry = spec[dim] if spec is not None else None
    return entry if isinstance(entry, str) else None


def constrain(x, kind: str):
    """``x`` redistributed to the installed ``kind``'s placements when it
    is a ``DTensor`` of that rank; else ``x`` itself."""
    if _STATE is None:
        return x
    mesh, specs = _STATE
    spec = specs.get(kind)
    if spec is None or x.ndim != len(spec):
        return x
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.sharding.rules import placements_for

    if not isinstance(x, DTensor):
        return x
    # a dim the mesh does not divide stays whole, as `rules.spec_for`
    # leaves it (DTensor cannot flatten an unevenly split dim: a batch of
    # one over "data"), unless the model split it so itself (the head's
    # logits over a vocabulary "model" does not divide, `layers._head`)
    sizes = mesh_axis_sizes(mesh)
    spec = tuple(e if e is None or x.shape[d] % math.prod(
        sizes[a] for a in ((e,) if isinstance(e, str) else e)) == 0
        or isinstance(e, str) and x.placements[
            tuple(mesh.mesh_dim_names).index(e)] == Shard(d)
        else None for d, e in enumerate(spec))
    return pin(x, placements_for(spec, mesh))


def pin(x, placements):
    """A ``DTensor`` redistributed to ``placements``, whose gradient is
    redistributed to ``placements`` as well in the backward, as the
    transpose of the reference's with_sharding_constraint is one on the
    cotangent (``from_local``'s backward redistributes the incoming
    gradient: a partial sum is reduced here, where DTensor would rather
    gather the next product's weights)."""
    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    y = x.redistribute(mesh, placements)
    return DTensor.from_local(y.to_local(), mesh, placements,
                              run_check=False, shape=y.shape,
                              stride=y.stride())
