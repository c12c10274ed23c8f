"""Logical-axis -> mesh-axis sharding rules (the port's counterpart of the
JAX package's `sharding/rules.py`).

Each parameter, cache and input tensor carries a tuple of logical axis
names (`models/layers.py`). A `Strategy` maps those names to mesh axes
with divisibility-aware fallbacks. `spec_for` gives, per tensor dim, the
reference's ``PartitionSpec`` entry (None, an axis name, or a tuple of
axis names for a dim split over several axes, the first one major). A
`NamedSharding` is a spec on a mesh, as the reference's: on a
`launch.mesh.MeshShape` (a production mesh, described) it is the spec;
on a ``DeviceMesh`` its ``placements`` are the ``torch.distributed.tensor``
placements, ``Shard(dim)`` or ``Replicate()`` per mesh dim
(`placements_for`).

Train strategy (FSDP x TP, DP over pod+data):
    batch -> (pod, data);  heads/kv_heads/vocab/mlp/experts -> model (TP/EP);
    embed -> data (ZeRO-3 parameter sharding);  layers/head_dim/state/... ->
    replicated.

Serve strategy (TP only, weights replicated across data):
    batch -> (pod, data);  heads/... -> model;  cache seq -> model when the
    kv-head count does not divide the TP degree (a sequence-sharded KV
    cache), or -> data when batch cannot use it.

The fsdp strategies put batch over every axis and shard the weights for
storage. A dim is only split where it divides the axes' product exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.layers import tree_map

__all__ = ["Strategy", "NamedSharding", "spec_for", "sharding_tree",
           "placements_for", "replicated", "batch_sharding",
           "distribute_tree"]

# logical name -> ordered candidate lists of mesh-axis groups
_TRAIN_CANDIDATES = {
    "batch": [("pod", "data"), ("data",), ("pod",)],
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "mlp": [("model",)],
    "experts": [("model",)],
    "embed": [("data",)],          # FSDP / ZeRO-3
    "seq": [],
    "expert_mlp": [],
    "layers": [], "head_dim": [], "conv": [], "state": [], "pos": [],
}

_SERVE_CANDIDATES = {
    **_TRAIN_CANDIDATES,
    "embed": [],                   # weights replicated across data
    "seq": [("model",), ("data",), ("pod",)],  # the cache's fallback
}

# pure FSDP (ZeRO-3): batch over every axis, weights fully sharded for
# storage and gathered per layer
_FSDP_CANDIDATES = {
    "batch": [("pod", "data", "model"), ("data", "model"), ("data",)],
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "mlp": [("model",)],
    "experts": [("model",)],
    "embed": [("data",)],
    "seq": [],
    "expert_mlp": [],
    "layers": [], "head_dim": [], "conv": [], "state": [], "pos": [],
}

# assignment priority: lower = assigned first (first pick of mesh axes)
_PRIORITY = {"batch": 0, "vocab": 1, "heads": 1, "kv_heads": 1, "mlp": 1,
             "experts": 1, "seq": 2, "embed": 3}


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str = "train"            # train | serve | fsdp | serve_fsdp

    def candidates(self) -> dict:
        return {"train": _TRAIN_CANDIDATES,
                "serve": _SERVE_CANDIDATES,
                "fsdp": _FSDP_CANDIDATES,
                "serve_fsdp": _FSDP_CANDIDATES}[self.name]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any              # a launch.mesh.MeshShape or a DeviceMesh
    spec: tuple            # per tensor dim: None, an axis, a tuple of axes

    @property
    def placements(self) -> tuple:
        """The spec's placements on ``mesh``, a ``DeviceMesh``."""
        return placements_for(self.spec, self.mesh)


def spec_for(axes, shape, mesh, strategy: Strategy) -> tuple:
    """Greedy divisibility-aware assignment of mesh axes to tensor dims:
    per dim None, an axis name, or a tuple of axis names (the reference's
    ``PartitionSpec`` entries). ``mesh`` is a `launch.mesh.MeshShape` or
    a ``DeviceMesh``."""
    sizes = mesh_axis_sizes(mesh)
    cands = strategy.candidates()
    order = sorted([i for i, n in enumerate(axes) if n],
                   key=lambda i: _PRIORITY.get(axes[i], 9))
    entries: dict[int, tuple] = {}
    used: set = set()
    for i in order:
        for group in cands.get(axes[i], []):
            if any(a not in sizes or a in used for a in group):
                continue
            prod = 1
            for a in group:
                prod *= sizes[a]
            if shape[i] < prod or shape[i] % prod != 0:
                continue
            entries[i] = group
            used.update(group)
            break
    return tuple(None if i not in entries else
                 entries[i][0] if len(entries[i]) == 1 else entries[i]
                 for i in range(len(axes)))


def placements_for(spec: tuple, mesh) -> tuple:
    """The ``DeviceMesh`` placements of a spec: per mesh dim, ``Shard(d)``
    where the spec splits tensor dim d over that axis, else
    ``Replicate()``. A dim split over several axes becomes one
    ``Shard(d)`` on each of them; DTensor splits it over the mesh dims in
    mesh order, the first one major, which is the reference's layout of a
    grouped entry when the group lists its axes in mesh order (as every
    candidate does). Raises on a group out of mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {group} of dim {d} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def sharding_tree(schema_axes, abstract_tree, mesh, strategy: Strategy):
    """A tree of logical-axis tuples and the matching tree of abstract
    tensors (anything with ``.shape``) -> the tree of `NamedSharding`s of
    each leaf's `spec_for` on ``mesh``."""
    return tree_map(lambda axes, t: NamedSharding(
        mesh, spec_for(axes, tuple(t.shape), mesh, strategy)),
        schema_axes, abstract_tree)


def distribute_tree(tree, shardings):
    """A tree of full tensors (the same on every rank) as ``DTensor``s laid
    out by the matching tree of `NamedSharding`s on their ``DeviceMesh``:
    each rank keeps its own shard and nothing is sent
    (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda t, s: distribute_tensor(
        t, s.mesh, s.placements, src_data_rank=None), tree, shardings)


def replicated(mesh) -> NamedSharding:
    """Every mesh dim replicated."""
    return NamedSharding(mesh, ())


def batch_sharding(mesh, strategy: Strategy, *, ndim: int,
                   batch_divisible: bool) -> NamedSharding:
    """A (B, ...) input's sharding: batch over the strategy's first batch
    group whose axes the mesh has, if ``batch_divisible``, else
    replicated."""
    sizes = mesh_axis_sizes(mesh)
    for group in strategy.candidates()["batch"]:
        if all(a in sizes for a in group):
            spec = (group if len(group) > 1 else group[0],) + \
                (None,) * (ndim - 1)
            return NamedSharding(mesh, spec) if batch_divisible \
                else replicated(mesh)
    return replicated(mesh)
