"""Train step (the port's counterpart of the JAX package's
`train/step.py`), on one device or over a mesh.

State layout: {"params": ..., "opt": {"m", "v", "count"}, "step": int32
0-d}, every leaf a tensor on the device. The step runs ``model.loss``,
its backward (`torch.autograd.grad` over the float32 parameter leaves)
and `optim.adamw_update`, which updates the parameters and the optimizer
state in place, and returns (state, metrics) with the reference's metric
names: loss, ce, aux, grad_norm, lr and step, each a 0-d tensor on the
device (reading one waits for the step).

Over a mesh (``mesh=``, a ``DeviceMesh``), the parameters and the
optimizer state are ``DTensor``s laid out by the reference's sharding
trees (`sharding_tree` of the parameters, `opt_state_shardings`;
`distribute_state` lays a full state out), and each batch leaf is cut by
`batch_shardings_for`. The step is the same code: ``DTensor`` runs each
operation on the local shards and inserts the collectives its sharding
rules call for, as XLA's SPMD partitioner does for the reference's
``jit`` with ``in_shardings``. The activation constraints
(`sharding.ctx.constrain`) are installed for the step's duration, and
tensors the model makes itself (positions, masks, rotary tables) are
replicated, as a traced constant is. Where ``DTensor`` has no sharding
rule for an operation the step raises; nothing falls back to a
replicated copy.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import init_model_params
from repro_torch.models import layers as L
from repro_torch.models.layers import (abstract_params, tree_from_items,
                                       tree_items, tree_map)
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.rules import (NamedSharding, Strategy,
                                        distribute_tree, replicated,
                                        sharding_tree, spec_for)
from repro_torch.train import optim

__all__ = ["StepBundle", "make_train_step", "init_state", "abstract_state",
           "batch_shardings_for", "opt_state_shardings", "distribute_state",
           "mesh_context"]


@dataclasses.dataclass
class StepBundle:
    step_fn: Callable          # (state, batch) -> (state, metrics)
    abstract_state: Any        # the state's tree of "meta" tensors
    state_shardings: Any = None   # over a mesh: the state's NamedShardings
    batch_shardings: Any = None   # over a mesh: each batch leaf's
    mesh: Any = None


def abstract_state(model, opt_cfg: optim.OptConfig):
    """The state's shapes and dtypes as a tree of tensors on the "meta"
    device (no storage): the port's ``jax.eval_shape`` of `init_state`,
    the template `checkpoint.ckpt.restore` fills."""
    params = abstract_params(model.schema, model.cfg.param_dtype)
    return {"params": params,
            "opt": optim.abstract_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def _dp_degree(mesh) -> int:
    """The data-parallel degree: the "data" and "pod" axes' product."""
    sizes = mesh_axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)


def batch_shardings_for(batch_tree, mesh, strategy: Strategy):
    """The sharding of each batch leaf (anything with ``.shape``): its
    first dim as "batch" by the rules, a 0-d leaf replicated."""
    def one(t):
        if len(t.shape) == 0:
            return replicated(mesh)
        axes = ("batch",) + (None,) * (len(t.shape) - 1)
        return NamedSharding(mesh, spec_for(axes, tuple(t.shape), mesh,
                                            strategy))
    return tree_map(one, batch_tree)


def _heuristic_sharding(mesh, strategy: Strategy):
    """The sharding of a state leaf with no logical axes: its first dim
    over "data" where it divides, else replicated."""
    d = mesh_axis_sizes(mesh).get("data", 1)

    def one(t):
        shape = tuple(t.shape)
        if shape and shape[0] % d == 0 and shape[0] >= d:
            return NamedSharding(mesh, ("data",) + (None,) * (len(shape) - 1))
        return replicated(mesh)
    return one


def opt_state_shardings(abs_opt, param_shardings, mesh, strategy: Strategy,
                        opt_cfg: optim.OptConfig) -> dict:
    """The optimizer state's shardings: m (and a dense v) as the
    parameters; a qint8 v, whose leaves have another rank than their
    parameter, by `_heuristic_sharding`; the count replicated."""
    m_sh = tree_map(lambda _, s: s, abs_opt["m"], param_shardings)
    if opt_cfg.v_dtype == "qint8":
        v_sh = tree_map(_heuristic_sharding(mesh, strategy), abs_opt["v"])
    else:
        v_sh = tree_map(lambda _, s: s, abs_opt["v"], param_shardings)
    return {"m": m_sh, "v": v_sh, "count": replicated(mesh)}


def _to_device(batch, batch_tree, dev) -> dict:
    """The host batch as tensors on ``dev``, checked against
    ``batch_tree`` ({name: (shape, dtype)})."""
    if batch.keys() != batch_tree.keys():
        raise ValueError(f"batch has {sorted(batch)}, the step was made "
                         f"for {sorted(batch_tree)}")
    out = {}
    for k, (shape, dtype) in batch_tree.items():
        t = torch.as_tensor(np.asarray(batch[k]) if not isinstance(
            batch[k], torch.Tensor) else batch[k])
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"batch[{k!r}] has shape {tuple(t.shape)}, "
                             f"the step was made for {tuple(shape)}")
        out[k] = t.to(device=dev, dtype=dtype)
    return out


@contextlib.contextmanager
def mesh_context(mesh, strategy: Strategy):
    """What a step over ``mesh`` runs under: the strategy's activation
    constraints installed, and plain tensors that meet ``DTensor``s taken
    as replicated (``implicit_replication``: the positions, masks and
    tables the model makes from global shapes, the same on every rank)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with shard_ctx.activation_sharding(mesh, strategy.name), \
            implicit_replication():
        yield


def _local(t):
    """A 0-d metric as a plain tensor (a ``DTensor``'s full value)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _state_shardings(model, opt_cfg, mesh, strategy, abs_state) -> dict:
    param_sh = sharding_tree(L.axes_tree(model.schema), abs_state["params"],
                             mesh, strategy)
    return {"params": param_sh,
            "opt": opt_state_shardings(abs_state["opt"], param_sh, mesh,
                                       strategy, opt_cfg),
            "step": replicated(mesh)}


def distribute_state(state, bundle: StepBundle):
    """``state`` (every rank's full copy, e.g. `init_state` from one seed)
    laid out on ``bundle.mesh`` by its shardings: each rank keeps its own
    shard, nothing is sent. The step count stays a plain tensor."""
    return {"params": distribute_tree(state["params"],
                                      bundle.state_shardings["params"]),
            "opt": distribute_tree(state["opt"],
                                   bundle.state_shardings["opt"]),
            "step": state["step"]}


def make_train_step(model, opt_cfg: optim.OptConfig, batch_tree: dict, *,
                    device="cuda", mesh=None,
                    strategy: Strategy | None = None) -> StepBundle:
    """The train step of ``model`` on ``device`` (default the card) for
    batches shaped as ``batch_tree`` ({name: (shape, dtype)}, e.g.
    {"tokens": ((8, 256), torch.int32), "labels": ...}; the batch's
    arrays are moved to the device and cast to those dtypes).

    With ``mesh`` (a ``DeviceMesh`` whose ranks each run this step; its
    device is ``device``, or "meta" for a dry run) the state is the
    ``DTensor`` tree `distribute_state` makes, the batch is every rank's
    full global batch, cut by ``bundle.batch_shardings`` (each rank keeps
    its rows), and ``strategy`` (default ``Strategy("train")``) picks the
    layout."""
    dev = resolve_device(device)
    abs_state = abstract_state(model, opt_cfg)
    bundle = StepBundle(step_fn=None, abstract_state=abs_state, mesh=mesh)
    if mesh is not None:
        from torch.distributed.tensor import distribute_tensor

        strategy = strategy or Strategy("train")
        bundle.state_shardings = _state_shardings(model, opt_cfg, mesh,
                                                  strategy, abs_state)
        bundle.batch_shardings = batch_shardings_for(
            {k: torch.empty(shape, dtype=dtype, device="meta")
             for k, (shape, dtype) in batch_tree.items()}, mesh, strategy)

    def train_step(state, batch):
        batch = _to_device(batch, batch_tree, dev)
        scope = contextlib.nullcontext()
        if mesh is not None:
            batch = {k: distribute_tensor(
                t, mesh, bundle.batch_shardings[k].placements,
                src_data_rank=None) for k, t in batch.items()}
            scope = mesh_context(mesh, strategy)
        items = list(tree_items(state["params"]))
        leaves = [t.requires_grad_() for _, t in items]
        with scope:
            with torch.enable_grad():
                loss, metrics = model.loss(state["params"], batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            del loss
            if mesh is not None:   # a replicated leaf's gradient is Partial
                grads = [g.redistribute(p.device_mesh, p.placements)
                         for g, p in zip(grads, leaves)]
            grads = tree_from_items((path, g) for (path, _), g in
                                    zip(items, grads))
            _, _, stats = optim.adamw_update(grads, state["opt"],
                                             state["params"], opt_cfg)
            del grads
            metrics = {k: _local(v) for k, v in {**metrics, **stats}.items()}
        state["step"].add_(1)
        return state, {**metrics, "step": state["step"].clone()}

    bundle.step_fn = train_step
    return bundle


def init_state(model, opt_cfg: optim.OptConfig, seed: int = 0, *,
               device="cuda"):
    """Random float32 parameters from ``seed`` (`init_model_params`),
    zeroed optimizer state and step 0 on ``device``."""
    dev = resolve_device(device)
    params = init_model_params(model, seed, device=dev)
    return {"params": params, "opt": optim.init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
