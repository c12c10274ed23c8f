"""Train step (the port's counterpart of the JAX package's
`train/step.py`), on one device.

State layout: {"params": ..., "opt": {"m", "v", "count"}, "step": int32
0-d}, every leaf a tensor on the device. The step runs ``model.loss``,
its backward (`torch.autograd.grad` over the float32 parameter leaves)
and `optim.adamw_update`, which updates the parameters and the optimizer
state in place, and returns (state, metrics) with the reference's metric
names: loss, ce, aux, grad_norm, lr and step, each a 0-d tensor on the
device (reading one waits for the step).

The reference's sharding trees of the state and the batch are given here
by `opt_state_shardings` and `batch_shardings_for` over the port's rules
(`sharding/rules.py`): `NamedSharding`s, whose ``placements`` lay a
tensor out on a ``DeviceMesh``. The step itself
runs on one device, so `StepBundle` carries the step function and the
abstract state only; a step over a mesh of more than one rank is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models import init_model_params
from repro_torch.models.layers import (abstract_params, tree_from_items,
                                       tree_items, tree_map)
from repro_torch.sharding.rules import (NamedSharding, Strategy,
                                        replicated, spec_for)
from repro_torch.train import optim

__all__ = ["StepBundle", "make_train_step", "init_state", "abstract_state",
           "batch_shardings_for", "opt_state_shardings"]


@dataclasses.dataclass
class StepBundle:
    step_fn: Callable          # (state, batch) -> (state, metrics)
    abstract_state: Any        # the state's tree of "meta" tensors


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


def make_train_step(model, opt_cfg: optim.OptConfig, batch_tree: dict, *,
                    device="cuda") -> StepBundle:
    """The train step of ``model`` on ``device`` (default the card) for
    batches shaped as ``batch_tree`` ({name: (shape, dtype)}, e.g.
    {"tokens": ((8, 256), torch.int32), "labels": ...}; the batch's
    arrays are moved to the device and cast to those dtypes)."""
    dev = resolve_device(device)

    def train_step(state, batch):
        batch = _to_device(batch, batch_tree, dev)
        items = list(tree_items(state["params"]))
        leaves = [t.requires_grad_() for _, t in items]
        with torch.enable_grad():
            loss, metrics = model.loss(state["params"], batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        del loss
        grads = tree_from_items((path, g) for (path, _), g in
                                zip(items, grads))
        _, _, stats = optim.adamw_update(grads, state["opt"],
                                         state["params"], opt_cfg)
        del grads
        state["step"].add_(1)
        return state, {**metrics, **stats, "step": state["step"].clone()}

    return StepBundle(step_fn=train_step,
                      abstract_state=abstract_state(model, opt_cfg))


def init_state(model, opt_cfg: optim.OptConfig, seed: int = 0, *,
               device="cuda"):
    """Random float32 parameters from ``seed`` (`init_model_params`),
    zeroed optimizer state and step 0 on ``device``."""
    dev = resolve_device(device)
    params = init_model_params(model, seed, device=dev)
    return {"params": params, "opt": optim.init_opt_state(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}
