"""Serving steps over a mesh: batched prefill and one-token decode with a
sharded KV cache or recurrent state (the port's counterpart of the JAX
package's `serve/step.py`).

The serving layout is the reference's (`sharding/rules.py`, strategy
"serve"): weights split over "model" and replicated over "data",
requests over ("pod", "data"), the KV cache over its kv heads where they
divide the model axis, else over the sequence. Weights are abstracted in
the compute dtype (a deployment casts them once on load); the cache
keeps the schema's per-leaf dtypes.

Where the reference ``jit``s each step with ``in_shardings`` and donates
the cache, the port's step functions run ``model.prefill`` /
``model.decode`` on ``DTensor``s laid out by `ServeBundle`'s shardings
(`distribute_tree`), with the activation constraints installed; decode
writes the cache in place, the port's counterpart of donation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models.api import abstract_cache
from repro_torch.models import layers as L
from repro_torch.sharding.rules import Strategy, sharding_tree
from repro_torch.train.step import batch_shardings_for, mesh_context

__all__ = ["ServeBundle", "make_serve_step"]


@dataclasses.dataclass
class ServeBundle:
    prefill_fn: Callable      # (params, batch, cache) -> (logits, new cache)
    decode_fn: Callable       # (params, batch, cache) -> (logits, cache)
    abstract_params: Any
    abstract_cache: Any
    param_shardings: Any
    cache_shardings: Any
    batch_shardings: Any
    mesh: Any


def make_serve_step(model, mesh, batch_tree: dict, *, batch_size: int,
                    max_len: int, strategy: Strategy | None = None):
    """The prefill and decode steps of ``model`` over ``mesh`` (a
    ``DeviceMesh``) for batches shaped as ``batch_tree`` (a tree of
    tensors, e.g. `configs.input_specs`'s "meta" ones) and a cache of
    ``batch_size`` slots of ``max_len`` rows. The step functions take
    the parameters, the batch and the cache as ``DTensor``s laid out by
    the bundle's shardings."""
    cfg = model.cfg
    strategy = strategy or Strategy("serve")
    abs_params = L.abstract_params(model.schema, cfg.compute_dtype)
    param_sh = sharding_tree(L.axes_tree(model.schema), abs_params, mesh,
                             strategy)
    abs_cache = abstract_cache(model, batch_size, max_len)
    cache_sh = sharding_tree(
        L.axes_tree(model.cache_schema(batch_size, max_len)), abs_cache,
        mesh, strategy)
    batch_sh = batch_shardings_for(batch_tree, mesh, strategy)

    def prefill_fn(params, batch, cache):
        with mesh_context(mesh, strategy):
            return model.prefill(params, batch, cache)

    def decode_fn(params, batch, cache):
        with mesh_context(mesh, strategy):
            return model.decode(params, batch, cache)

    return ServeBundle(prefill_fn=prefill_fn, decode_fn=decode_fn,
                       abstract_params=abs_params, abstract_cache=abs_cache,
                       param_shardings=param_sh, cache_shardings=cache_sh,
                       batch_shardings=batch_sh, mesh=mesh)
