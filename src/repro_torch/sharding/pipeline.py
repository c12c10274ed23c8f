"""GPipe pipeline parallelism over a mesh axis (the port's counterpart of
the JAX package's `sharding/pipeline.py`).

Layers are split into S contiguous stages along a mesh axis, one stage a
rank; M microbatches stream through the stages, each tick handing every
stage's activation to the next one round a ring (S - 1 wraps to 0, as
the reference's ``ppermute``). The schedule is the reference's: S + M - 1
ticks, stage 0 feeds microbatch clip(t, 0, M - 1) from its input and the
other stages take the hand-off, a stage runs only while
0 <= t - stage < M, the last stage records its finished microbatch, and
the result is summed over the stage axis, so every stage holds it.
Bubble fraction (S - 1) / (S + M - 1).

Where the reference ``shard_map``s the schedule and differentiates it
with ``jax.grad``, every rank here runs its stage of the schedule with
``torch.distributed`` and autograd:
  * each tick's hand-off is one ``batch_isend_irecv`` on the stage
    axis's group (a send to the next stage and a receive from the
    previous one posted together; blocking sends round a ring would
    deadlock), in a ``torch.autograd.Function`` whose backward hands the
    gradient the other way round the ring;
  * every hand-off is consumed on every rank (stage 0 selects its input
    over the received tensor with ``torch.where``), the wire starts as a
    tensor that requires grad, and the last tick's activation enters the
    final sum as an input of zero gradient, so each rank's autograd graph
    holds and reaches all its hand-offs and every rank runs the same
    backward exchanges in the same order;
  * the final sum is a broadcast from the last stage whose backward keeps
    the cotangent on the last stage only: each rank holds the same
    replica of the result and computes the same loss on it, and an
    all-reduce in the backward would scale the gradient by S.
With one stage the schedule runs with no communication.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["gpipe_apply", "bubble_fraction"]


def _exchange(send, recv_like, group, to: int, frm: int):
    """Send ``send`` to group rank ``to`` and receive a tensor shaped as
    ``recv_like`` from group rank ``frm``, posted together."""
    out = torch.empty_like(recv_like)
    ops = [dist.P2POp(dist.isend, send.contiguous(),
                      dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Forward: this stage's tensor to the next stage, the previous
    stage's in. Backward: the gradient the other way round."""

    @staticmethod
    def forward(ctx, x, group, sid: int, n: int):
        ctx.group, ctx.sid, ctx.n = group, sid, n
        return _exchange(x, x, group, (sid + 1) % n, (sid - 1) % n)

    @staticmethod
    def backward(ctx, g):
        sid, n = ctx.sid, ctx.n
        return (_exchange(g, g, ctx.group, (sid - 1) % n, (sid + 1) % n),
                None, None, None)


class _FromLast(torch.autograd.Function):
    """Forward: the last stage's ``outs`` on every stage (an all-reduce of
    ``outs`` there and zeros elsewhere). Backward: the cotangent on the
    last stage only; ``tail`` (the last tick's activation, an input so
    that the graph reaches every hand-off) gets zeros."""

    @staticmethod
    def forward(ctx, outs, tail, group, last: bool):
        ctx.last, ctx.tail = last, (tail.shape, tail.dtype, tail.device)
        y = outs.clone() if last else torch.zeros_like(outs)
        if group is not None:
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.tail
        return (g if ctx.last else torch.zeros_like(g),
                torch.zeros(shape, dtype=dtype, device=device), None, None)


def gpipe_apply(layer_fn, stage_params, x, *, mesh, stage_axis: str = "pipe",
                microbatches: int = 4, batch_axis: str | None = None):
    """Run a stacked layer function as a pipeline over ``stage_axis``.

    layer_fn(params_slice, x) -> x       one layer
    stage_params: a tree (dict, tuple or list) of tensors stacked
        (n_stages, layers_per_stage, ...); each rank reads its stage's
        slice.
    x: (batch, ...), the same on every stage (microbatched inside).
    mesh: a ``DeviceMesh`` with ``stage_axis`` (and ``batch_axis``).
    With ``batch_axis``, x is the global batch and each rank runs its
    block of rows along that axis (the reference's sharded batch).
    Returns this rank's rows of the result, x's shape without
    ``batch_axis``; every stage holds the same result.
    """
    from torch.utils._pytree import tree_map

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_stages = sizes[stage_axis]
    sid = mesh.get_local_rank(stage_axis)
    if batch_axis is not None:
        n_b = sizes[batch_axis]
        rows = x.shape[0] // n_b
        c = mesh.get_local_rank(batch_axis)
        x = x[c * rows:(c + 1) * rows]
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} is not a multiple of {microbatches} "
                         f"microbatches")
    mb = B // microbatches
    ticks = n_stages + microbatches - 1
    group = mesh.get_group(stage_axis) if n_stages > 1 else None
    params = tree_map(lambda p: p[sid], stage_params)
    n_layers = len(torch.utils._pytree.tree_leaves(params)[0])
    first = torch.tensor(sid == 0, device=x.device)

    def run_stage(h):
        for i in range(n_layers):
            h = layer_fn(tree_map(lambda p: p[i], params), h)
        return h

    xs = x.reshape(microbatches, mb, *x.shape[1:])
    # the inter-stage wire; it requires grad so that every hand-off has a
    # backward on every rank (a stage's first ticks only forward it)
    buf = torch.zeros_like(xs[0]).requires_grad_(torch.is_grad_enabled())
    outs = [torch.zeros_like(xs[0]) for _ in range(microbatches)]
    h_out = buf
    for t in range(ticks):
        feed = min(max(t, 0), microbatches - 1)
        # stage 0 consumes microbatch t from its input, the others the
        # activation handed over by the previous stage
        h_in = torch.where(first, xs[feed], buf) if group is not None \
            else xs[feed]
        live = 0 <= t - sid < microbatches
        h_out = run_stage(h_in) if live else h_in
        if live and sid == n_stages - 1:            # last stage records
            outs[min(max(t - (n_stages - 1), 0), microbatches - 1)] = h_out
        if group is not None and t < ticks - 1:     # nothing reads the last
            buf = _RingShift.apply(h_out, group, sid, n_stages)
    y = _FromLast.apply(torch.stack(outs), h_out, group,
                        sid == n_stages - 1)
    return y.reshape(x.shape)


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    return (n_stages - 1) / (n_stages + microbatches - 1)
