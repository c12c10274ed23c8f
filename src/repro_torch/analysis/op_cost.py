"""Per-device operation counts of one step (the port's counterpart of the
JAX package's `analysis/hlo_cost.py`).

The reference parses the optimised HLO of a step that XLA partitioned
for one device. The port has no HLO: `analyze` runs the step once under
a dispatch mode (`OpCounter`) and counts the operations this rank runs
itself. Run it on "meta" tensors (shapes and dtypes, no storage) and on
the ``DTensor``s of a fake process group (``"fake"`` backend: any world
size in one process, collectives that move nothing), and it sizes a
production step without a device.

A ``DTensor`` operation is not counted as such: the mode hands it back
to ``DTensor`` (``NotImplemented``), which redistributes its operands
(functional collectives) and runs the operation on the local shards,
and those local operations are what the mode counts. A global count
(``FlopCounterMode`` over ``DTensor``s) would charge every rank the
whole product. The fake tensors on which ``DTensor`` works out an
output's global shape (once an operation signature), and the tensors of
global shape it makes them from, are not counted.

Counts:
  * ``flops``: products and convolutions (``torch.utils.flop_counter``'s
    formulas), this rank's share, backward and rematerialisation
    included as they run;
  * ``bytes``: the inputs and outputs of every operation that computes
    or moves data (views cost nothing), as eager PyTorch runs them:
    nothing is fused. Not the reference's accounting (XLA's bytes at its
    fusion boundaries, donated buffers and in-place updates as XLA
    lowers them), so the two can differ either way;
  * ``transcendentals``: output elements of exp, log, tanh, sigmoid,
    rsqrt, sin, cos and their kin;
  * ``dtensor_ops``: the operations ``DTensor`` dispatched (each costs
    the host its sharding propagation; a loop run on local shards
    dispatches none);
  * ``collectives``: {kind: {count, bytes, group_size, ib_bytes}} with the
    reference's HLO names (all-reduce, all-gather, reduce-scatter,
    all-to-all) and send / recv for point-to-point. ``bytes`` is what
    one rank moves (the larger of input and output); ``ib_bytes`` the
    part in groups that span more than one node of `NODE_SIZE`
    consecutive ranks (the reference's ``dcn_bytes``, there the groups
    that cross a pod).

With ``by_op`` (`analyze(..., by_op=n)`, ``launch/dryrun.py --by-op
N``) the record also holds the ``n`` largest entries of ``flops`` by
product: the operation, its local operands' shapes and the innermost
frame of the port that ran it (a backward product runs from the
step's ``autograd.grad``), each with its FLOPs summed over the step.
Where a cell's count is off, the product that takes the excess shows
there with its shapes, which say which dim the rank ran whole.

Memory, in the same run: the bytes this rank holds as the step runs.
The arguments (parameters, optimizer state, batch, cache: their local
shards) are live throughout; every tensor an operation makes is live
from that operation until its storage dies (a ``weakref`` finalizer on
the storage: a view or an in-place result adds nothing, autograd's saved
tensors stay live until the backward releases them, and a "meta"
storage dies where a real one would). `analyze` records the peak and
the bytes of the step's outputs beside the arguments, under the
reference's names (XLA's ``memory_analysis()``):
``argument_size_in_bytes``, ``output_size_in_bytes``,
``temp_size_in_bytes`` (the peak less the arguments) and
``peak_bytes``. XLA's ``generated_code_size_in_bytes`` has no
counterpart (eager PyTorch generates no program) and is not recorded.
The two accountings differ: XLA assigns buffers over a whole compiled
program (reusing, aliasing donated arguments), the port counts eager
liveness, tensor by tensor, as the caching allocator would see it
without its rounding or fragmentation.
"""
from __future__ import annotations

import math
import sys
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["NODE_SIZE", "OpCounter", "analyze", "local_bytes"]

NODE_SIZE = 8            # H100 GPUs a node on NVLink; between nodes InfiniBand

_VIEWS = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t", "expand",
    "slice", "select", "unsqueeze", "squeeze", "as_strided", "alias",
    "detach", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "view_as_real", "view_as_complex", "lift_fresh", "_to_copy_meta",
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "wait_tensor", "_wrap_tensor_autograd", "sym_size", "sym_stride",
    "sym_numel", "is_same_size", "_local_scalar_dense",
}
_TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log1p", "log2", "log10",
    "tanh", "tanh_backward", "sigmoid", "sigmoid_backward", "silu",
    "silu_backward", "gelu", "gelu_backward", "rsqrt", "sqrt", "sin", "cos",
    "erf", "pow", "logsumexp", "_log_softmax", "_softmax",
    "_log_softmax_backward_data", "_softmax_backward_data",
}
# functional and c10d collectives -> the reference's HLO names
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast_": "collective-broadcast", "broadcast": "collective-broadcast",
    "send": "send", "recv_": "recv",
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_ranks(name: str, args, kwargs) -> list:
    """The global ranks a collective spans: its group's (functional
    collectives name the group, c10d ops pass it boxed); for send and
    recv this rank and its peer."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = None
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                group = _resolve_process_group(a)
                break
            except (ValueError, RuntimeError):
                continue
        if isinstance(a, torch.ScriptObject):
            group = dist.ProcessGroup.unbox(a)
            break
    if group is None:
        return []
    ranks = dist.get_process_group_ranks(group)
    if name in ("send", "recv_"):       # (tensors, group, peer, tag)
        return [dist.get_rank(), ranks[args[2]]]
    return ranks


def _in_sharding_propagation() -> bool:
    """Whether the caller runs inside ``DTensor``'s sharding propagation,
    which makes a tensor of an operand's global shape (then a fake one
    from it) to work out an output's: a storage no rank holds."""
    f = sys._getframe(2)
    for _ in range(32):
        if f is None:
            return False
        if f.f_code.co_filename.endswith(("_sharding_prop.py",
                                          "_op_schema.py")):
            return True
        f = f.f_back
    return False


def _site() -> str:
    """The innermost frame of the port outside this module and
    `sharding/local.py` (whose caller ran the product), as
    "models/mamba.py:160"."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in name and not name.endswith(
                ("/op_cost.py", "/sharding/local.py")):
            return f"{name.rsplit('/repro_torch/', 1)[1]}:{f.f_lineno}"
        f = f.f_back
    return "?"


class OpCounter(TorchDispatchMode):
    """Counts the local operations run under it (see the module's
    docstring); ``record()`` gives `analyze`'s dict. With ``by_op`` it
    also sums ``flops`` by (operation, operand shapes, site)."""

    def __init__(self, by_op: bool = False):
        super().__init__()
        self.by_op: Optional[dict] = {} if by_op else None
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.elementwise = 0
        self.dtensor_ops = 0     # operations DTensor dispatched
        self.collectives: dict = {}
        self.live = 0            # bytes held now
        self.peak = 0            # the most held at once
        self._held: dict = {}    # storage key -> bytes, while it lives

    def hold(self, tensors, *, counted: bool = True) -> None:
        """Count the storages of ``tensors`` (``DTensor``s by their local
        shards) live until they die; ``counted=False`` marks them seen
        at no bytes (the arguments, counted by `hold_arguments`)."""
        from torch.distributed.tensor import DTensor

        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue          # a tensor with no storage of its own
            key = st._cdata
            if key in self._held:
                continue
            n = st.nbytes() if counted else 0
            self._held[key] = n
            self.live += n
            weakref.finalize(st, self._release, key)
        self.peak = max(self.peak, self.live)

    def hold_arguments(self, tensors, nbytes: int) -> None:
        """The step's arguments: ``nbytes`` (their local shards' bytes,
        a view's storage may be larger) live throughout."""
        self.hold(tensors, counted=False)
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _release(self, key) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            self.dtensor_ops += 1
            return NotImplemented          # let DTensor run the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or \
                not types and _in_sharding_propagation():
            return out     # DTensor's shape propagation, on global shapes
        outs = _tensors(out)
        self.hold(outs)
        name = func.__name__.split(".")[0]
        if name in _VIEWS:
            return out
        ins = _tensors((args, kwargs))
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            ranks = _group_ranks(name, args, kwargs)
            moved = max(_nbytes(ins), _nbytes(outs))
            d = self.collectives.setdefault(kind, {
                "count": 0, "bytes": 0, "group_size": 0, "ib_bytes": 0})
            d["count"] += 1
            d["bytes"] += moved
            d["group_size"] = max(d["group_size"], len(ranks))
            if len({r // NODE_SIZE for r in ranks}) > 1:
                d["ib_bytes"] += moved
            self.bytes += _nbytes(ins) + _nbytes(outs)
            return out
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            if self.by_op is not None and n:
                key = (name, tuple(tuple(t.shape) for t in ins), _site())
                self.by_op[key] = self.by_op.get(key, 0) + n
        else:
            n = sum(t.numel() for t in outs)
            self.elementwise += n
            if name in _TRANSCENDENTAL:
                self.transcendentals += n
        self.bytes += _nbytes(ins) + _nbytes(outs)
        return out

    def record(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "transcendentals": self.transcendentals,
            "elementwise": self.elementwise,
            "dtensor_ops": self.dtensor_ops,
            "collectives": {k: dict(v) for k, v in
                            sorted(self.collectives.items())},
            "collective_bytes": sum(v["bytes"]
                                    for v in self.collectives.values()),
            "collective_ib_bytes": sum(v["ib_bytes"]
                                       for v in self.collectives.values()),
        }


def analyze(fn, *args, by_op: int = 0) -> dict:
    """The counts of one run of ``fn(*args)``, with its ``memory`` and,
    with ``by_op``, its ``by_op`` largest products (see the module's
    docstring); its result is dropped. The caller builds the inputs:
    "meta" tensors, or ``DTensor``s on a (fake) process group's mesh."""
    counter = OpCounter(by_op=by_op > 0)
    arg_bytes = local_bytes(args)
    counter.hold_arguments(_tensors(args), arg_bytes)
    with counter:
        out = fn(*args)
    rec = counter.record()
    if by_op:
        top = sorted(counter.by_op.items(), key=lambda kv: -kv[1])[:by_op]
        rec["by_op"] = [{"op": op, "shapes": [list(s) for s in shapes],
                         "site": site, "flops": f}
                        for (op, shapes, site), f in top]
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "output_size_in_bytes": local_bytes(out),
                     "temp_size_in_bytes": counter.peak - arg_bytes,
                     "peak_bytes": counter.peak}
    return rec


def local_bytes(tree) -> int:
    """The bytes this rank holds of a tree of tensors (a ``DTensor`` by
    its local shard)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _tensors(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        total += math.prod(t.shape) * t.element_size()
    return total
