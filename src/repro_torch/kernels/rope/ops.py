"""Public API of the RoPE kernel.

Dispatches on the device of its input: a CUDA tensor launches the kernel
(`kernel.rope_cuda`), a CPU tensor runs its plain version. The entry
takes no learned parameters, so nothing is carried across from the JAX
package but the semantics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.rope.kernel import rope_cuda, rope_plain

__all__ = ["rope"]


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0,
         layout: str = "interleaved") -> torch.Tensor:
    """Apply rotary embedding. x: (..., S, H, dh) or (R, dh); positions
    broadcastable to the row dims: positions of rank ``x.ndim - 2`` (one
    per sequence slot) get a trailing axis over the heads, then are
    broadcast to ``x.shape[:-1]``; they must lie on ``x``'s device. Where
    the heads of a slot share its position, the kernel reads one position
    per slot: the positions are not copied across the heads."""
    run = rope_cuda if on_cuda(x) else rope_plain
    if x.ndim == 2:
        return run(x, positions, theta=theta, layout=layout)
    shape = x.shape
    pos = positions[..., None] if positions.ndim == x.ndim - 2 \
        else positions
    pos = pos.broadcast_to(shape[:-1])
    heads = 1
    if x.ndim > 2 and shape[-2] > 1 and pos.stride(-1) == 0:
        heads, pos = shape[-2], pos[..., 0]
    out = run(x.reshape(-1, shape[-1]), pos.reshape(-1), theta=theta,
              layout=layout, heads=heads)
    return out.reshape(shape)
