"""Int8 error-feedback gradient compression (the port's counterpart of
the JAX package's `train/compress.py`).

A gradient is quantized to int8 with one float32 scale per block of its
flattened values; error feedback adds the quantization residual back
before the next quantization, which keeps the noise unbiased over time.
`EFCompressor` carries the residual state in a train loop;
`psum_compressed` is the collective that all-reduces the quantized
blocks over one axis of a ``DeviceMesh``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import tree_from_items, tree_items, tree_map

__all__ = ["quantize_block_int8", "dequantize_block_int8", "EFCompressor",
           "psum_compressed"]


def quantize_block_int8(x, block: int = 256):
    """x: any shape -> (q int8 (blocks, block), scale float32 (blocks, 1))
    over the flattened values, zero-padded up to whole blocks."""
    flat = x.reshape(-1)
    pad = -flat.shape[0] % block
    fb = F.pad(flat, (0, pad)).reshape(-1, block)
    scale = torch.amax(torch.abs(fb), dim=1, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(fb / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_block_int8(q, scale, shape):
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


class EFCompressor:
    """Error-feedback int8 compressor for a gradient tree."""

    def __init__(self, block: int = 256):
        self.block = block

    def init(self, grads):
        return tree_map(torch.zeros_like, grads)

    def compress(self, grads, residual):
        """-> (a tree of (q, scale) pairs, the new residual tree)."""
        comp, res = [], []
        for (path, g), (_, r) in zip(tree_items(grads),
                                     tree_items(residual)):
            g = g.float() + r.float()
            q, s = quantize_block_int8(g, self.block)
            comp.append((path, (q, s)))
            res.append((path, g - dequantize_block_int8(q, s, g.shape)))
        return tree_from_items(comp), tree_from_items(res)

    def decompress(self, comp, like):
        """The (q, scale) tree ``comp`` as tensors shaped and typed as the
        leaves of ``like``."""
        return tree_map(lambda c, t: dequantize_block_int8(
            c[0], c[1], t.shape).to(t.dtype), comp, like)


def psum_compressed(x, axis_name: str, *, block: int = 256, mesh):
    """The sum of ``x`` over the ranks of ``mesh``'s axis ``axis_name``,
    each rank's contribution int8-quantized first: the reference's steps,
    q * scale of each block all-reduced in float32 (the compressed
    exchange modelled) and cut back to ``x``'s shape. Every rank of the
    axis calls it; each gets the sum."""
    import torch.distributed as dist

    q, s = quantize_block_int8(x, block)
    part = q.float() * s
    dist.all_reduce(part, group=mesh.get_group(axis_name))
    return part.reshape(-1)[:math.prod(x.shape)].reshape(x.shape)
