"""Int8 error-feedback gradient compression (the port's counterpart of
the JAX package's `train/compress.py`).

A gradient is quantized to int8 with one float32 scale per block of its
flattened values; error feedback adds the quantization residual back
before the next quantization, which keeps the noise unbiased over time.
`EFCompressor` carries the residual state in a train loop. The
reference's `psum_compressed`, the collective that all-reduces the
quantized blocks over a mesh axis, waits for the port's sharding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import tree_from_items, tree_items, tree_map

__all__ = ["quantize_block_int8", "dequantize_block_int8", "EFCompressor"]


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
