"""The VWR2A shuffle unit (paper §3.3.1) as plain PyTorch functions.

The hardware takes VWRs A and B (128 words each), applies a hardcoded
permutation to their concatenation, and writes one VWR's worth (or selects
the upper/lower half of a 2N result) into VWR C. Four operations:

  * words interleaving   [a0,b0,a1,b1,...]                   (2N -> half)
  * even / odd pruning   keep odd / even indices of A and B  (N out)
  * bit-reversal         concat permuted by bit-reversed index (2N -> half)
  * circular shift       concat rotated up by `amount` words (2N -> half)

All functions act on the LAST axis and are batched over the leading axes.
They are the semantic oracles of `kernels/shuffle` (the CUDA kernel is
held to them bitwise) and copy bits only, so every dtype works. The shift
amount is a parameter (default 32, the paper's hardcoded value); a
negative amount rotates down, as `torch.roll` does.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["HALF_LOWER", "HALF_UPPER", "interleave", "prune",
           "bit_reverse_indices", "bit_reverse", "circular_shift",
           "deinterleave"]

HALF_LOWER = "lower"
HALF_UPPER = "upper"


def _take_half(x2n: torch.Tensor, half: str) -> torch.Tensor:
    n = x2n.shape[-1] // 2
    if half == HALF_LOWER:
        return x2n[..., :n]
    if half == HALF_UPPER:
        return x2n[..., n:]
    if half == "both":
        return x2n
    raise ValueError(half)


def interleave(a: torch.Tensor, b: torch.Tensor,
               half: str = "both") -> torch.Tensor:
    """[a0,b0,a1,b1,...] — the paper's 'words interleaving'."""
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    out = torch.stack([a, b], dim=-1).reshape(*a.shape[:-1], -1)
    return _take_half(out, half)


def prune(a: torch.Tensor, b: torch.Tensor, *,
          drop: str = "even") -> torch.Tensor:
    """Drop even- or odd-indexed words of A and B; concat the survivors.

    drop='even' keeps odd indices (a1,a3,...,b1,b3,...); output is N words.
    """
    start = 1 if drop == "even" else 0
    return torch.cat([a[..., start::2], b[..., start::2]], dim=-1)


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = int(np.log2(n))
    if 1 << bits != n:
        raise ValueError(f"{n} not a power of two")
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def bit_reverse(a: torch.Tensor, b: torch.Tensor,
                half: str = "both") -> torch.Tensor:
    """Bit-reversal permutation of concat(A, B)."""
    x = torch.cat([a, b], dim=-1)
    rev = torch.as_tensor(bit_reverse_indices(x.shape[-1]), device=x.device)
    return _take_half(x[..., rev], half)


def circular_shift(a: torch.Tensor, b: torch.Tensor, amount: int = 32,
                   half: str = "both") -> torch.Tensor:
    """Rotate concat(A,B) up by `amount` words (paper hardcodes 32: the upper
    32 words move to the lower 32). Generalized to any static amount."""
    x = torch.cat([a, b], dim=-1)
    return _take_half(torch.roll(x, amount, dims=-1), half)


def deinterleave(x: torch.Tensor) -> tuple:
    """Inverse of interleave: (..., 2N) -> even stream, odd stream."""
    return x[..., 0::2], x[..., 1::2]
