"""Plain oracle for the RoPE kernel, from a float64 inverse-frequency
table (the kernel and its plain version build theirs in float32).

Two layouts:
  * 'interleaved' (GPT-J): pairs are adjacent lanes (x0,x1), (x2,x3)... —
    the layout the VWR2A shuffle unit manipulates directly
    (even/odd prune -> rotate -> interleave).
  * 'neox' (rotate-half): pairs are (x_i, x_{i+d/2}).
"""
from __future__ import annotations

import numpy as np
import torch


def _angles(positions: torch.Tensor, dh: int, theta: float) -> tuple:
    inv = 1.0 / (theta ** (np.arange(0, dh, 2, dtype=np.float64) / dh))
    ang = positions.to(torch.float32)[..., None] * torch.as_tensor(
        inv, dtype=torch.float32, device=positions.device)
    return torch.cos(ang), torch.sin(ang)          # (..., dh/2)


def rope_ref(x: torch.Tensor, positions: torch.Tensor, *,
             theta: float = 10000.0,
             layout: str = "interleaved") -> torch.Tensor:
    """x: (R, dh); positions: (R,)."""
    dh = x.shape[-1]
    cos, sin = _angles(positions, dh, theta)
    xf = x.float()
    if layout == "interleaved":
        x1 = xf[..., 0::2]
        x2 = xf[..., 1::2]
        o1 = x1 * cos - x2 * sin
        o2 = x1 * sin + x2 * cos
        out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    else:  # neox rotate-half
        x1, x2 = torch.chunk(xf, 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
