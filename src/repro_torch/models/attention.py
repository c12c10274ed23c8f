"""Attention for the port's models. So far only the O(S^2)-memory oracle
(`reference_attention`) and the mask fill (`NEG_INF`) that the
flash-attention kernel shares; GQA, causal and sliding-window masks as in
the JAX package's `models/attention.py`."""
from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "reference_attention"]

NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window=None) -> torch.Tensor:
    """O(S^2)-memory oracle for tests. q: (B, Sq, H, dh); k, v: (B, Skv,
    KV, dh) with H % KV == 0; query head h reads kv head h // (H / KV).
    Positions count from 0 in q and in k (the causal mask is aligned
    top-left); masked scores are filled with `NEG_INF`; computed in
    float32, returned in q's dtype."""
    B, Sq, H, dh = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float())
    s = s / math.sqrt(dh)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, dh).to(q.dtype)
