"""Oracle for the flash-attention kernel: the O(S^2) reference from
`models/attention.py`."""
from __future__ import annotations

from repro_torch.models.attention import reference_attention  # noqa: F401


def flash_ref(q, k, v, *, causal=True, window=None):
    """q: (B,Sq,H,dh); k,v: (B,Skv,KV,dh)."""
    return reference_attention(q, k, v, causal=causal, window=window)
