"""Public API of the flash-attention kernel.

Dispatches on the device of its input: a CUDA tensor launches the kernel
(`kernel.flash_attention_cuda`), a CPU tensor runs its plain version. The
entry takes no learned parameters, so nothing is carried across from the
JAX package but the semantics. ``q_chunk`` and ``kv_chunk`` are the TPU
kernel's tile sizes: the CUDA kernel tiles on its own, but the entry keeps
the JAX wrapper's check on them, so both packages refuse the same shapes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_cuda, flash_attention_plain)

__all__ = ["flash_attention", "check_chunks"]


def check_chunks(Sq: int, Skv: int, q_chunk: int, kv_chunk: int) -> None:
    """Raise `ValueError` where the JAX wrapper refuses the chunking:
    ``min(chunk, S)`` must be positive and divide ``S``."""
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    if qc < 1 or kc < 1 or Sq % qc or Skv % kc:
        raise ValueError(f"Sq={Sq} with q_chunk {q_chunk} and Skv={Skv} with "
                         f"kv_chunk {kv_chunk}: min(chunk, S) must be "
                         f"positive and divide S")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, q_chunk: int = 256,
                    kv_chunk: int = 256) -> torch.Tensor:
    """Flash attention with GQA and sliding-window support.
    q: (B,Sq,H,dh); k,v: (B,Skv,KV,dh) -> (B,Sq,H,dh) in q's dtype."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"need q (B, Sq, H, dh) and k, v (B, Skv, KV, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    check_chunks(q.shape[1], k.shape[1], q_chunk, kv_chunk)
    run = flash_attention_cuda if on_cuda(q) else flash_attention_plain
    return run(q, k, v, causal=causal, window=window)
