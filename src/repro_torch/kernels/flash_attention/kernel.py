"""The flash-attention kernel (`csrc/flash_attention.cu`) and its plain
version.

`flash_attention_cuda` launches the hand-written online-softmax kernel for
Hopper on CUDA tensors; `flash_attention_plain` is
`models.attention.reference_attention`, the CPU path and what the kernel
is held to on the card. Both take q (B, Sq, H, dh) and k, v (B, Skv, KV,
dh) in float32 or bfloat16 (the plain version also float16, as the
reference does; the kernel not yet) with H % KV == 0 (query head h reads kv head
h // (H / KV)), a causal mask aligned top-left (query i sees key j <= i,
both counted from 0, also when Sq != Skv) and an optional sliding window
(i - j < window); they compute in float32 and return q's dtype. The
kernel reads q, k and v in that layout through their strides (the head
dimension must be contiguous, else it is copied) and takes dh <= 256,
on the tensor cores (wgmma) in both dtypes: bfloat16 products directly,
float32 as 3xTF32 (each operand split into two TF32 halves, three TF32
products a float32 one). `FLASH_TOL` is what the kernel is held to
against the plain version.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _cuda
from repro_torch.models.attention import reference_attention

__all__ = ["FLASH_TOL", "MAX_DH", "flash_attention_plain",
           "flash_attention_cuda"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what the plain version takes: the kernel's dtypes and float16
PLAIN_DTYPES = (*DTYPES, torch.float16)
MAX_DH = 256            # the widest head either kernel keeps in shared memory
# What the kernel is held to against `flash_attention_plain`, per dtype:
# |kernel - plain| <= atol + rtol |plain| per element, (atol, rtol). Both
# sum in float32 in another order. The float32 kernel's products are
# 3xTF32 (a_hi b_hi + a_hi b_lo + a_lo b_hi, dropping a_lo b_lo at ~2^-22
# of a b), and a wgmma step rounds its sum toward zero, so the kernel keeps
# its accumulator chains short (S's hi product apart from its lo products,
# P V in a fresh accumulator a tile). Measured on an H100 against float64
# (tools/flash_variants.py --accuracy): float32 outputs read at most ~2e-6
# from the plain version at scores up to ~+-5, also at 32,768 keys a row;
# where scores reach +-30, exp amplifies either version's rounding of a
# score, and they read 1.0e-5 apart, the kernel 5.5e-6 and the plain
# version 8.2e-6 from float64. So 3e-5 + 3e-5 |plain|, the JAX package's
# float32 tolerance, holds with 4x to spare; one TF32 product per matrix
# product would read ~1e-3, which it flags (`chip_smoke.py` measures both
# on every run). bfloat16 outputs are those float32 values rounded once
# each, so they differ by at most one bfloat16 step, <= 2^-7 |plain|, plus
# the float32 difference, which 1e-4 covers 50 times over. That leaves no
# room for a second rounding inside: p must reach the P V product with
# more than bfloat16's 8 bits, which is why the kernel splits it into hi +
# lo. In float16 (the plain version against the reference, both float32
# inside) the outputs are float32 values 3e-5 apart rounded once each, so
# at most one float16 step apart, <= 2^-10 |plain|, plus the float32
# difference: (1e-4, 2^-10).
FLASH_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (1e-4, 2.0 ** -7),
             "float16": (1e-4, 2.0 ** -10)}

_p, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_cuda.declare("flash_attention",
              Path(__file__).resolve().parent / "csrc" /
              "flash_attention.cu", ("attention",), {
    "flash_attention_launch": ([
        _p, _p, _p, _p,                        # q, k, v, out
        _i, _i, _i, _i, _i, _i,                # B, H, KV, Sq, Skv, dh
        _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll, _ll,   # strides
        _f, _i, _i, _ll,                       # scale, causal, window
        _i, _p], _i),                          # dtype, stream
    "flash_attention_smem_bytes": ([_i, _i], ctypes.c_size_t),
})


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Sq, H, dh) and k, v (B, Skv, KV, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, dh = q.shape
    if k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dimension")
    KV = k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")
    if q.dtype not in PLAIN_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"attention takes float32, bfloat16 or float16 q, "
                         f"k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (`reference_attention`), on
    any device."""
    _check(q, k, v)
    return reference_attention(q, k, v, causal=causal, window=window)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window=None) -> torch.Tensor:
    """Launch the flash-attention kernel on CUDA q, k, v; returns a new
    contiguous (B, Sq, H, dh) tensor of q's dtype."""
    # float16 on the card waits for its kernel (ROADMAP, next slices)
    _cuda.check_cuda_input(q, tuple(DTYPES))
    _check(q, k, v)
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if dh > MAX_DH:
        raise ValueError(f"dh={dh} > {MAX_DH}: the kernel keeps q, k and v "
                         f"tiles of the whole head in shared memory")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    if Skv == 0:
        raise ValueError("attention over zero keys")
    lib = _cuda.library("flash_attention")
    _cuda.check_smem("flash_attention", lib.flash_attention_smem_bytes(
        dh, DTYPES[q.dtype]), f"dh={dh}")
    _cuda.launch("flash_attention", "attention", q, "flash_attention_launch",
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, KV, Sq, Skv, dh, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], 1.0 / math.sqrt(dh), int(causal),
                 int(window is not None),
                 0 if window is None else int(window), DTYPES[q.dtype])
    return out

