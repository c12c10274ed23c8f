"""The rotary-embedding kernel (`csrc/rope.cu`) and its plain version.

`rope_cuda` launches the hand-written kernel for Hopper on CUDA tensors;
`rope_plain` is the JAX kernel's float32 formula in PyTorch operations,
the CPU path and what the kernel is held to on the card. Both rotate the
rows of an (R, dh) float32 or bfloat16 array (the plain version also
float16, as the reference does; the kernel not yet), compute in float32
and return the input's dtype. Row r takes position ``positions[r // heads]``:
``heads`` consecutive rows (the heads of one sequence slot) share one
position, so the entry needs no broadcast copy of the positions. Both
build the inverse frequencies the same way, ``exp((i * f32(2/dh)) *
f32(-ln theta))`` in float32 (`rope_constants`), so a comparison on the
card measures the kernel and not two tables.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _cuda

__all__ = ["LAYOUTS", "rope_constants", "inv_freq", "rope_plain",
           "rope_geometry", "rope_launch_args", "rope_cuda"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what the plain version takes: the kernel's dtypes and float16
PLAIN_DTYPES = (*DTYPES, torch.float16)
# positions the kernel reads and converts to float32 itself (round to
# nearest, as ``.to(torch.float32)`` does); others are converted first
POS_DTYPES = {torch.float32: 0, torch.int32: 1, torch.int64: 2}
# the layouts, as the kernel numbers them; each is an entry of the count
LAYOUTS = ("interleaved", "neox")

# the launch geometry (`rope_geometry`): most threads a block (kThreads of
# csrc/rope.cu), the bytes of x a block takes in whole slots (from 1, 2,
# 4 and 8 slots a block measured by tools/rope_variants.py: 8 of R1's
# 2 KB bfloat16 slots, 2 of R2's 7.5 KB ones), and the shared memory the
# (cos, sin) planes may take (kTableBytes)
ROPE_THREADS = 256
ROPE_BLOCK_BYTES = 16 * 1024
ROPE_TABLE_BYTES = 48 * 1024

_p, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_cuda.declare("rope", Path(__file__).resolve().parent / "csrc" / "rope.cu",
              LAYOUTS, {
    # x, positions, out, R, dh, heads, f32(2/dh), f32(-ln theta), neox,
    # dtype, positions' dtype, vector bytes, misalignment, slots a block,
    # threads a block, stream
    "rope_launch": ([_p, _p, _p, _ll, _i, _i, _f, _f, _i, _i, _i, _i, _i,
                     _i, _i, _p], _i),
})


@dataclasses.dataclass(frozen=True)
class RopeGeometry:
    vec_bytes: int      # 16 or 8: one vector a unit (per half in neox); 0:
                        # scalar accesses
    group: int          # pairs a unit
    units: int          # units a row
    threads: int        # threads a block
    block_slots: int    # slots a block


def vector_bytes(dh: int, elem: int, layout: str, misalign: int) -> int:
    """The widest vector (16 or 8 bytes) the kernel may use, else 0 (one
    pair a unit, scalar accesses): it must divide the misalignment of the
    base addresses (``(x | out) % 16``) and tile the row (interleaved:
    whole pairs) or each half row (neox: a unit is one vector from each
    half)."""
    tiled = (dh // 2 if layout == "neox" else dh) * elem
    for vb in (16, 8):
        if misalign % vb == 0 and tiled % vb == 0:
            return vb
    return 0


def rope_geometry(R: int, dh: int, heads: int, elem: int, layout: str,
                  misalign: int) -> RopeGeometry:
    """How `rope_launch` cuts an (R, dh) array of ``elem``-byte elements
    whose slots are ``heads`` rows: ``units`` units of ``group`` pairs a
    row; one thread a unit of as many rows as fit in `ROPE_THREADS`
    threads (a pass), or `ROPE_THREADS` threads where a row has more
    units; as many whole slots a block as `ROPE_BLOCK_BYTES` of x hold (at
    least one; a pass's worth or more at every layout, since a thread's
    unit is at most 16 bytes of each half row), fewer where the planes'
    shared memory or the slots end first. Raises `ValueError` where one
    slot's table does not fit."""
    half = dh // 2
    if 8 * (-(-half // 4) * 4) > ROPE_TABLE_BYTES:
        raise ValueError(f"rope's kernel keeps a slot's dh/2 angles in "
                         f"{ROPE_TABLE_BYTES} B of shared memory: dh "
                         f"{dh} > {ROPE_TABLE_BYTES // 4}")
    vb = vector_bytes(dh, elem, layout, misalign)
    neox = layout == "neox"
    ne = vb // elem if vb else (1 if neox else 2)
    group = ne if neox else ne // 2
    units = half // group
    slots = R // heads
    pass_rows = max(1, ROPE_THREADS // units)
    spb = max(1, min(ROPE_BLOCK_BYTES // (heads * dh * elem), slots,
                     ROPE_TABLE_BYTES // 8 // half))
    threads = units * min(pass_rows, spb * heads) \
        if units <= ROPE_THREADS else ROPE_THREADS
    return RopeGeometry(vb, group, units, threads, spb)


def rope_constants(dh: int, theta: float) -> tuple:
    """(float32(2 / dh), float32(-ln theta)): the two constants of the
    inverse frequencies, rounded to float32 as the JAX kernel's weakly
    typed scalars are."""
    return (float(np.float32(2.0 / dh)),
            float(np.float32(-np.log(theta))))


def inv_freq(dh: int, theta: float, device) -> torch.Tensor:
    """The (dh/2,) float32 inverse frequencies in the kernel's order."""
    c1, c2 = (torch.tensor(c, dtype=torch.float32, device=device)
              for c in rope_constants(dh, theta))
    idx = torch.arange(dh // 2, dtype=torch.float32, device=device)
    return torch.exp(idx * c1 * c2)


def _check(x: torch.Tensor, positions: torch.Tensor, layout: str,
           heads: int) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if x.ndim != 2 or x.shape[1] < 2 or x.shape[1] % 2:
        raise ValueError(f"x must be (R, dh) with dh even, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in PLAIN_DTYPES:
        raise ValueError(f"rope takes float32, bfloat16 or float16 x, got "
                         f"{x.dtype}")
    if heads < 1 or x.shape[0] % heads:
        raise ValueError(f"heads {heads} must be positive and divide the "
                         f"{x.shape[0]} rows")
    if tuple(positions.shape) != (x.shape[0] // heads,):
        raise ValueError(f"positions must be ({x.shape[0] // heads},), got "
                         f"{tuple(positions.shape)}")
    if positions.device != x.device:
        raise ValueError(f"x on {x.device}, positions on "
                         f"{positions.device}")


def rope_plain(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0, layout: str = "interleaved",
               heads: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    _check(x, positions, layout, heads)
    dh = x.shape[1]
    pos = positions.to(torch.float32).repeat_interleave(heads)
    ang = pos[:, None] * inv_freq(dh, theta, x.device)[None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    xf = x.float()
    if layout == "interleaved":
        x1, x2 = xf[:, 0::2], xf[:, 1::2]
        out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                          dim=-1).reshape(x.shape)
    else:
        x1, x2 = xf[:, : dh // 2], xf[:, dh // 2:]
        out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def rope_launch_args(x: torch.Tensor, pos: torch.Tensor, out: torch.Tensor,
                     *, theta: float, layout: str, heads: int) -> tuple:
    """The arguments of ``rope_launch`` but the stream, for contiguous
    CUDA ``x`` (R, dh), ``out`` like it and ``pos`` (R / heads,) of one of
    `POS_DTYPES`."""
    R, dh = x.shape
    misalign = (x.data_ptr() | out.data_ptr()) % 16
    geo = rope_geometry(R, dh, heads, x.element_size(), layout, misalign)
    c1, c2 = rope_constants(dh, theta)
    return (x.data_ptr(), pos.data_ptr(), out.data_ptr(), R, dh, heads, c1,
            c2, LAYOUTS.index(layout), DTYPES[x.dtype],
            POS_DTYPES[pos.dtype], geo.vec_bytes, misalign, geo.block_slots,
            geo.threads)


def rope_cuda(x: torch.Tensor, positions: torch.Tensor, *,
              theta: float = 10000.0, layout: str = "interleaved",
              heads: int = 1) -> torch.Tensor:
    """Launch the rotary kernel over the rows of a CUDA (R, dh) array; the
    kernel reads float32, int32 or int64 positions and converts them to
    float32, as the JAX wrapper does (other dtypes are converted here)."""
    # float16 on the card waits for its kernel (ROADMAP, next slices)
    _cuda.check_cuda_input(x, tuple(DTYPES))
    _check(x, positions, layout, heads)
    x = x.contiguous()
    if positions.dtype not in POS_DTYPES:
        positions = positions.to(torch.float32)
    pos = positions.contiguous()
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    _cuda.launch("rope", layout, x, "rope_launch",
                 *rope_launch_args(x, pos, out, theta=theta, layout=layout,
                                   heads=heads))
    return out
