"""The RoPE kernel's partition (`kernels/rope/csrc/rope.cu`), walked through
in numpy on the CPU: the launch geometry the host computes
(`kernel.rope_geometry`) and the kernel's per-thread walk over its
block's slots, step by step as the source writes it. A fault in the index
arithmetic that the card would show as a wrong row shows here first.

For dh in {2, 18, 24, 32, 64, 120, 128, 256}, heads in {1, 3, 16, 32},
float32 and bfloat16, both layouts and bases offset by 0, 1 element and 8
bytes, every pair of every row must be rotated exactly once, by its own
slot's entry of its own block's table, with every vector access aligned
to its width; and the vector width (`vector_bytes`) must be 16 bytes, 8
bytes or the scalar path exactly where the alignment rules say. No card,
no jax."""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.rope import kernel as K

SOURCE = Path(K.__file__).resolve().parent / "csrc" / "rope.cu"
DHS = (2, 18, 24, 32, 64, 120, 128, 256)
HEADS = (1, 3, 16, 32)


def _source_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([\d *]+);", SOURCE.read_text())
    assert m, name
    return int(eval(m.group(1)))          # e.g. "48 * 1024"


def test_host_constants_are_the_kernels():
    assert K.ROPE_THREADS == _source_constant("kThreads")
    assert K.ROPE_TABLE_BYTES == _source_constant("kTableBytes")


def _blocks(slots: int, block_slots: int) -> int:
    """The grid `launch` of rope.cu gives: blocks of block_slots slots."""
    return -(-slots // block_slots)


def _plane_bytes(block_slots: int, half: int) -> int:
    """The shared memory `launch` of rope.cu gives a block: two float32
    planes of block_slots * dh/2 angles, each rounded up to 4 floats."""
    return 2 * 4 * (-(-block_slots * half // 4) * 4)


def _table_walk(h: int, nthreads: int, nslots: int) -> np.ndarray:
    """How often phase 1 writes each (slot, pair) entry of a block's
    table: thread t takes pair t % hh of slots t // hh, + nthreads // hh,
    ... (hh = min(h, nthreads)), pairs i0, i0 + hh, ..."""
    hits = np.zeros((nslots, h), np.int64)
    hh = min(h, nthreads)
    sstep = nthreads // hh
    for t in range(nthreads):
        s0, i0 = divmod(t, hh)
        if s0 >= sstep:
            continue
        for s in range(s0, nslots, sstep):
            hits[s, i0:h:hh] += 1
    return hits


def _unit_walk(units: int, heads: int, nthreads: int, nrows: int):
    """Phase 2's (row k, unit u, slot s) for every step of every thread,
    with the kernel's carries (one division at the start, then constant
    steps of nthreads units), vectorised over the threads; returns three
    flat arrays."""
    t = np.arange(nthreads)
    k, u = t // units, t % units
    s, r = k // heads, k % heads
    dk, du = divmod(nthreads, units)
    ds, dr = divmod(dk, heads)
    ks, us, ss = [], [], []
    while (k < nrows).any():
        live = k < nrows
        ks.append(k[live]), us.append(u[live]), ss.append(s[live])
        u, k, s, r = u + du, k + dk, s + ds, r + dr
        wrap = r >= heads
        r, s = np.where(wrap, r - heads, r), np.where(wrap, s + 1, s)
        carry = u >= units
        u, k = np.where(carry, u - units, u), np.where(carry, k + 1, k)
        r = np.where(carry, r + 1, r)
        wrap = carry & (r == heads)
        r, s = np.where(wrap, 0, r), np.where(wrap, s + 1, s)
    return np.concatenate(ks), np.concatenate(us), np.concatenate(ss)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("dh", DHS)
def test_every_pair_is_rotated_once_by_its_own_slots_table(dh, heads):
    half = dh // 2
    for elem, layout, offset in itertools.product(
            (4, 2), K.LAYOUTS, (0, 1, None)):
        misalign = 8 if offset is None else offset * elem
        slots = 9                       # a partial last block at most sizes
        R = slots * heads
        g = K.rope_geometry(R, dh, heads, elem, layout, misalign)
        neox = layout == "neox"
        assert g.threads <= K.ROPE_THREADS and \
            _plane_bytes(g.block_slots, half) <= K.ROPE_TABLE_BYTES
        assert g.units * g.group == half
        if g.units <= K.ROPE_THREADS:   # a thread keeps its column
            assert g.threads % g.units == 0
        stride = g.group if neox else 2 * g.group
        count = np.zeros((R, half), np.int64)
        for blk in range(_blocks(slots, g.block_slots)):
            slot0 = blk * g.block_slots
            nslots = min(g.block_slots, slots - slot0)
            assert nslots >= 1
            table = _table_walk(half, g.threads, nslots)
            assert (table == 1).all()
            k, u, s = _unit_walk(g.units, heads, g.threads, nslots * heads)
            # the table entry a unit reads is its own slot's
            assert (s == k // heads).all()
            tix = s * half + u * g.group
            assert (tix + g.group <= nslots * half).all()
            row = slot0 * heads + k
            first = u * stride                      # element in the row
            if g.vec_bytes:
                base = misalign + (row * dh + first) * elem
                assert (base % g.vec_bytes == 0).all()
                if neox:
                    assert ((base + half * elem) % g.vec_bytes == 0).all()
                if g.group % 4 == 0 or g.group == 2:   # plane vector reads
                    assert (tix % min(g.group, 4) == 0).all()
            for j in range(g.group):
                np.add.at(count, (row, u * g.group + j), 1)
        assert (count == 1).all(), (dh, heads, elem, layout, offset)


# (dh, element bytes, layout, misalignment) -> vector bytes, as design
# items 2-3 of the kernel say: the widest of 16 and 8 that the base's
# misalignment allows and that tiles the row (interleaved) or each half
# row (neox); else the scalar path
@pytest.mark.parametrize("dh,elem,layout,misalign,want", [
    (64, 4, "interleaved", 0, 16),     # R1 float32
    (64, 4, "neox", 0, 16),            # 128-byte halves
    (64, 2, "interleaved", 0, 16),     # R1 bfloat16
    (64, 2, "neox", 0, 16),            # 64-byte halves
    (120, 2, "neox", 0, 8),            # R2: 120-byte halves
    (120, 2, "interleaved", 0, 16),    # 240-byte rows
    (120, 4, "neox", 0, 16),           # 240-byte halves
    (18, 4, "interleaved", 0, 8),      # 72-byte rows
    (18, 4, "neox", 0, 0),             # 36-byte halves
    (18, 2, "interleaved", 0, 0),      # 36-byte rows
    (2, 4, "interleaved", 0, 8),       # one pair a row
    (2, 2, "interleaved", 0, 0),       # 4-byte rows
    (64, 4, "interleaved", 4, 0),      # base one float32 in
    (64, 2, "neox", 2, 0),             # base one bfloat16 in
    (64, 4, "neox", 8, 8),             # base 8 bytes in
    (120, 2, "neox", 8, 8),
    (24, 2, "interleaved", 8, 8),
])
def test_vector_width_follows_the_alignment_rules(dh, elem, layout,
                                                  misalign, want):
    assert K.vector_bytes(dh, elem, layout, misalign) == want


def test_vector_width_rule_over_every_shape():
    for dh, elem, layout, misalign in itertools.product(
            range(2, 260, 2), (4, 2), K.LAYOUTS, range(0, 16, 2)):
        if misalign % elem:
            continue
        tiled = (dh // 2 if layout == "neox" else dh) * elem
        vb = K.vector_bytes(dh, elem, layout, misalign)
        fits = [w for w in (16, 8) if misalign % w == 0 and tiled % w == 0]
        assert vb == (fits[0] if fits else 0)
        if vb and layout == "interleaved":
            assert (vb // elem) % 2 == 0         # whole pairs a vector


def test_geometry_fills_a_pass_and_refuses_tables_that_do_not_fit():
    # R1 and R2 at the default: 16 KB of whole slots a block
    for R, dh, heads, elem, layout, slots in (
            (131072, 64, 16, 4, "neox", 4), (131072, 64, 16, 2,
                                              "interleaved", 8),
            (262144, 120, 32, 2, "neox", 2)):
        g = K.rope_geometry(R, dh, heads, elem, layout, 0)
        assert g.block_slots * heads * dh * elem <= K.ROPE_BLOCK_BYTES
        assert (g.block_slots, _blocks(R // heads, g.block_slots)) == \
            (slots, 8192 // slots)
    # one head a slot: 16 KB of rows a block, a full pass of threads
    for dh, elem, layout in ((64, 4, "interleaved"), (2, 2, "neox"),
                             (256, 2, "neox"), (2048, 4, "interleaved")):
        g = K.rope_geometry(1 << 16, dh, 1, elem, layout, 0)
        assert g.block_slots == K.ROPE_BLOCK_BYTES // (dh * elem)
        assert g.threads == K.ROPE_THREADS
    g = K.rope_geometry(3, 12288, 1, 4, "neox", 0)
    assert _plane_bytes(g.block_slots, 12288 // 2) == K.ROPE_TABLE_BYTES
    with pytest.raises(ValueError, match="dh 12290"):
        K.rope_geometry(3, 12290, 1, 4, "neox", 0)
