"""The shuffle kernel's partition (`kernels/shuffle/csrc/shuffle.cu`),
walked through in numpy on the CPU: the launch geometry the host computes
(`kernel.shuffle_geometry`) and the kernel's walk over its output copies,
step by step as the source writes it, with each output word's source
index from the kernel's per-op formulas. No card, no jax.

For N in {2, 6, 64, 128, 256, 1000, 3000, 7000}, 4- and 2-byte words,
aligned and offset bases, every op, half and shift: every output word is
written exactly once, with the word the plain version puts there, every
16-byte copy is aligned, and a block stages no more than its shared
memory holds."""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.shuffle import bit_reverse_indices
from repro_torch.kernels.shuffle import kernel as K

SOURCE = Path(K.__file__).resolve().parent / "csrc" / "shuffle.cu"


def _source_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([\d *]+);", SOURCE.read_text())
    assert m, name
    return int(eval(m.group(1)))          # e.g. "48 * 1024"


def test_host_constants_are_the_kernels():
    assert K.SHUFFLE_THREADS == _source_constant("kThreads")
    assert K.SHUFFLE_STAGE_BYTES == _source_constant("kStageBytes")


def _source(op: str, i: np.ndarray, off: int, n: int, amount: int,
            log2_2n: int) -> np.ndarray:
    """`source<kOp>` of shuffle.cu, vectorised."""
    p = i + off
    if op == "interleave":
        return (p & 1) * n + (p >> 1)
    if op.startswith("prune"):
        comp = 1 if op == "prune_even" else 0
        half = n >> 1
        return np.where(i < half, 2 * i + comp, n + 2 * (i - half) + comp)
    if op == "bit_reverse":
        return bit_reverse_indices(1 << log2_2n)[p]
    j = p - amount
    return np.where(j < 0, j + 2 * n, j)


@pytest.mark.parametrize("n", [2, 6, 64, 128, 256, 1000, 3000, 7000])
def test_every_output_word_is_written_once_from_its_source(n):
    R = 37 if n <= 256 else 5
    rng = np.random.default_rng(n)
    a = rng.integers(0, 2 ** 31, (R, n))
    b = rng.integers(0, 2 ** 31, (R, n))
    ab = np.concatenate([a, b], axis=1)
    for elem, misalign, op, half in itertools.product(
            (4, 2), (0, 2, 8), K.OPS, K.HALVES):
        if (op == "bit_reverse" and n & (n - 1)) or \
                (op.startswith("prune") and (n % 2 or half != "both")):
            continue
        if misalign % elem:
            continue
        amounts = (0, 32, -5, n, 2 * n + 3) \
            if op == "circular_shift" else (32,)
        for amount in amounts:
            g = K.shuffle_geometry(R, n, op, half, amount, elem, misalign)
            out_n, off = g.out_n, g.off
            assert g.vec == (misalign == 0 and (n * elem) % 16 == 0)
            assert g.threads <= K.SHUFFLE_THREADS
            a_lo, a_n, b_lo, b_n = g.ranges
            assert 0 <= a_lo and a_lo + a_n <= n and 0 <= b_lo and \
                b_lo + b_n <= n
            if g.staged:
                assert g.vec            # only 16-byte copies are staged
                assert elem * g.rows * (a_n + b_n) <= K.SHUFFLE_STAGE_BYTES
            else:
                assert g.ranges == (0, n, 0, n)
            ve = 16 // elem if g.vec else 1
            assert (a_lo % ve, a_n % ve, b_lo % ve, b_n % ve) == (0,) * 4
            if g.staged and half != "both" and op in ("interleave",
                                                      "circular_shift"):
                assert a_n + b_n <= n + 2 * ve    # half the row, to vectors
            units = out_n // ve
            assert units * ve == out_n
            want = K.shuffle_plain(torch.as_tensor(a), torch.as_tensor(b),
                                   op, half=half, amount=amount).numpy()
            got = np.full((R, out_n), -1, np.int64)
            hits = np.zeros((R, out_n), np.int64)
            for blk in range(-(-R // g.rows)):     # shuffle.cu's grid
                r0 = blk * g.rows
                nr = min(g.rows, R - r0)
                # the walk: row k = t // units, copy u = t % units, steps
                # of `threads` copies with one carry
                t = np.arange(g.threads)
                k, u = t // units, t % units
                dk, du = divmod(g.threads, units)
                while (k < nr).any():
                    live = k < nr
                    kk, uu = k[live], u[live]
                    for e in range(ve):
                        i = uu * ve + e
                        j = _source(op, i, off, n, amount % (2 * n),
                                    (2 * n).bit_length() - 1)
                        # the staged run of A or B holds the source word
                        ja, jb = j[j < n], j[j >= n] - n
                        assert ((a_lo <= ja) & (ja < a_lo + a_n)).all()
                        assert ((b_lo <= jb) & (jb < b_lo + b_n)).all()
                        got[r0 + kk, i] = ab[r0 + kk, j]
                        hits[r0 + kk, i] += 1
                    if g.vec:       # the copy's byte address, aligned
                        assert ((((r0 + kk) * out_n + uu * ve) * elem) %
                                16 == 0).all()
                    u, k = u + du, k + dk
                    carry = u >= units
                    u, k = np.where(carry, u - units, u), \
                        np.where(carry, k + 1, k)
            assert (hits == 1).all(), (n, elem, misalign, op, half, amount)
            assert (got == want).all(), (n, op, half, amount)
