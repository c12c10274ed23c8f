"""Plain oracle for the shuffle-unit kernel: delegates to `core.shuffle`
(the semantic source of truth for the paper's four permutations)."""
from __future__ import annotations

from repro_torch.core.shuffle import (bit_reverse, circular_shift,
                                     interleave, prune)


def shuffle_ref(a, b, op: str, *, half: str = "both", amount: int = 32):
    if op == "interleave":
        return interleave(a, b, half)
    if op == "prune_even":
        return prune(a, b, drop="even")
    if op == "prune_odd":
        return prune(a, b, drop="odd")
    if op == "bit_reverse":
        return bit_reverse(a, b, half)
    if op == "circular_shift":
        return circular_shift(a, b, amount, half)
    raise ValueError(op)
