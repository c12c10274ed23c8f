"""Public API of the shuffle-unit kernel.

Dispatches on the device of its input: a CUDA tensor launches the kernel
(`kernel.shuffle_cuda`), a CPU tensor runs its plain version. The entry
takes no learned parameters, so nothing is carried across from the JAX
package but the semantics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import on_cuda
from repro_torch.kernels.shuffle.kernel import shuffle_cuda, shuffle_plain

__all__ = ["shuffle"]


def shuffle(a: torch.Tensor, b: torch.Tensor, op: str, *,
            half: str = "both", amount: int = 32) -> torch.Tensor:
    """VWR2A shuffle-unit op on (R, N) blocks (N a power of two for
    ``bit_reverse``, even for the prunes): ``op`` one of ``interleave``,
    ``prune_even``, ``prune_odd``, ``bit_reverse``, ``circular_shift``;
    ``half`` one of ``both``, ``lower``, ``upper``; ``amount`` the
    circular shift, any integer."""
    run = shuffle_cuda if on_cuda(a) else shuffle_plain
    return run(a, b, op, half=half, amount=amount)
