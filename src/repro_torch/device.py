"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a `torch.device`; raises when it names CUDA and no
    card is present, so a default-device call on a CPU-only host fails
    loudly instead of moving work elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch version")
    return dev


def cuda_devices() -> list[torch.device]:
    """Every CUDA device of the host; raises (via `resolve_device`) when
    there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [resolve_device(f"cuda:{i}") for i in range(n)] or \
        [resolve_device("cuda")]
