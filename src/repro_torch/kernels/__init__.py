"""Hand-written Hopper kernels of the port, each beside its plain version.

  pipeline/        — the stage-graph layer and its fused graph kernels
  fir/, fft/       — the standalone FIR and FFT
  shuffle/         — the VWR2A shuffle unit's permutations
  rope/            — rotary position embedding
  flash_attention/ — online-softmax attention with GQA and sliding windows

`_cuda` builds, loads, launches and counts the CUDA kernels; each kernel
module declares its own source and C interface there. Each entry runs its
kernel on a CUDA tensor and the kernel's plain version on a CPU tensor
(`on_cuda`). `staged_signal` and `cast_output` are the dtype rules every
entry shares with the reference: float64 staged as float32 and int64 as
int32, and a float stored into an integer dtype as ``astype`` stores it.
"""
import torch


def on_cuda(x) -> bool:
    """True for a tensor on a CUDA device (the entry launches its kernel,
    or raises), False for one on the CPU (the entry runs the plain
    version); raise `ValueError` for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"tensor on unsupported device {x.device}")
    return False



# 64-bit dtypes narrow as the reference's ``jnp.asarray`` narrows them
# with x64 off (int64 keeps its low 32 bits, as numpy's astype does)
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def staged_signal(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the entries stage it: float64 narrowed to float32 and
    int64 to int32 (the reference's ``jnp.asarray`` with x64 off), any
    other dtype kept."""
    return x.to(_NARROW[x.dtype]) if x.dtype in _NARROW else x


def cast_output(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` in ``dtype`` as the reference's ``astype`` stores it: a float
    into an integer dtype truncates toward zero, saturates at the dtype's
    range and takes NaN to 0 (``.to`` would wrap); any other cast is
    ``.to``."""
    if v.is_floating_point() and not dtype.is_floating_point and \
            dtype != torch.bool:
        info = torch.iinfo(dtype)
        return v.double().nan_to_num(0.0).clamp(info.min, info.max) \
            .trunc().to(dtype)
    return v.to(dtype)
