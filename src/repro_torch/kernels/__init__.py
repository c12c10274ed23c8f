"""Hand-written Hopper kernels of the port, each beside its plain version.

  pipeline/        — the stage-graph layer and its fused graph kernels
  fir/, fft/       — the standalone FIR and FFT
  shuffle/         — the VWR2A shuffle unit's permutations
  rope/            — rotary position embedding
  flash_attention/ — online-softmax attention with GQA and sliding windows

`_cuda` builds, loads, launches and counts the CUDA kernels; each kernel
module declares its own source and C interface there. Each entry runs its
kernel on a CUDA tensor and the kernel's plain version on a CPU tensor
(`on_cuda`).
"""


def on_cuda(x) -> bool:
    """True for a tensor on a CUDA device (the entry launches its kernel,
    or raises), False for one on the CPU (the entry runs the plain
    version); raise `ValueError` for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type != "cpu":
        raise ValueError(f"tensor on unsupported device {x.device}")
    return False

