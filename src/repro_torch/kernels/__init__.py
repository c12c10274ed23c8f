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


def not_in_slice(autotune: bool = False, n_columns: int = 1,
                 column_weights=None) -> None:
    """Raise `NotImplementedError` for the options whose port comes in a
    later slice."""
    if autotune:
        raise NotImplementedError(
            "autotune=True comes with the port of core/autotune.py (timed "
            "with CUDA events), a later slice")
    if n_columns != 1 or column_weights is not None:
        raise NotImplementedError(
            "n_columns > 1 / column_weights come with the port of the "
            "column deal (kernels/pipeline/shard.py), a later slice")
