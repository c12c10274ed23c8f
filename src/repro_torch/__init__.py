"""VWR2A reproduction, PyTorch/CUDA port: the raw-signal biosignal stream,
the streaming ASR front-end and the standalone shuffle, RoPE and
flash-attention kernels.

A package of its own beside the JAX reference `repro`, laid out like it so
each counterpart sits at the same path:

  configs/vwr2a_biosignal — the MBioTracker configuration (own copy)
  core/                   — FIR, packed rFFT, the biosignal application and
                            the shuffle unit's permutations
  kernels/pipeline/       — the stage-graph layer with the biosignal and
                            ASR graphs, their fused kernels hand-written
                            in CUDA C++ for Hopper (`csrc/`), the CUDA
                            build and binding (`cuda`), staged baselines
  kernels/fir/, fft/      — the standalone FIR and FFT kernels
  kernels/shuffle/, rope/,
  flash_attention/        — the standalone shuffle-unit, RoPE and
                            flash-attention kernels
  models/attention        — the O(S^2) attention oracle
  serve/                  — the host-driven and the resident stream

It imports torch and numpy, never jax and nothing of `repro`. Entry points
take an explicit ``device=`` (default ``"cuda"``); the kernel entries
dispatch on the device of the tensor they are given: a CUDA tensor launches
the kernel, a CPU tensor runs the plain PyTorch version.
"""
from repro_torch.device import resolve_device  # noqa: F401
