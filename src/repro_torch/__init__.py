"""VWR2A reproduction, PyTorch/CUDA port: the raw-signal biosignal stream,
the streaming ASR front-end, the standalone shuffle, RoPE and
flash-attention kernels, column replication and LM serving for the dense
transformer family.

A package of its own beside the JAX reference `repro`, laid out like it so
each counterpart sits at the same path:

  configs/                — the MBioTracker configuration and the ten
                            LM architectures (own copies)
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
  models/                 — the dense LM stack (layers, attention with
                            the O(S^2) oracle, transformer, api)
  serve/                  — the host-driven and the resident stream, the
                            column runner and the LM `Engine`
  launch/serve            — the LM serving CLI

It imports torch and numpy, never jax and nothing of `repro`. Entry points
take an explicit ``device=`` (default ``"cuda"``); the kernel entries
dispatch on the device of the tensor they are given: a CUDA tensor launches
the kernel, a CPU tensor runs the plain PyTorch version.
"""
from repro_torch.device import resolve_device  # noqa: F401
