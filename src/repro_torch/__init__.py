"""VWR2A reproduction, PyTorch/CUDA port: the raw-signal biosignal stream
and the streaming ASR front-end.

A package of its own beside the JAX reference `repro`, laid out like it so
each counterpart sits at the same path:

  configs/vwr2a_biosignal — the MBioTracker configuration (own copy)
  core/                   — FIR, packed rFFT and the biosignal application
  kernels/pipeline/       — the stage-graph layer with the biosignal and
                            ASR graphs, their fused kernels hand-written
                            in CUDA C++ for Hopper (`csrc/`), the CUDA
                            build and binding (`cuda`), staged baselines
  kernels/fir/, fft/      — the standalone FIR and FFT kernels
  serve/                  — the host-driven and the resident stream

It imports torch and numpy, never jax and nothing of `repro`. Entry points
take an explicit ``device=`` (default ``"cuda"``); the graph entries
dispatch on the device of the tensor they are given: a CUDA tensor launches
the kernel, a CPU tensor runs the plain PyTorch version.
"""
from repro_torch.device import resolve_device  # noqa: F401
