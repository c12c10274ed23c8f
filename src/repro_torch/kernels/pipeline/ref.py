"""Staged references for the fused biosignal graph.

Two baselines:

* ``staged_kernel_fns`` — kernel-at-a-time offload: the standalone FIR
  kernel (`kernels/fir`), delineation and interval time features in plain
  PyTorch, the standalone FFT kernel under the packed rFFT
  (`kernels/fft`), then band powers and the SVM in plain PyTorch, each
  stage's output round-tripping device memory;
* ``staged_stage_fns`` — the application as its three plain stages (FIR,
  features, SVM).

On a CUDA tensor the two standalone kernels launch; on a CPU tensor their
plain versions run. For numerical tests the oracle is
`core.biosignal.BiosignalApp` itself. The ASR front-end's kernel-at-a-time
sibling is `asr.py:asr_staged`, and its numpy oracle `asr.py:asr_reference`.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.biosignal import (band_power_features, delineate,
                                        extract_features,
                                        interval_time_features, svm_predict)
from repro_torch.core.fir import fir_direct

__all__ = ["staged_stage_fns", "staged_kernel_fns", "pipeline_staged"]


def staged_stage_fns(taps, w, b, *, fft_size: int = 512):
    """The pipeline as its three plain stages (FIR, features, SVM); each
    call materialises its output."""
    taps = torch.as_tensor(taps, dtype=torch.float32)

    def fir_fn(s):
        return fir_direct(s, taps.to(s.device))

    feat_fn = functools.partial(extract_features, fft_size=fft_size)

    def svm_fn(f):
        return svm_predict(f, torch.as_tensor(w, device=f.device),
                           torch.as_tensor(b, device=f.device))

    return fir_fn, feat_fn, svm_fn


def staged_kernel_fns(taps, w, b, *, fft_size: int = 512):
    """Kernel-at-a-time execution: one launch per kernel stage, every
    inter-stage tensor round-tripping device memory. Returns one callable
    running the chain on (R, S) frames."""
    from repro_torch.kernels.fft.ops import rfft
    from repro_torch.kernels.fir.ops import fir

    def run(signal: torch.Tensor) -> dict:
        dev = signal.device
        t, wt, bt = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (taps, w, b))
        filtered = fir(signal, t)                  # FIR kernel
        is_max, is_min = delineate(filtered)
        f_time = interval_time_features(is_max, is_min)
        seg = filtered[..., :fft_size]
        Xr, Xi = rfft(seg - seg.mean(dim=-1, keepdim=True))   # FFT kernel
        feats = torch.stack(
            list(f_time) + band_power_features(Xr * Xr + Xi * Xi, fft_size),
            dim=-1)
        margin, cls = svm_predict(feats, wt, bt)
        return {"filtered": filtered, "features": feats, "margin": margin,
                "class": cls}

    return run


def pipeline_staged(signal, taps, w, b, *, fft_size: int = 512) -> dict:
    """Dict-identical kernel-at-a-time staged execution."""
    return staged_kernel_fns(taps, w, b, fft_size=fft_size)(signal)
