"""Quickstart: the VWR2A core library in four sections, on the card.

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

The port's counterpart of `examples/quickstart.py`, at the same sizes:

1. the four shuffle-unit primitives on two 8-element vectors;
2. the packed real FFT (`kernels.fft.ops.rfft`, the FFT kernel) of a
   (4, 512) float32 batch from seed 0 against ``np.fft.rfft``, and the
   11-tap low-pass FIR (`kernels.fir.ops.fir`, the FIR kernel) on it;
3. the cycle-accurate simulator's 512-point real FFT
   (`archsim.programs.fft.run_rfft`) with its cycles and uJ (the paper's
   VWR2A figure: 3666 cycles);
4. one ``model.loss`` of reduced deepseek-moe-16b at batch (2, 64).

It runs on the card unless ``device="cpu"`` is asked for; asked for the
card on a host without one, it raises. The checks: the real FFT within
`kernels.fft.kernel.FFT_TOL` of numpy relative to the largest |bin|, the
FIR output finite, the loss finite. It ends with the example's closing
line, ``quickstart OK``.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch.archsim.energy import vwr2a_energy_uj
from repro_torch.archsim.programs.fft import run_rfft
from repro_torch.configs import get_config, reduced
from repro_torch.core.fir import lowpass_taps
from repro_torch.core.shuffle import (bit_reverse, circular_shift,
                                      interleave, prune)
from repro_torch.device import resolve_device
from repro_torch.kernels.fft.kernel import FFT_TOL
from repro_torch.kernels.fft.ops import rfft
from repro_torch.kernels.fir.ops import fir
from repro_torch.models import build_model, init_model_params

PAPER_CYCLES = 3666                    # the paper's VWR2A 512-point rFFT
LM_ARCH = "deepseek-moe-16b"
LM_BATCH = (2, 64)


def shuffle_section(device) -> dict:
    """The four primitives on a = 0..7 and b = 100..107."""
    dev = resolve_device(device)
    a = torch.arange(8.0, device=dev)
    b = torch.arange(8.0, device=dev) + 100
    return {"interleave": interleave(a, b)[:8],
            "prune even": prune(a, b, drop="even"),
            "bit_reverse": bit_reverse(a, b, half="lower"),
            "circ shift": circular_shift(a, b, amount=4, half="lower")}


def signal_batch(seed: int = 0) -> np.ndarray:
    """The example's (4, 512) float32 normal batch."""
    return np.random.default_rng(seed).normal(size=(4, 512)) \
        .astype(np.float32)


def fft_fir_section(x: np.ndarray, device) -> dict:
    """The packed real FFT of ``x`` against numpy, and the 11-tap FIR."""
    dev = resolve_device(device)
    xt = torch.as_tensor(x, device=dev)
    Xr, Xi = rfft(xt)
    got = Xr.double().cpu().numpy() + 1j * Xi.double().cpu().numpy()
    ref = np.fft.rfft(x)
    y = fir(xt, torch.as_tensor(lowpass_taps(11), device=dev))
    return {"rfft": (Xr, Xi),
            "rfft_rel_err": float(np.abs(got - ref).max()
                                  / np.abs(ref).max()),
            "fir": y, "fir_finite": bool(torch.isfinite(y).all())}


def archsim_section(x: np.ndarray) -> dict:
    """The simulator's 512-point real FFT of ``x[0] * 0.3``."""
    X, counters, cycles = run_rfft(512, x[0] * 0.3)
    return {"X": X, "cycles": int(cycles),
            "uj": float(vwr2a_energy_uj(counters))}


def lm_section(device, params=None) -> dict:
    """One ``model.loss`` of reduced deepseek-moe-16b on all-ones tokens
    and labels at (2, 64); ``params`` default to `init_model_params`
    from seed 0 on ``device``."""
    dev = resolve_device(device)
    model = build_model(reduced(get_config(LM_ARCH)), device=dev)
    if params is None:
        params = init_model_params(model, 0, device=dev)
    batch = {"tokens": torch.ones(LM_BATCH, dtype=torch.int32, device=dev),
             "labels": torch.ones(LM_BATCH, dtype=torch.int32, device=dev)}
    with torch.no_grad():
        loss, metrics = model.loss(params, batch)
    return {"loss": float(loss), "metrics": {k: float(v)
                                             for k, v in metrics.items()}}


def run(device="cuda", params=None) -> dict:
    """The four sections on ``device``; ``params`` are the LM's
    (`lm_section`)."""
    dev = resolve_device(device)
    x = signal_batch()
    return {"device": str(dev), "shuffle": shuffle_section(dev),
            "fft_fir": fft_fir_section(x, dev), "archsim": archsim_section(x),
            "lm": lm_section(dev, params)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.device)
    print("== 1. shuffle unit (paper §3.3.1) ==")
    for name, v in r["shuffle"].items():
        print(f"{name:<11}:", v.cpu().numpy())
    print("\n== 2. FFT on the shuffle dataflow + FIR (CUDA kernels) ==")
    ff = r["fft_fir"]
    print("rfft kernel vs numpy rel err:", ff["rfft_rel_err"])
    print("fir kernel out:", tuple(ff["fir"].shape), "finite:",
          ff["fir_finite"])
    print("\n== 3. archsim: paper Table 2, 512-pt real FFT ==")
    sim = r["archsim"]
    print(f"simulated cycles: {sim['cycles']} (paper VWR2A: "
          f"{PAPER_CYCLES})  energy: {sim['uj']:.3f} uJ")
    print("\n== 4. one LM loss (assigned arch, reduced config) ==")
    print(f"{LM_ARCH} (reduced) loss: {r['lm']['loss']} on {r['device']}")
    if not ff["rfft_rel_err"] <= FFT_TOL["float32"]:
        raise SystemExit(f"rfft rel err {ff['rfft_rel_err']} > "
                         f"{FFT_TOL['float32']}")
    if not ff["fir_finite"] or not math.isfinite(r["lm"]["loss"]):
        raise SystemExit("non-finite FIR output or loss")
    print("\nquickstart OK")
    return r


if __name__ == "__main__":
    main()
