"""The paper's own application end to end: the MBioTracker biosignal
pipeline (§4.4.2) served by the streaming runtime, cross-checked against
the staged app and the cycle-accurate simulator, with a small SVM fit.

    PYTHONPATH=src python -m repro_torch.launch.biosignal_app
    PYTHONPATH=src python -m repro_torch.launch.biosignal_app --device cpu

The raw continuous respiration signal feeds the fused biosignal graph
kernel (`kernels/pipeline/csrc/biosignal_graph.cu`) in contiguous chunks
that the kernel frames itself, at the paper's full width (window 2048,
hop 512, 11 taps, a 512-point FFT, 12 features, 2 classes;
`configs/vwr2a_biosignal.py`), with the kernel's frames a block measured
(`StreamConfig(autotune=True)`). The readings:

* windows/s of the raw feed and of the host-framed feed, both tuned;
* the 4-column deal's largest margin difference from one column;
* the stream's largest margin difference from the staged (plain) app;
* the SVM fitted on 32 labelled windows and its accuracy on 32 more;
* the simulator's cycles and uJ for one window, and the savings against
  the paper's CPU figures (166,667 cycles, 2.6 uJ; the paper reads 90.9%
  and 66.3%);
* the autotune winners with each search's host cost.

It runs on the card unless ``device="cpu"`` is asked for; asked for the
card on a host without one, it raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.archsim.energy import vwr2a_energy_uj
from repro_torch.archsim.programs.app import run_app
from repro_torch.core import autotune
from repro_torch.core.biosignal import (extract_features, make_app,
                                        svm_fit_least_squares, svm_predict,
                                        synthetic_respiration)
from repro_torch.core.fir import fir_direct, lowpass_taps
from repro_torch.device import resolve_device
from repro_torch.serve.stream import (BiosignalStream, StreamConfig,
                                      frame_signal)

WINDOW, HOP = 2048, 512
BATCH_WINDOWS = 16                     # windows a dispatch, as the example
SEED = 3                               # the signal's and the SVM's data
CPU_CYCLES, CPU_UJ = 166667, 2.6       # the paper's CPU app, one window
STAGES = ("preprocessing", "delineation", "feat_extraction", "svm")
# the example's own bounds on the margins (examples/biosignal_app.py)
STAGED_TOL, COLUMN_TOL = 1e-3, 1e-4


def _timed(stream: BiosignalStream, signal: torch.Tensor, dev) -> tuple:
    """(outputs, seconds) of one `process` after a warm pass over a
    16-window prefix (the autotune search and the first launch's build
    happen there)."""
    stream.process(signal[: WINDOW * 16])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = stream.process(signal)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def fit_svm(device="cuda") -> dict:
    """The app's SVM: 64 labelled windows from `SEED`, features of the
    low-pass-filtered windows, a least-squares fit on the first 32 and
    the classes and accuracy of the other 32, all on ``device``. Returns
    {"signal", "labels", "w", "b", "pred", "accuracy"}."""
    dev = resolve_device(device)
    sig, labels = synthetic_respiration(64, WINDOW, seed=SEED, device=dev)
    feats = extract_features(fir_direct(sig, lowpass_taps(11)))
    w, b = svm_fit_least_squares(feats[:32], labels[:32])
    _, pred = svm_predict(feats[32:], w, b)
    acc = float((pred == labels[32:]).float().mean())
    return {"signal": sig, "labels": labels, "w": w, "b": b, "pred": pred,
            "accuracy": acc}


def archsim_window(window: np.ndarray, w: np.ndarray, b: np.ndarray) -> dict:
    """One window on the cycle-accurate simulator (`archsim.programs.app`):
    per-stage cycles, the total cycles and uJ, the savings against the
    paper's CPU app, and the simulator's predicted class."""
    out = run_app(window, lowpass_taps(11), w, b)
    cycles = sum(out[k][1] for k in STAGES)
    uj = sum(vwr2a_energy_uj(out[k][0]) for k in STAGES)
    return {"stage_cycles": {k: out[k][1] for k in STAGES},
            "cycles": cycles, "uj": uj, "prediction": out["prediction"],
            "cycle_saving": 1 - cycles / CPU_CYCLES,
            "energy_saving": 1 - uj / CPU_UJ}


def run(device="cuda", n_windows: int = 40) -> dict:
    """The application's readings on ``device`` over a signal of
    ``n_windows`` * 2048 samples (the example's 40 by default), in
    dispatches of `BATCH_WINDOWS` windows. Starts from an empty autotune
    cache, as a fresh process does."""
    dev = resolve_device(device)
    autotune.clear_cache()
    sig = synthetic_respiration(1, WINDOW * n_windows, seed=SEED,
                                device=dev)[0][0]
    app = make_app(device=dev)
    sel = ("features", "margin", "class")
    cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=BATCH_WINDOWS,
                       autotune=True, outputs=sel)
    out, dt = _timed(BiosignalStream(app, cfg), sig, dev)
    host_out, dt_host = _timed(BiosignalStream(app, StreamConfig(
        window=WINDOW, hop=HOP, batch_windows=BATCH_WINDOWS, autotune=True,
        framing="host")), sig, dev)
    n = int(out["class"].shape[0])

    col = BiosignalStream(app, StreamConfig(
        window=WINDOW, hop=HOP, batch_windows=4, n_columns=4,
        outputs=sel)).process(sig)
    col_err = float((col["margin"] - out["margin"]).abs().max())

    staged = app(frame_signal(sig, WINDOW, HOP))
    staged_err = float((staged["margin"] - out["margin"]).abs().max())
    host_err = float((host_out["margin"] - out["margin"]).abs().max())

    fit = fit_svm(dev)
    sim = archsim_window(fit["signal"][0].cpu().numpy() * 0.5,
                         fit["w"].cpu().numpy(), fit["b"].cpu().numpy())
    # a key with one candidate is cached without a search
    log = autotune.search_log()
    winners = [{"key": list(k), "winner": v, "candidates": [v], "ms": None,
                "spread": None, "clock": None, "search_ms": 0.0,
                **log.get(k, {})}
               for k, v in autotune.cache_snapshot().items()]
    return {"device": str(dev), "samples": int(sig.shape[0]), "windows": n,
            "windows_per_s": n / dt, "host_windows_per_s": n / dt_host,
            "outputs": sorted(out), "column_err": col_err,
            "staged_err": staged_err, "host_err": host_err,
            "class": out["class"], "margin": out["margin"],
            "w": fit["w"], "b": fit["b"], "holdout_pred": fit["pred"],
            "accuracy": fit["accuracy"], "archsim": sim,
            "autotune": winners}


def report(r: dict) -> list[str]:
    """The example's lines for a `run` result."""
    sim = r["archsim"]
    lines = [
        f"{r['samples']} raw samples -> {r['windows']} overlapping windows, "
        f"{r['windows_per_s']:.0f} windows/s (frames cut by the kernel, "
        f"no filtered-window write) on {r['device']}",
        f"host-framed: {r['host_windows_per_s']:.0f} windows/s -> raw-chunk "
        f"feed is {r['windows_per_s'] / r['host_windows_per_s']:.2f}x "
        f"faster",
        f"n_columns=4 (columns one after another): margin max|delta| = "
        f"{r['column_err']:.1e}",
        f"margin max |stream - staged| = {r['staged_err']:.2e}",
        f"holdout accuracy: {r['accuracy']:.2f} (chance 0.5)",
        f"VWR2A: {sim['cycles']} cycles, {sim['uj']:.3f} uJ per window",
        f"paper CPU app: {CPU_CYCLES} cycles, {CPU_UJ} uJ  ->  savings "
        f"{100 * sim['cycle_saving']:.1f}% cycles, "
        f"{100 * sim['energy_saving']:.1f}% energy (paper: 90.9% / 66.3%)"]
    for t in r["autotune"]:
        times = "" if t["ms"] is None else " ".join(
            f"{c}:{ms:.4f}ms(+{100 * s:.0f}%)" for c, ms, s in
            zip(t["candidates"], t["ms"], t["spread"]))
        lines.append(f"autotune {tuple(t['key'])}: winner {t['winner']} "
                     f"[{times}] search {t['search_ms']:.1f} ms")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--windows", type=int, default=40)
    args = ap.parse_args(argv)
    r = run(args.device, args.windows)
    for line in report(r):
        print(line)
    if r["staged_err"] >= STAGED_TOL or r["column_err"] >= COLUMN_TOL:
        raise SystemExit(f"margins off: staged {r['staged_err']}, columns "
                         f"{r['column_err']}")
    if r["outputs"] != ["class", "features", "margin"]:
        raise SystemExit(f"outputs {r['outputs']}")
    print("biosignal app OK")
    return r


if __name__ == "__main__":
    main()
