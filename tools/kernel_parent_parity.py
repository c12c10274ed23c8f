#!/usr/bin/env python3
"""Hold the FFT, FIR and graph kernels bitwise to their parent sources on
every case the parents take, and time both in turns.

    for f in fft/csrc/fft.cu fir/csrc/fir.cu pipeline/csrc/biosignal_graph.cu \
             pipeline/csrc/asr_graph.cu; do
        git show <commit>:src/repro_torch/kernels/$f > build/parent/$(basename $f)
    done
    python3 tools/kernel_parent_parity.py --parent-dir build/parent

The parents are sources with the current C interface of the symbols they
have (the FFT's and the FIR's launchers, both graph launchers with their
dtype codes 0-4). Each is built beside the kernel (`kernels._cuda.build`)
and run through the port's own entries with its library in place of the
kernel's, on the card (the FFT's four-step with the table layout of the
parent's source, `parent_four_step_table`, where it has no clusters):
* the FFT at every N from 2 to 8192, float32 and bfloat16, both ways, 61
  rows (301 at N 2), and at `asr_staged`'s shape (359,997 x 256);
* the FIR in float32 and bfloat16 at 1, 2, 11 and 64 taps on 5 rows of
  5,000 over 2,048-sample tiles, at 65, 255 and 2048 taps (the register
  path; both are bitwise the plain version), and at `asr_staged`'s shape
  (the hour's 359,997 x 512 frames, 2 taps);
* both graphs on float32, bfloat16, float16, int16 and int32 signals at
  their three entries (the integers near full scale), a stream at an odd
  hop and a ring whose slots start off 16 bytes, and in float32 the whole
  day (window 2048, hop 512) and hour (window 512, hop 160) in one stream
  call, every output.
Every output must be bitwise the parent's. Then, timed with the parent,
the kernel, the kernel and the parent (CUDA events behind a device
sleep): the FFT and FIR at `asr_staged`'s shapes, the FIR at
`pipeline_staged`'s (the day's 10,797 x 2048 frames, 11 taps) and past 64
taps over the day's frames (65, 255 and 2048 taps, float32), the
four-step FFT over one 2^20 row and 64 rows of 2^20 in float32, bfloat16
and float16 and one row each of 2^24, 2^14 and 2^17 in float32, each with
max |diff|
/ max |plain| of both against the plain version, and each graph's 8- or
32-frame stream dispatch. Needs a CUDA card and nvcc; prints one line a
group and writes ``build/kernel_parent_parity.json``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (ASR_HOP, ASR_WINDOW, DAY_SAMPLES,  # noqa: E402
                        HOP, WINDOW, card_line, event_ms, full_scale,
                        synthetic_audio)

SOURCES = {"fft": "fft.cu", "fir": "fir.cu",
           "biosignal_graph": "biosignal_graph.cu",
           "asr_graph": "asr_graph.cu"}


def parent_library(kernel: str, source: Path) -> ctypes.CDLL:
    """The parent's library, its symbols bound with the current
    signatures (those it does not export are left out)."""
    from repro_torch.kernels import _cuda

    lib = ctypes.CDLL(str(_cuda.build(source).path))
    for sym, (args, res) in _cuda.KERNELS[kernel].signatures.items():
        if hasattr(lib, sym):
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = args, res
    err = getattr(lib, f"{kernel}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def parent_four_step_table(n: int):
    """The four-step table of a source without clusters for N = n: the line
    transforms' `stockham_table` of N1 = 2^ceil(lg/2) and N2 =
    2^floor(lg/2) points, then W_N^j (j < N1) and W_N^(j N1) (j < N2),
    float32 from float64."""
    import numpy as np

    from repro_torch.kernels.fft.kernel import stockham_table

    lg = n.bit_length() - 1
    n1, n2 = 1 << (lg + 1) // 2, 1 << lg // 2

    def unit(j, m):
        ang = -2.0 * np.pi * j / m
        return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(
            np.float32)
    return np.concatenate([stockham_table(n1), stockham_table(n2),
                           unit(np.arange(n1), n),
                           unit(np.arange(n2) * n1, n)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent-dir", type=Path, required=True,
                    help="the parents' fft.cu, fir.cu, biosignal_graph.cu "
                         "and asr_graph.cu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.biosignal import make_app, synthetic_respiration
    from repro_torch.core.fir import lowpass_taps
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fft import kernel as fft_kernel
    from repro_torch.kernels.fft.kernel import fft_cuda, fft_plain
    from repro_torch.kernels.fir.kernel import fir_cuda
    from repro_torch.kernels.pipeline import cuda as pcuda
    from repro_torch.kernels.pipeline.asr import make_asr_frontend
    from repro_torch.kernels.pipeline.graph import (get_graph_factory,
                                                    graph_frames_call,
                                                    graph_ring_call,
                                                    graph_stream_call,
                                                    ring_chunk_samples)
    from repro_torch.serve.stream import frame_signal

    if not torch.cuda.is_available():
        print("kernel_parent_parity: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        futs = [pool.submit(_cuda.build_all)] + [
            pool.submit(_cuda.build, args.parent_dir / f)
            for f in SOURCES.values()]
        for f in futs:
            f.result()
    parents = {k: parent_library(k, args.parent_dir / f)
               for k, f in SOURCES.items()}
    real = _cuda.library
    real_table = fft_kernel.device_four_step_table
    # a source without clusters (none exported) lays its table out as
    # `parent_four_step_table`
    old_layout = not hasattr(parents["fft"], "fft_four_step_cluster")

    @functools.lru_cache(maxsize=None)
    def parent_table(n, device):
        return torch.as_tensor(parent_four_step_table(n), device=device)

    def use(which: str) -> None:
        lib = (lambda k: parents.get(k) or real(k)) if which == "parent" \
            else real
        _cuda.library = pcuda.library = lib
        fft_kernel.device_four_step_table = parent_table if \
            which == "parent" and old_layout else real_table

    def same(fn) -> bool:
        use("parent")
        want = fn()
        use("kernel")
        got = fn()
        torch.cuda.synchronize()
        if isinstance(want, dict):
            return all(torch.equal(got[k], want[k]) for k in want)
        if isinstance(want, tuple):
            return all(torch.equal(a, b) for a, b in zip(got, want))
        return torch.equal(got, want)

    g = torch.Generator(device=dev).manual_seed(11)
    report = {"card": card, "cases": {}, "times": {}}
    # ---- FFT: every N the parent takes
    bad = []
    n_cases = 0
    for lg in range(1, 14):
        n = 1 << lg
        rows = 301 if n == 2 else 61
        for dtype in (torch.float32, torch.bfloat16):
            re = torch.randn(rows, n, generator=g, device=dev).to(dtype)
            im = torch.randn(rows, n, generator=g, device=dev).to(dtype)
            for inverse in (False, True):
                n_cases += 1
                if not same(lambda: fft_cuda(re, im, inverse=inverse)):
                    bad.append(f"fft {dtype} N={n} inverse={inverse}")
    hr = torch.randn(359_997, 256, generator=g, device=dev)
    hi = torch.randn(359_997, 256, generator=g, device=dev)
    n_cases += 1
    if not same(lambda: fft_cuda(hr, hi)):
        bad.append("fft asr_staged shape")
    report["cases"]["fft"] = {"cases": n_cases, "not_bitwise": bad}
    print(f"fft: {n_cases} cases (N 2-8192 x float32/bfloat16 x both ways, "
          f"and 359,997 x 256): bitwise the parent's in "
          f"{n_cases - len(bad)} [{card}]", flush=True)
    # ---- FIR: the parent's dtypes and tap counts
    bad, n_cases = [], 0
    for dtype in (torch.float32, torch.bfloat16):
        for k in (1, 2, 11, 64, 65, 255, 2048):
            x = torch.randn(5, 5000, generator=g, device=dev).to(dtype)
            taps = torch.as_tensor(lowpass_taps(max(k, 2))[:k], device=dev)
            n_cases += 1
            if not same(lambda: fir_cuda(x, taps, seq_block=2048)):
                bad.append(f"fir {dtype} k={k}")
    app = make_asr_frontend(device=dev)
    audio = synthetic_audio(359_996 * ASR_HOP + ASR_WINDOW, seed=0,
                            device=dev)
    frames = frame_signal(audio, ASR_WINDOW, ASR_HOP)
    n_cases += 1
    if not same(lambda: fir_cuda(frames, app.fir_taps)):
        bad.append("fir asr_staged shape")
    report["cases"]["fir"] = {"cases": n_cases, "not_bitwise": bad}
    print(f"fir: {n_cases} cases (float32/bfloat16 x 1/2/11/64/65/255/2048 "
          f"taps, and "
          f"the hour's 359,997 x 512 frames, 2 taps): bitwise the parent's "
          f"in {n_cases - len(bad)} [{card}]", flush=True)
    # ---- both graphs: the parent's five dtypes at the three entries
    bad, n_cases = [], 0
    bio = make_app(device=dev)
    day = synthetic_respiration(1, DAY_SAMPLES, seed=0, device=dev)[0][0]
    whole_signals = {"biosignal": day, "asr": audio}
    sig = day[: 63 * HOP + WINDOW]
    aud = audio[: 69 * ASR_HOP + ASR_WINDOW]
    streams = {}
    for gname, a, x0, W, H, B in (("biosignal", bio, sig, WINDOW, HOP, 8),
                                  ("asr", app, aud, ASR_WINDOW, ASR_HOP,
                                   16)):
        graph, ops = get_graph_factory(gname)(a)
        for dtype in (torch.float32, torch.bfloat16, torch.float16,
                      torch.int16, torch.int32):
            x = x0.to(dtype) if dtype.is_floating_point else \
                full_scale(x0, dtype)
            fr = frame_signal(x, W, H)
            span = ring_chunk_samples(W, H, B)
            ring = x[: 3 * B * H + span].as_strided((4, span), (B * H, 1))
            kw = dict(graph=graph)
            odd = x[1: 1 + 3 * B * (H + 1) + span].as_strided(
                (4, span), (B * (H + 1), 1))
            for entry, fn in (
                    ("stream", lambda: graph_stream_call(
                        x, ops, window=W, hop=H, **kw)),
                    ("frames", lambda: graph_frames_call(fr, ops, **kw)),
                    ("ring", lambda: graph_ring_call(
                        ring, ops, window=W, hop=H, **kw)),
                    (f"stream, hop {H + 1}", lambda: graph_stream_call(
                        x, ops, window=W, hop=H + 1, **kw)),
                    ("ring, odd slot stride", lambda: graph_ring_call(
                        odd, ops, window=W, hop=H, **kw))):
                n_cases += 1
                if not same(fn):
                    bad.append(f"{gname} {dtype} {entry}")
        whole = whole_signals[gname]
        n_cases += 1
        if not same(lambda: graph_stream_call(whole, ops, window=W, hop=H,
                                              **kw)):
            bad.append(f"{gname} whole signal")
        chunk = x0[:ring_chunk_samples(W, H, B)]
        streams[f"{gname} stream B={B}"] = \
            lambda c=chunk, ops=ops, kw=dict(graph=graph), W=W, H=H: \
            graph_stream_call(c, ops, window=W, hop=H, **kw)
    report["cases"]["graphs"] = {"cases": n_cases, "not_bitwise": bad}
    print(f"graphs: {n_cases} cases (biosignal and ASR x float32/bfloat16/"
          f"float16/int16/int32 x stream/frames/ring, an odd hop and an odd "
          f"slot stride, and the whole day and hour in float32; every "
          f"output): bitwise the parent's in {n_cases - len(bad)} [{card}]",
          flush=True)
    # ---- times in turns: parent, kernel, kernel, parent
    day_frames = frame_signal(day, WINDOW, HOP)
    timed = {"fft asr_staged (359,997 x 256)": (lambda: fft_cuda(hr, hi),
                                                20),
             "fir asr_staged (359,997 x 512, 2 taps)":
                 (lambda: fir_cuda(frames, app.fir_taps), 20),
             "fir pipeline_staged (10,797 x 2048, 11 taps)":
                 (lambda: fir_cuda(day_frames, bio.fir_taps), 20)}
    for k in (65, 255, 2048):
        taps = torch.as_tensor(lowpass_taps(
            k, cutoff=0.02 if k == 255 else min(0.4, 8.0 / k)), device=dev)
        timed[f"fir day frames (10,797 x 2048, {k} taps)"] = (
            lambda taps=taps: fir_cuda(day_frames, taps), 10)
    timed.update({name: (fn, 200) for name, fn in streams.items()})
    for name, (fn, reps) in timed.items():
        times = []
        for which in ("parent", "kernel", "kernel", "parent"):
            use(which)
            times.append((which, event_ms(fn, reps)))
        use("kernel")
        report["times"][name] = times
        print(f"time {name}: " + ", ".join(f"{w} {t:.5f}" for w, t in times)
              + f" ms [{card}]", flush=True)
    del hr, hi, frames, audio
    # ---- the four-step in turns, each with its distance to the plain
    # version (max |diff| / max |plain|; the two are not bitwise)
    for dname in ("float32", "bfloat16", "float16"):
        dtype = getattr(torch, dname)
        for n, rows in ((1 << 20, 1), (1 << 20, 64), (1 << 24, 1),
                        (1 << 14, 1), (1 << 17, 1)):
            if n != 1 << 20 and dtype != torch.float32:
                continue
            name = f"fft four-step {dname} {rows} x {n}"
            xr = torch.randn(rows, n, generator=g, device=dev).to(dtype)
            xi = torch.randn(rows, n, generator=g, device=dev).to(dtype)
            want = fft_plain(xr, xi)
            fft_kernel.device_twiddles.cache_clear()
            scale = max(float(w.float().abs().max()) for w in want)
            err = {}
            for which in ("parent", "kernel"):
                use(which)
                got = fft_cuda(xr, xi)
                err[which] = max(float((a.float() - b.float()).abs().max())
                                 for a, b in zip(got, want)) / scale
                del got
            del want
            times = []
            for which in ("parent", "kernel", "kernel", "parent"):
                use(which)
                times.append((which, event_ms(lambda: fft_cuda(xr, xi),
                                              10)))
            use("kernel")
            report["times"][name] = times
            report["cases"].setdefault("fft four-step", {})[name] = err
            print(f"time {name}: " + ", ".join(
                f"{w} {t:.5f}" for w, t in times) + " ms; max |diff| / max "
                f"|plain| parent {err['parent']:.3e}, kernel "
                f"{err['kernel']:.3e} [{card}]", flush=True)
            del xr, xi
            torch.cuda.empty_cache()
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "kernel_parent_parity.json").write_text(json.dumps(report,
                                                              indent=1))
    bad = [c for v in report["cases"].values()
           for c in v.get("not_bitwise", ())]
    if bad:
        print(f"NOT bitwise the parent's: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
