#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py            # all phases; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain only

Phases, each printing one line (or a few):

1. the card's name and power limit (nvidia-smi), then the kernel build;
2. the fused biosignal graph kernel held against its plain PyTorch
   version on the card, for the framed, stream and ring entries, at the
   full width (window 2048, hop 512) and every output selection; stream,
   framed and ring slot r must agree bitwise;
3. the main path: `BiosignalStream(...).process` over a 24-hour, 64 Hz
   synthetic recording (5,529,600 samples, 10,797 frames) for
   batch_windows 8 and 512, with and without the filtered output, plus the
   host-framed reference; the kernel's launch count must rise as expected,
   and every row of every run is held against the plain version;
4. `ResidentStream.process` on the same signal, bitwise equal to phase 3,
   with drained totals equal to the frame count;
5. per-kernel times (CUDA events) beside the bound worked out from the
   bytes and operations the graph needs on this run's data, and the plain
   version's time;
6. the ported kernels and the entries that launched them.

The last two lines are a JSON object of per-kernel numbers and the
contract line ``{"ok": true, "device": {...}}``. Any failing phase raises,
so the script exits non-zero and prints no result; it also does so when
no card is present or when the repository's `src/` is missing. Details
too long for the output go to ``chiprun_out/chip_smoke.json``.

Imports torch and the port only — never jax, never the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WINDOW, HOP, FFT = 2048, 512, 512
DAY_SAMPLES = 24 * 3600 * 64                  # 5,529,600
PEAK_FP32 = 67e12                             # H100 SXM, non-tensor fp32
PEAK_BYTES = 3.35e12                          # H100 SXM HBM3
SOURCE = "src/repro_torch/kernels/pipeline/csrc/biosignal_graph.cu"
REPLACES = {"frames": "src/repro/kernels/pipeline/graph.py:479",
            "stream": "src/repro/kernels/pipeline/graph.py:526",
            "ring": "src/repro/kernels/pipeline/graph.py:575"}
# |kernel - plain| <= ATOL + RTOL * |plain|, per output. The FIR and the
# SVM run in the same order in both, without FMA; the delineation mean,
# the FFT-segment mean and the band sums are reductions in another order.
TOL = {"filtered": (1e-6, 1e-6), "features": (1e-5, 1e-5),
       "margin": (1e-4, 1e-5)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check_close(name: str, got: dict, want: dict) -> float:
    """Raise unless ``got`` matches ``want`` (class exact, floats within
    TOL); returns the largest float difference."""
    import torch

    if sorted(got) != sorted(want):
        raise AssertionError(f"{name}: keys {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}/{k}: {g.dtype}{tuple(g.shape)} vs "
                                 f"{w.dtype}{tuple(w.shape)}")
        if k == "class":
            if not torch.equal(g, w):
                bad = (g != w).nonzero()[:5].flatten().tolist()
                raise AssertionError(f"{name}/class differs at rows {bad}")
            continue
        atol, rtol = TOL[k]
        diff = (g - w).abs()
        lim = atol + rtol * w.abs()
        if not bool((diff <= lim).all()):
            i = int((diff - lim).argmax())
            raise AssertionError(
                f"{name}/{k}: |diff| {diff.flatten()[i].item():.3e} > "
                f"{lim.flatten()[i].item():.3e} at flat index {i}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def check_equal(name: str, got: dict, want: dict) -> None:
    import torch

    for k in want:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{name}/{k}: not bitwise equal")


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events). The host first enqueues all calls behind a device-side sleep
    longer than the enqueue takes, so the events time the device's work
    and not the host's launch overhead. One warm-up call first."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s + 0.01)))  # >= 2x the enqueue
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean wall time of ``fn`` per call, synchronised at the end: what a
    caller pays, launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def extremum_counts(filtered) -> tuple:
    """Per-frame (candidates, extrema) of (R, S) filtered frames, int64
    (R,) tensors: the samples that pass the neighbour and amplitude tests
    of `delineate` (where the refractory window must be reduced) and the
    extrema it keeps (what the gap sums and the median touch)."""
    import torch

    from repro_torch.core.biosignal import MIN_PROMINENCE, delineate

    x = filtered
    prev, nxt = torch.roll(x, 1, dims=-1), torch.roll(x, -1, dims=-1)
    mu = x.mean(dim=-1, keepdim=True)
    hi, lo = x.amax(dim=-1, keepdim=True), x.amin(dim=-1, keepdim=True)
    cand = ((x > prev) & (x >= nxt) & (x > mu + MIN_PROMINENCE * (hi - mu))) \
        | ((x < prev) & (x <= nxt) & (x < mu - MIN_PROMINENCE * (mu - lo)))
    is_max, is_min = delineate(x)
    return cand.sum(dim=-1), is_max.sum(dim=-1) + is_min.sum(dim=-1)


def graph_work(n_frames: int, in_samples: int, outputs: tuple,
               candidates: int, extrema: int, n_taps: int = 11,
               n_classes: int = 2, min_distance: int = 15) -> tuple:
    """(bytes, operations) the graph needs for ``n_frames`` frames read
    from ``in_samples`` input samples: each input read once (signal and
    tables), each requested output written once. Operations: per sample
    only what every sample needs (FIR multiply-adds, the three reductions,
    the extremum tests, one gap scan per mask); the refractory window at
    each of this data's ``candidates`` and the gap sums and the median at
    each of its ``extrema``; then per frame the segment mean, the Stockham
    FFT, untangle, power, band sums, log1p, the interval statistics and
    the SVM."""
    S, m = WINDOW, FFT // 2
    stages = int(math.log2(m))
    tables = 4 * (n_taps + 2 * stages * (m // 2) + 2 * m + 12 * n_classes
                  + n_classes)
    out_bytes = {"filtered": 4 * S, "features": 4 * 12,
                 "margin": 4 * n_classes, "class": 4}
    nbytes = 4 * in_samples + tables + n_frames * sum(
        out_bytes[o] for o in outputs)
    ops = 2 * n_taps * S                              # FIR
    data_ops = 0
    if outputs != ("filtered",):
        ops += 3 * S + 6                              # mean, max, min; gates
        ops += 2 * 4 * S                              # extremum tests
        ops += 2 * S                                  # gap scan, both masks
        ops += 2 * 3                                  # mean, rms per mask
        ops += 2 * FFT                                # segment mean, subtract
        ops += stages * (m // 2) * 10                 # butterflies
        ops += m * 14 + 3 * (m + 1) + (m + 1)         # untangle, power, bands
        ops += 6                                      # log1p
        if set(outputs) & {"margin", "class"}:
            ops += 2 * 12 * n_classes + n_classes
        data_ops = candidates * (2 * min_distance + 1)  # window reduce
        data_ops += extrema * (5 + 2)                 # gap sums; selection
    return nbytes, ops * n_frames + data_ops


def bound_ms(nbytes: int, ops: int) -> tuple:
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-2 only (build + kernel vs plain)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.biosignal import make_app, synthetic_respiration
    from repro_torch.kernels.pipeline import cuda
    from repro_torch.kernels.pipeline.graph import (
        get_graph_factory, graph_frames_call, graph_frames_plain,
        graph_ring_call, graph_ring_plain, graph_stream_call,
        graph_stream_plain, ring_chunk_samples, stream_frame_count)
    from repro_torch.kernels.pipeline.kernel import OUTPUTS
    from repro_torch.serve.resident import ResidentConfig, ResidentStream
    from repro_torch.serve.stream import (BiosignalStream, StreamConfig,
                                          frame_signal)

    report: dict = {}
    # ---- phase 1: card, build
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    b = cuda.build()
    print(f"build: {b.seconds:.2f} s nvcc ({b.path.name}, "
          f"{'cached' if b.seconds == 0.0 else 'fresh'})")
    report["build"] = {"seconds": b.seconds, "log": b.log}
    ptx = [ln.strip() for ln in b.log.splitlines() if "registers" in ln]
    if ptx:
        print(f"ptxas: {ptx[0]}")

    dev = torch.device("cuda", 0)
    app = make_app(device=dev)
    graph, operands = get_graph_factory("biosignal")(app)

    # ---- phase 2: kernel vs plain on the card, every entry and selection
    n_cmp = 64
    cmp_sig = synthetic_respiration(1, (n_cmp - 1) * HOP + WINDOW, seed=1,
                                    device=dev)[0][0]
    frames = frame_signal(cmp_sig, WINDOW, HOP)
    bw, depth = 8, 4
    span, stride = ring_chunk_samples(WINDOW, HOP, bw), bw * HOP
    ring = torch.stack([cmp_sig[r * stride: r * stride + span]
                        for r in range(depth)])
    selections = [OUTPUTS, ("features", "margin", "class"), ("filtered",),
                  ("features",), ("margin",), ("class",)]
    max_err = {"frames": 0.0, "stream": 0.0, "ring": 0.0}
    for sel in selections:
        kw = dict(graph=graph, outputs=sel)
        ks = graph_stream_call(cmp_sig, operands, window=WINDOW, hop=HOP,
                               **kw)
        kf = graph_frames_call(frames, operands, **kw)
        kr = graph_ring_call(ring, operands, window=WINDOW, hop=HOP, **kw)
        torch.cuda.synchronize()
        ps = graph_stream_plain(cmp_sig, operands, window=WINDOW, hop=HOP,
                                **kw)
        pf = graph_frames_plain(frames, operands, **kw)
        pr = graph_ring_plain(ring, operands, window=WINDOW, hop=HOP, **kw)
        max_err["stream"] = max(max_err["stream"],
                                check_close(f"stream{sel}", ks, ps))
        max_err["frames"] = max(max_err["frames"],
                                check_close(f"frames{sel}", kf, pf))
        max_err["ring"] = max(max_err["ring"],
                              check_close(f"ring{sel}", kr, pr))
        check_equal(f"stream==framed{sel}", ks, kf)
        for r in range(depth):
            one = graph_stream_call(ring[r], operands, window=WINDOW,
                                    hop=HOP, **kw)
            check_equal(f"ring[{r}]==stream{sel}",
                        {k: v[r] for k, v in kr.items()}, one)
    print(f"kernel vs plain on the card: {len(selections)} output "
          f"selections x (frames, stream, ring) at window {WINDOW} hop "
          f"{HOP}, {n_cmp} frames: class exact, max |diff| "
          f"frames {max_err['frames']:.3e} stream {max_err['stream']:.3e} "
          f"ring {max_err['ring']:.3e}; stream == framed == ring slot "
          f"bitwise")
    if args.quick:
        return 0

    # ---- phase 3: the main path over a 24-hour recording
    sig = synthetic_respiration(1, DAY_SAMPLES, seed=0, device=dev)[0][0]
    n = stream_frame_count(DAY_SAMPLES, WINDOW, HOP)
    if n != 10_797:
        raise AssertionError(f"{n} frames in a day, expected 10797")
    main_out, launches, rates = {}, {}, {}
    for B in (8, 512):
        for sel in (("features", "margin", "class"), OUTPUTS):
            cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=B,
                               outputs=sel)
            stream = BiosignalStream(app, cfg)
            torch.cuda.synchronize()
            cuda.reset_launches()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = stream.process(sig)
            t1.record()
            t1.synchronize()
            got = dict(cuda.LAUNCHES)
            want = -(-n // B)
            if got["stream"] != want or got["frames"] or got["ring"]:
                raise AssertionError(f"B={B} {sel}: launches {got}, "
                                     f"expected {want} stream launches")
            for k, v in out.items():
                if v.shape[0] != n:
                    raise AssertionError(f"{k}: {v.shape[0]} rows != {n}")
                if v.is_floating_point() and not bool(v.isfinite().all()):
                    raise AssertionError(f"{k}: non-finite values")
            if not bool(((out["class"] == 0) | (out["class"] == 1)).all()):
                raise AssertionError("class outside {0, 1}")
            ms = t0.elapsed_time(t1)
            tag = f"B={B} {'all' if sel == OUTPUTS else 'no-filtered'}"
            rates[tag] = n / (ms / 1e3)
            launches[tag] = got["stream"]
            main_out[(B, sel)] = out
            print(f"main path {tag}: {n} frames in {ms:.1f} ms = "
                  f"{rates[tag]:.0f} windows/s, {got['stream']} stream "
                  f"launches [{kind}; {card}]")
    # every row of every main-path run against the plain version over the
    # whole day, in slices of frames; the same slices give this data's
    # candidate and extremum counts for the bounds of phase 5
    cand, ext, worst = [], [], 0.0
    for f0 in range(0, n, 2048):
        f1 = min(n, f0 + 2048)
        plain = graph_stream_plain(sig[f0 * HOP: (f1 - 1) * HOP + WINDOW],
                                   operands, graph=graph, window=WINDOW,
                                   hop=HOP)
        for (B, sel), out in main_out.items():
            worst = max(worst, check_close(
                f"main B={B} frames {f0}:{f1}",
                {k: v[f0:f1] for k, v in out.items()},
                {k: plain[k] for k in out}))
        c, e = extremum_counts(plain["filtered"])
        cand.append(c)
        ext.append(e)
        del plain
    cand_cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          torch.cat(cand).cumsum(0)]).tolist()
    ext_cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cat(ext).cumsum(0)]).tolist()
    max_err["main"] = worst
    print(f"main path vs plain on the card: all {n} rows of the "
          f"{len(main_out)} runs, class exact, max |diff| {worst:.3e}; "
          f"{cand_cum[n] / n:.1f} candidates, {ext_cum[n] / n:.1f} extrema "
          f"per frame")
    # the host-framed reference (framed kernel entry), bitwise equal
    for B in (8,):
        cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=B,
                           framing="host", outputs=("features", "margin",
                                                    "class"))
        torch.cuda.synchronize()
        cuda.reset_launches()
        host = BiosignalStream(app, cfg).process(sig)
        torch.cuda.synchronize()
        got = dict(cuda.LAUNCHES)
        if got["frames"] != -(-n // B) or got["stream"] or got["ring"]:
            raise AssertionError(f"host framing launches {got}")
        check_equal("host framing == kernel framing", host,
                    main_out[(B, ("features", "margin", "class"))])
        launches["frames"] = got["frames"]
        print(f"host-framed reference B={B}: bitwise equal to the raw-chunk "
              f"path, {got['frames']} frames launches")

    # ---- phase 4: the resident loop, bitwise equal to phase 3
    for B, sel in ((8, ("features", "margin", "class")), (512, OUTPUTS)):
        rcfg = ResidentConfig(ring_depth=4, drain_interval=4)
        rs = ResidentStream(app, StreamConfig(window=WINDOW, hop=HOP,
                                              batch_windows=B, outputs=sel),
                            rcfg)
        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        res = rs.process(sig)
        t1.record()
        t1.synchronize()
        got = dict(cuda.LAUNCHES)
        sweeps = -(-n // (4 * B))
        if got["ring"] != sweeps or got["stream"] or got["frames"]:
            raise AssertionError(f"resident launches {got}, expected "
                                 f"{sweeps} ring launches")
        check_equal(f"resident B={B}", res, main_out[(B, sel)])
        if rs.last_drains[-1] != n:
            raise AssertionError(f"drained {rs.last_drains[-1]} != {n}")
        ms = t0.elapsed_time(t1)
        tag = f"resident B={B} ring_depth=4"
        rates[tag] = n / (ms / 1e3)
        if B == 8:
            launches["ring"] = got["ring"]
        print(f"{tag}: bitwise equal to the host-driven stream, drained "
              f"{rs.last_drains[-1]} = {n} frames in "
              f"{len(rs.last_drains)} drains, {got['ring']} ring launches, "
              f"{rates[tag]:.0f} windows/s [{kind}; {card}]")

    # ---- phase 5: per-kernel times beside the bound and the plain time
    feat = ("features", "margin", "class")
    chunk8 = sig[: ring_chunk_samples(WINDOW, HOP, 8)]
    frames8 = frame_signal(chunk8, WINDOW, HOP)
    ring8 = sig[: 3 * 8 * HOP + ring_chunk_samples(WINDOW, HOP, 8)] \
        .as_strided((4, ring_chunk_samples(WINDOW, HOP, 8)), (8 * HOP, 1))
    cases = {
        # name: (kernel fn, plain fn, frames 0..n of the day, input samples)
        "stream": (lambda: graph_stream_call(chunk8, operands, graph=graph,
                                             window=WINDOW, hop=HOP,
                                             outputs=feat),
                   lambda: graph_stream_plain(chunk8, operands, graph=graph,
                                              window=WINDOW, hop=HOP,
                                              outputs=feat),
                   8, chunk8.numel()),
        "frames": (lambda: graph_frames_call(frames8, operands, graph=graph,
                                             outputs=feat),
                   lambda: graph_frames_plain(frames8, operands, graph=graph,
                                              outputs=feat),
                   8, frames8.numel()),
        "ring": (lambda: graph_ring_call(ring8, operands, graph=graph,
                                         window=WINDOW, hop=HOP,
                                         outputs=feat),
                 lambda: graph_ring_plain(ring8, operands, graph=graph,
                                          window=WINDOW, hop=HOP,
                                          outputs=feat),
                 32, 3 * 8 * HOP + ring_chunk_samples(WINDOW, HOP, 8)),
    }
    kernels = []
    for entry, (kfn, pfn, nf, nin) in cases.items():
        ms = event_ms(kfn, 200)
        pms = event_ms(pfn, 10)
        wall = host_ms(kfn, 200)
        nbytes, ops = graph_work(nf, nin, feat, cand_cum[nf], ext_cum[nf])
        bms, by = bound_ms(nbytes, ops)
        report.setdefault("wall_ms_per_call", {})[entry] = wall
        kernels.append({
            "name": f"biosignal_graph[{entry}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[entry],
            "launches": launches["B=8 no-filtered"] if entry == "stream"
            else launches[entry],
            "max_abs_err": max(max_err[entry], max_err["main"])
            if entry == "stream" else max_err[entry], "ms": ms,
            "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
        print(f"time {entry}: {nf} frames (main-path dispatch, "
              f"features+margin+class) kernel {ms:.4f} ms device, "
              f"{wall:.4f} ms per call with the wrapper, plain {pms:.3f} ms, "
              f"bound {bms:.6f} ms ({by}) [{card}]")
    # the same kernel at wider dispatches (no JSON entry: PERF.md reads it)
    wide = {}
    for label, x, nf, sel in (
            ("stream B=512", sig[: ring_chunk_samples(WINDOW, HOP, 512)],
             512, feat),
            ("stream whole day", sig, n, feat),
            ("stream whole day +filtered", sig, n, OUTPUTS)):
        ms = event_ms(lambda: graph_stream_call(
            x, operands, graph=graph, window=WINDOW, hop=HOP, outputs=sel),
            20)
        nbytes, ops = graph_work(nf, x.numel(), sel, cand_cum[nf],
                                 ext_cum[nf])
        bms, by = bound_ms(nbytes, ops)
        wide[label] = {"frames": nf, "ms": ms, "bound_ms": bms,
                       "bound_by": by}
        print(f"time {label}: {nf} frames kernel {ms:.4f} ms, bound "
              f"{bms:.5f} ms ({by}), {nf / (ms / 1e3):.0f} windows/s "
              f"[{card}]")

    # ---- phase 6: kernels and the entries that launched them
    print(f"kernels: {SOURCE} (cuda) launched by frames "
          f"({launches['frames']}), stream ({launches['B=8 no-filtered']}), "
          f"ring ({launches['ring']}) on the main-path runs")
    report.update({"card": card, "kind": kind, "rates_windows_per_s": rates,
                   "launches": launches, "kernels": kernels, "wide": wide,
                   "max_abs_err": max_err,
                   "per_frame": {"candidates": cand_cum[n] / n,
                                 "extrema": ext_cum[n] / n}})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
