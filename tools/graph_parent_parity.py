#!/usr/bin/env python3
"""Hold the graph kernels' float32 results bitwise to a parent source.

    git show <commit>:src/repro_torch/kernels/pipeline/csrc/biosignal_graph.cu \
        > build/parent_bio.cu
    git show <commit>:src/repro_torch/kernels/pipeline/csrc/asr_graph.cu \
        > build/parent_asr.cu
    python3 tools/graph_parent_parity.py --bio build/parent_bio.cu \
        --asr build/parent_asr.cu

The parents are sources from before the 16-bit signal path, whose
launchers take no dtype code after ``x``. Each is built beside the
kernel (`kernels._cuda.build`) and run through the port's own entries
with its library in place of the kernel's, on the card: the biosignal
day (window 2048, hop 512) and the ASR hour (window 512, hop 160) in one
stream call each with every output, their main-path dispatches (the
8-frame and 32-frame stream, frames and 4-slot ring), a stream at an odd
hop and a ring whose slots start off 16 bytes. Every output of every case
must be bitwise the parent's. Then each dispatch's device time (CUDA
events) with the parent, the kernel, the kernel and the parent, and the
same dispatch in bfloat16 and float16 (the kernel alone). Needs a CUDA
card and nvcc; prints one line a case and writes
``build/graph_parent_parity.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (ASR_HOP, ASR_WINDOW, DAY_SAMPLES,  # noqa: E402
                        HOUR_SAMPLES, HOP, WINDOW, card_line, event_ms,
                        synthetic_audio)


class OldInterface:
    """A parent library seen through the current launcher: its launch
    symbol takes no dtype code, so the shim drops it (float32 only)."""

    def __init__(self, lib, kernel: str):
        self._lib, self._kernel = lib, kernel

    def __getattr__(self, attr):
        fn = getattr(self._lib, attr)
        if attr != f"{self._kernel}_launch":
            return fn

        def launch(x, dtype, *rest):
            if dtype != 0:
                raise ValueError("the parent takes float32 signals only")
            return fn(x, *rest)
        return launch


def parent_library(kernel: str, source: Path):
    import ctypes

    from repro_torch.kernels import _cuda

    lib = ctypes.CDLL(str(_cuda.build(source).path))
    for sym, (args, res) in _cuda.KERNELS[kernel].signatures.items():
        fn = getattr(lib, sym)
        fn.argtypes = args[:1] + args[2:] if sym.endswith("_launch") \
            else args
        fn.restype = res
    err = getattr(lib, f"{kernel}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return OldInterface(lib, kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bio", type=Path, required=True,
                    help="the parent biosignal_graph.cu")
    ap.add_argument("--asr", type=Path, required=True,
                    help="the parent asr_graph.cu")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.biosignal import make_app, synthetic_respiration
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.pipeline import cuda as pcuda
    from repro_torch.kernels.pipeline.asr import make_asr_frontend
    from repro_torch.kernels.pipeline.graph import (get_graph_factory,
                                                    graph_frames_call,
                                                    graph_ring_call,
                                                    graph_stream_call,
                                                    ring_chunk_samples)
    from repro_torch.serve.stream import frame_signal

    if not torch.cuda.is_available():
        print("graph_parent_parity: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    _cuda.build_all()
    parents = {"biosignal_graph": parent_library("biosignal_graph", args.bio),
               "asr_graph": parent_library("asr_graph", args.asr)}
    real = _cuda.library

    def use(which: str) -> None:
        lib = (lambda k: parents.get(k) or real(k)) if which == "parent" \
            else real
        _cuda.library = pcuda.library = lib

    app = make_app(device=dev)
    asr_app = make_asr_frontend(device=dev)
    sig = synthetic_respiration(1, DAY_SAMPLES, seed=0, device=dev)[0][0]
    audio = synthetic_audio(HOUR_SAMPLES, seed=0, device=dev)
    cases = {}
    for gname, a, x, W, H, B in (("biosignal", app, sig, WINDOW, HOP, 8),
                                 ("asr", asr_app, audio, ASR_WINDOW, ASR_HOP,
                                  32)):
        graph, ops = get_graph_factory(gname)(a)
        span = ring_chunk_samples(W, H, B)
        chunk = x[:span]
        frames = frame_signal(chunk, W, H)
        ring = x[: 3 * B * H + span].as_strided((4, span), (B * H, 1))
        odd = x[1: 1 + 3 * B * (H + 1) + span].as_strided((4, span),
                                                          (B * (H + 1), 1))
        kw = dict(graph=graph)
        cases.update({
            f"{gname} whole, all outputs": lambda x=x, ops=ops, kw=kw, W=W, H=H:
                graph_stream_call(x, ops, window=W, hop=H, **kw),
            f"{gname} stream B={B}": lambda c=chunk, ops=ops, kw=kw, W=W, H=H:
                graph_stream_call(c, ops, window=W, hop=H, **kw),
            f"{gname} frames B={B}": lambda f=frames, ops=ops, kw=kw:
                graph_frames_call(f, ops, **kw),
            f"{gname} ring 4 x B={B}": lambda r=ring, ops=ops, kw=kw, W=W, H=H:
                graph_ring_call(r, ops, window=W, hop=H, **kw),
            f"{gname} ring, odd slot stride": lambda r=odd, ops=ops, kw=kw,
                W=W, H=H: graph_ring_call(r, ops, window=W, hop=H, **kw),
            f"{gname} stream, hop {H + 1}": lambda c=x[: 40 * (H + 1) + W],
                ops=ops, kw=kw, W=W, H=H:
                graph_stream_call(c, ops, window=W, hop=H + 1, **kw),
        })
    report = {"card": card, "cases": {}}
    for name, fn in cases.items():
        use("parent")
        want = fn()
        use("kernel")
        got = fn()
        torch.cuda.synchronize()
        same = all(torch.equal(got[k], want[k]) for k in want)
        row = {"bitwise": same}
        if "whole" not in name and "odd" not in name and "hop" not in name:
            times = []
            for which in ("parent", "kernel", "kernel", "parent"):
                use(which)
                times.append((which, event_ms(fn, 200)))
            use("kernel")
            row["ms"] = times
        report["cases"][name] = row
        print(f"{name}: float32 outputs bitwise the parent's: {same}"
              + ("; device ms " + ", ".join(f"{w} {t:.5f}" for w, t in
                                             row["ms"]) if "ms" in row
                 else "") + f" [{card}]", flush=True)
    use("kernel")
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "graph_parent_parity.json").write_text(json.dumps(report,
                                                             indent=1))
    bad = [k for k, v in report["cases"].items() if not v["bitwise"]]
    if bad:
        print(f"NOT bitwise the parent's: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
