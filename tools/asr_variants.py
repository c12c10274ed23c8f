#!/usr/bin/env python3
"""Time the ASR graph kernel, its variants and its parent side by side on one card.

    python3 tools/asr_variants.py [--parent FILE] [--only NAME ...]

``--parent`` is an earlier `csrc/asr_graph.cu` with the dense-mel C
interface (radix-2 twiddle planes and the dense mel_w, e.g. ``git show
9048aa1:src/repro_torch/kernels/pipeline/csrc/asr_graph.cu >
build/parent_asr.cu``). All sources are built with the port's nvcc flags
and loaded beside each other. In one process, on one card, over
`chip_smoke.py`'s synthetic hour of 16 kHz audio (window 512, hop 160,
fft 512, 64 mels), each row runs every variant in turn, the parent first
and last and the kernel again second to last:

  rows:     32-frame `stream` and `frames` dispatches, the 128-frame ring
            (4 slots of 32), the hour in one launch with `logmel` and
            with `+filtered`;
  variants: ``kernel[b]`` (the source at block_frames b, the default
            `ASR_BLOCK_FRAMES` and the others of ``BLOCK_FRAMES``),
            ``dense_mel`` (the same kernel given a span table that covers
            every bin of every column: the dense product), the source with
            a few lines replaced (`VARIANTS`; those named ``wrong_*`` drop a
            stage, to time the rest), ``parent`` and ``empty`` (a kernel
            with no body on the default launch's grid: the launch-and-event
            floor).

Each build prints its registers and spills per instantiation and the
SASS instruction count of the fft 512 one by kind. Each line gives the
time (CUDA events behind a device sleep), its ratio to
the bound of `chip_smoke.asr_graph_work` (the same work whatever computes
it), max |logmel - plain| over every row and, with `filtered`, whether it
is bitwise the plain version's. Writes ``build/asr_variants/report.json``.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/pipeline/csrc/asr_graph.cu"
OUT = ROOT / "build" / "asr_variants"
BLOCK_FRAMES = (1, 2, 4, 8, 16)
# name -> [(text, replacement)] applied to the kernel's source; those
# marked "wrong" drop a stage to time the rest (their err column is large)
VARIANTS = {
    # registers capped at 64 (two blocks of 512 threads an SM): twice the
    # warps an SM holds, but the batched loads spill
    "regs_64": [("__launch_bounds__(kMaxThreads)",
                 "__launch_bounds__(kMaxThreads, LG <= 9 ? 2 : 1)")],
    # the FFT segment's FIR loads in one batch of 8 vectors, not two of 4
    "in_batch_8": [("constexpr int kInBatch = 4;", "constexpr int kInBatch = 8;")],
    # the in-stage's bounds-checked path for every frame (the one unaligned
    # frames take)
    "in_checked": [("const bool fast = n_taps == 2 &&",
                    "const bool fast = false &&")],
    # the span table read from global memory, never copied to shared
    "spans_global": [("const bool staged = want_mel && stage_words(n_mels, "
                      "p.n_packed) > 0;", "const bool staged = false;")],
    # wrong: no mel sums (log1p(0) written)
    "wrong_no_mel": [("for (int s = 0; s < n; ++s)",
                      "for (int s = 0; s < 0; ++s)")],
    # wrong: no FFT passes
    "wrong_no_fft": [("static_for<n_passes(LG)>([&](auto pp) {",
                      "static_for<0>([&](auto pp) {")],
    # wrong: no untangle (the mel sums read the raw spectrum)
    "wrong_no_untangle": [("      float pk[U], pc[U], pmid = 0.f;\n"
                           "      static_for<U>(",
                           "      float pk[U], pc[U], pmid = 0.f;\n"
                           "      if (false) static_for<U>(")],
}
# wrong: the FIR and Hann alone (no FFT, untangle or mel sums)
VARIANTS["wrong_in_only"] = [sub for name in ("wrong_no_mel", "wrong_no_fft",
                                              "wrong_no_untangle")
                             for sub in VARIANTS[name]]
EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int bx, int by, int threads, void* stream) {
  empty_kernel<<<dim3(bx, by), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def build(name: str, text: str) -> Path:
    from repro_torch.kernels import _cuda

    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}"
                           f"{proc.stderr}")
    log = proc.stdout + proc.stderr
    regs = re.findall(r"Compiling entry function '\w*ILi(\d+)E\w*'[\s\S]*?"
                      r"(\d+) bytes spill stores[\s\S]*?Used (\d+) "
                      r"registers", log)
    print(f"built {name}: (log2 m, spill bytes, registers) "
          + " ".join(f"{lg}/{sp}/{r}" for lg, sp, r in regs)
          + sass_counts(lib), flush=True)
    return lib


def sass_counts(lib: Path) -> str:
    """Instructions of the fft 512 instantiation (log2 m = 8) by kind, from
    cuobjdump -sass: what a thread issues for one frame, loops but the mel
    sums unrolled."""
    from repro_torch.kernels import _cuda

    tool = Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    body = re.search(r"Function : \w*asr_graph_kernelILi8E\w*\n([\s\S]*?)"
                     r"(?:\n\s*Function :|\Z)", sass)
    if body is None:
        return ""
    (OUT / f"{lib.stem[3:]}_fft512.sass").write_text(body.group(1))
    ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     body.group(1))
    kinds = {}
    for op in ops:
        kind = ("fp32" if op in ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP",
                                 "FSEL") else
                "shared" if op in ("LDS", "STS") else
                "global" if op in ("LDG", "STG", "CCTL") else
                "sync" if op in ("BAR", "WARPSYNC", "BSSY", "BSYNC") else
                "other")
        kinds[kind] = kinds.get(kind, 0) + 1
    return f"; fft 512 SASS: {len(ops)} instructions " + str(kinds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="the dense-mel asr_graph.cu, timed first and last")
    ap.add_argument("--only", nargs="+", help="rows to run (default all)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("asr_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import (ASR_HOP, ASR_WINDOW, HOUR_SAMPLES, asr_graph_work,
                            bound_ms, card_line, synthetic_audio)
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fft.kernel import device_stockham_table
    from repro_torch.kernels.pipeline.asr import (ASR_BLOCK_FRAMES, MelSpans,
                                                  make_asr_frontend,
                                                  mel_spans)
    from repro_torch.kernels.pipeline.graph import (get_graph_factory,
                                                    graph_frames_plain,
                                                    graph_ring_plain,
                                                    graph_stream_plain,
                                                    ring_chunk_samples,
                                                    stream_frame_count)

    text = SOURCE.read_text()
    sources = {"kernel": text, "empty": EMPTY}
    for name, subs in VARIANTS.items():
        v = text
        for old, new in subs:
            if old not in v:
                raise ValueError(f"{name}: {old!r} is not in the source")
            v = v.replace(old, new)
        sources[name] = v
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources, sources.values())))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    kerns = {}
    for name in ("kernel", *VARIANTS):
        kerns[name] = ctypes.CDLL(str(libs[name])).asr_graph_launch
        kerns[name].argtypes, kerns[name].restype = \
            _cuda.KERNELS["asr_graph"].signatures["asr_graph_launch"]
    empty = ctypes.CDLL(str(libs["empty"])).empty_launch
    empty.argtypes, empty.restype = [i, i, i, p], i
    parent = None
    if "parent" in libs:
        parent = ctypes.CDLL(str(libs["parent"])).asr_graph_launch
        parent.argtypes = [p, ll, ll, i, i, i, i, p, i, p, p, p, p, i, p, i,
                           p, p, p, i, i, p]
        parent.restype = i

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    W, H = ASR_WINDOW, ASR_HOP
    app = make_asr_frontend(device=dev)
    graph, ops = get_graph_factory("asr")(app)
    taps, hann, wr, wi, u, mel_w = ops
    m, n_mels = app.fft_size // 2, app.n_mels
    tw = device_stockham_table(m, dev)
    spans = mel_spans(mel_w)
    dense = MelSpans(torch.zeros(n_mels, dtype=torch.int32, device=dev),
                     torch.arange(n_mels + 1, dtype=torch.int32,
                                  device=dev) * (m + 1),
                     mel_w.t().contiguous().flatten())
    mel_nnz = int((mel_w != 0).sum())
    audio = synthetic_audio(HOUR_SAMPLES, seed=0, device=dev)
    na = stream_frame_count(HOUR_SAMPLES, W, H)
    span32 = ring_chunk_samples(W, H, 32)
    chunk32 = audio[:span32]
    frames32 = chunk32.unfold(0, W, H).contiguous()
    ring = audio[: 3 * 32 * H + span32].as_strided((4, span32), (32 * H, 1))
    mel, both = ("logmel",), ("filtered", "logmel")
    # row: (x, n_slots, n_frames, frame_stride, slot_stride, outputs,
    #       input samples, reps)
    rows = {
        "stream 32": (chunk32, 1, 32, H, 0, mel, chunk32.numel(), 200),
        "frames 32": (frames32, 1, 32, W, 0, mel, frames32.numel(), 200),
        "ring 128": (ring, 4, 32, H, 32 * H, mel, 3 * 32 * H + span32, 200),
        "hour": (audio, 1, na, H, 0, mel, audio.numel(), 10),
        "hour +filtered": (audio, 1, na, H, 0, both, audio.numel(), 10),
    }

    def hour_plain(outputs) -> dict:
        """The plain version over the hour, in slices of frames."""
        got = {o: [] for o in outputs}
        for f0 in range(0, na, 8192):
            f1 = min(na, f0 + 8192)
            res = graph_stream_plain(audio[f0 * H:(f1 - 1) * H + W], ops,
                                     graph=graph, window=W, hop=H,
                                     outputs=outputs)
            for o in outputs:
                got[o].append(res[o])
        return {o: torch.cat(v) for o, v in got.items()}

    plain = {
        "stream 32": lambda: graph_stream_plain(chunk32, ops, graph=graph,
                                                window=W, hop=H, outputs=mel),
        "frames 32": lambda: graph_frames_plain(frames32, ops, graph=graph,
                                                outputs=mel),
        "ring 128": lambda: {o: v.flatten(0, 1) for o, v in graph_ring_plain(
            ring, ops, graph=graph, window=W, hop=H, outputs=mel).items()},
        "hour": lambda: hour_plain(mel),
        "hour +filtered": lambda: hour_plain(both),
    }

    def call(name: str, b: int, x, n_slots, n_frames, frame_stride,
             slot_stride, outputs):
        rows_ = n_slots * n_frames
        out = {"filtered": torch.empty(rows_, W, device=dev)
               if "filtered" in outputs else None,
               "logmel": torch.empty(rows_, n_mels, device=dev)}
        flags = ("filtered" in outputs) | 2 * ("logmel" in outputs)
        st = torch.cuda.current_stream().cuda_stream
        fp = None if out["filtered"] is None else out["filtered"].data_ptr()
        if name == "empty":
            err = empty(-(-n_frames // b), n_slots, 32, st)
        elif name == "parent":
            err = parent(x.data_ptr(), slot_stride, frame_stride, n_slots,
                         n_frames, W, b, taps.data_ptr(), taps.shape[0],
                         hann.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                         u.data_ptr(), app.fft_size, mel_w.data_ptr(),
                         n_mels, fp, out["logmel"].data_ptr(), None, rows_,
                         flags, st)
        else:
            sp = dense if name == "dense_mel" else spans
            kern = kerns["kernel" if name == "dense_mel" else name]
            err = kern(x.data_ptr(), 0, slot_stride, frame_stride, n_slots,
                       n_frames, W, b, taps.data_ptr(), taps.shape[0],
                       hann.data_ptr(), tw.data_ptr(), u.data_ptr(),
                       app.fft_size, sp.first.data_ptr(),
                       sp.offset.data_ptr(), sp.weights.data_ptr(),
                       sp.weights.shape[0], n_mels,
                       fp, out["logmel"].data_ptr(), None, rows_, flags, st)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return out

    def event_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e9 * 0.02))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    runs = ([("parent", 8)] if parent else []) + \
        [("kernel", ASR_BLOCK_FRAMES)] + \
        [("kernel", b) for b in BLOCK_FRAMES if b != ASR_BLOCK_FRAMES] + \
        [(name, ASR_BLOCK_FRAMES) for name in ("dense_mel", *VARIANTS,
                                                "empty", "kernel")] + \
        ([("parent", 8)] if parent else [])
    report = {"card": card, "mel_nnz": mel_nnz, "rows": {}}
    for tag, (x, ns, nf, fs, ss, outputs, nin, reps) in rows.items():
        if args.only and tag not in args.only:
            continue
        want = plain[tag]()
        bms, by = bound_ms(*asr_graph_work(ns * nf, nin, outputs, mel_nnz))
        line = f"{tag}: {ns * nf} frames, bound {bms:.6f} ms ({by})"
        report["rows"][tag] = {"frames": ns * nf, "bound_ms": bms,
                               "bound_by": by, "runs": []}
        for name, b in runs:
            ms = event_ms(lambda: call(name, b, x, ns, nf, fs, ss, outputs),
                          reps)
            entry = {"name": name, "block_frames": b, "ms": ms,
                     "x_bound": ms / bms}
            line += f" | {name}[{b}] {ms:.4f} ms ({ms / bms:.1f}x bound"
            if name != "empty":
                got = call(name, b, x, ns, nf, fs, ss, outputs)
                err = float((got["logmel"] - want["logmel"]).abs().max())
                entry["max_abs_err"] = err
                line += f", err {err:.2e}"
                if "filtered" in outputs:
                    same = bool(torch.equal(got["filtered"],
                                            want["filtered"]))
                    entry["filtered_bitwise"] = same
                    line += ", filtered " + ("bitwise" if same else "DIFFERS")
                del got
            line += ")"
            report["rows"][tag]["runs"].append(entry)
        print(line, flush=True)
        del want
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
