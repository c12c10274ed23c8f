#!/usr/bin/env python3
"""Time the biosignal graph kernel, its variants and its parent side by side on one card.

    python3 tools/biosignal_variants.py [--parent FILE] [--extra NAME=FILE ...]
                                        [--only ROW ...] [--main-path]

``--parent`` is an earlier `csrc/biosignal_graph.cu` with the same C
interface (e.g. ``git show 02c1744:src/repro_torch/kernels/pipeline/csrc/
biosignal_graph.cu > build/parent_bio.cu``); ``--extra`` adds more such
sources under their own names. All sources are built with the port's nvcc
flags and loaded beside each other. In one process, on one card, over
`chip_smoke.py`'s synthetic day (64 Hz, window 2048, hop 512, fft 512, 11
taps), each row runs every variant in turn, the parent first and last and
the kernel again second to last:

  rows:     the main path's 8-frame `stream` and `frames` dispatches and
            its 32-frame ring (4 slots of 8), all with features, margin and
            class; 512 frames (`stream`); the day in one launch, and with
            `+filtered`;
  variants: ``kernel[b]`` (the source at block_frames b, the default
            `BIOSIGNAL_BLOCK_FRAMES` and the others of ``BLOCK_FRAMES``),
            the source with a few lines replaced (`VARIANTS`, at the
            block_frames of `VARIANT_BLOCKS`: frames of one and two warps,
            register caps, the FIR's 11 taps on the generic path or on a
            loop capped at 17, the median by bisection or by the parent's
            histograms, the two medians one after the other, the FFT's
            stages unrolled in place, the tables issued before the first
            frame's wait, loops unrolled, true radix-16 FFT passes; those
            named ``wrong_*`` drop a stage to time the rest), ``parent``
            (at block_frames 1, its default) and ``empty`` (a kernel with
            no body on the default launch's grid: the launch-and-event
            floor).

Each build prints its registers and spills per instantiation (KT: the
FIR's taps exactly, 0 for any count) and the SASS instructions by kind of
the kAppTaps instantiation (the main path's 11 taps). Each line gives the time (CUDA events behind a
device sleep), its ratio to the bound of `chip_smoke.graph_work` (the same
work whatever computes it, on this data's candidates and extrema), max
|diff| from the plain version over the row's floats, the share of rows
whose class agrees and whether `filtered` and `features[:, :6]` are
bitwise the plain version's. Then clock64 stamps of one frame's chain
(`STAMPS`), alone and under load. ``--main-path`` then runs the main
path's windows/s (`BiosignalStream` at batch_windows 8 and 512 without
`filtered`, `ResidentStream` at 8 and 512, ring depth 4) with the parent's
library and the kernel's in turn: parent, kernel, kernel, parent (a
parent whose launcher takes no dtype code, from before the 16-bit signal
path, is timed by rows only). Writes
``build/biosignal_variants/report.json``. Needs a CUDA card and nvcc.
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
SOURCE = ROOT / "src/repro_torch/kernels/pipeline/csrc/biosignal_graph.cu"
ASR_SOURCE = ROOT / "src/repro_torch/kernels/pipeline/csrc/asr_graph.cu"
OUT = ROOT / "build" / "biosignal_variants"
BLOCK_FRAMES = (1, 2, 4)
# block_frames each variant runs at (default: BIOSIGNAL_BLOCK_FRAMES)
VARIANT_BLOCKS = {"t32": (1, 4), "t64": (1, 2), "regs64": (1, 2),
                  "regs80": (1, 2)}

# the median from two (S + 1)-bin histograms of the gaps, as the parent
# took it: cleared, filled by atomics, scanned over contiguous bins
_HIST_MEDIAN = r"""      // ---- 2d: the median from (S + 1)-bin gap histograms
      int* const hist = reinterpret_cast<int*>(
          reinterpret_cast<unsigned char*>(list) +
          align16(2 * (size_t(S) + 4 * kFrameThreads)));
      for (int b = di; b < 2 * (S + 1); b += TD) hist[b] = 0;
      sync_threads<TD>(bar_delin);
      for (int which = 0; which < 2; ++which) {
        const int n = which ? n_min : n_max;
        const uint16_t* const gl = list + which * (S / 2);
        for (int e = di; e < n; e += TD)
          atomicAdd(hist + which * (S + 1) + gl[e], 1);
      }
      sync_threads<TD>(bar_delin);
      {
        const int nb = S + 1, bc = (nb + TD - 1) / TD;
        const int b0 = min(nb, di * bc), b1 = min(nb, b0 + bc);
        int cnt[2] = {0, 0}, tot[2];
        for (int b = b0; b < b1; ++b) {
          cnt[0] += hist[b];
          cnt[1] += hist[nb + b];
        }
        int before[2] = {cnt[0], cnt[1]};
        group_exclusive_scan<TD>(
            before, tot, [](int, int a, int b) { return a + b; },
            [](int) { return 0; }, red_i, &phase, di, bar_delin);
        for (int which = 0; which < 2; ++which) {
          const int n = which ? n_min : n_max;
          const int k = (max(n, 1) - 1) / 2;
          if (n == 0 && di == 0) feats[3 * which + 1] = 0.f;
          if (n > 0 && before[which] <= k && k < before[which] + cnt[which]) {
            int run = before[which];
            for (int b = b0; b < b1; ++b) {
              run += hist[which * nb + b];
              if (run > k) {
                feats[3 * which + 1] = (float)b;
                break;
              }
            }
          }
          if (di == 0) {
            const float nf = (float)max(n, 1);
            feats[3 * which] = __fdiv_rn((float)s1[which], nf);
            feats[3 * which + 2] = sqrtf(__fdiv_rn((float)s2[which], nf));
          }
        }
      }

"""

# a pass of four stages as one radix-16 DFT (asr_graph.cu's, constant
# twiddles inside) times w_n0^(r k), n0 = m >> s0, from twiddle row s0
# (w^j = -w^(j - n0/2) past its half): the same transform, another order
_RADIX16 = r"""    if constexpr (L == 4) {
      float2 z[16];
#pragma unroll
      for (int v = 0; v < 16; ++v) z[v] = make_float2(xr[v], xi[v]);
      dft<16>(z);
      const float2* const row0 = tw + (m - (m >> s0));
      const int h = (m >> s0) / 2;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int j = r * k;
        float2 w = row0[j < h ? j : j - h];
        if (j >= h) w = make_float2(-w.x, -w.y);
        const float2 y = cmul(z[k], w);
        xr[bitrev(k, 4)] = y.x;
        xi[bitrev(k, 4)] = y.y;
      }
    } else {
#pragma unroll
    for (int i = 0; i < L; ++i) {"""


def _asr_dft_helpers() -> str:
    """asr_graph.cu's compile-time loops, complex helpers and dft<R>."""
    text = ASR_SOURCE.read_text()
    start = text.index("// ---- compile-time loops")
    return text[start:text.index("struct Params", start)]


# a group of 32 synchronised by __syncwarp (named barriers past a block's
# 16 ids otherwise), and a delineation warp's own sync where its reduction
# (no shared memory on one warp) no longer publishes the gap lists
_WARP_SYNC = [
    ("""__device__ __forceinline__ void sync_threads(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
}""", """__device__ __forceinline__ void sync_threads(int id) {
  if constexpr (N == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
  }
}"""),
    ("red_i, &phase, di, bar_delin);\n        s1[0] = sums[0];",
     "red_i, &phase, di, bar_delin);\n        sync_threads<TD>(bar_delin);\n"
     "        s1[0] = sums[0];")]

# name -> [(text, replacement)] applied to the kernel's source; those
# marked "wrong" drop a stage to time the rest (their err column is large)
VARIANTS = {
    # a frame on two warps (one delineates, one takes the FFT) and on one
    # (the FFT after the delineation, the frame's reduction published by
    # its own sync)
    "t64": [("constexpr int kFrameThreads = 128;",
             "constexpr int kFrameThreads = 64;"), *_WARP_SYNC],
    "t32": [("constexpr int kFrameThreads = 128;",
             "constexpr int kFrameThreads = 32;"), *_WARP_SYNC,
            ("constexpr int TD = T - kFftThreads;",
             "constexpr int TD = T;"),
            ("        red_all, nullptr, i, bar_all);\n    const float mu",
             "        red_all, nullptr, i, bar_all);\n"
             "    sync_threads<T>(bar_all);\n    const float mu"),
            ("    if (i < TD) {\n      delineate(i);\n    } else {\n"
             "      spectrum(i - TD);\n    }",
             "    delineate(i);\n    spectrum(i);")],
    # every tap count on the generic path (16 history vectors, the taps
    # read through L1), and counts up to 17 on one loop of at most 17 taps
    # held in registers, left after n_taps (4 history vectors)
    "generic_taps": [("p.n_taps == kAppTaps ? launch_kernel",
                      "false ? launch_kernel")],
    "cap17": [("constexpr int kAppTaps = 11;", "constexpr int kAppTaps = 17;"),
              ("    if (KT == 0 && i >= n_taps) break;",
               "    if (i >= n_taps) break;"),
              ("taps[t] = __ldg(p.taps + t);",
               "taps[t] = t < p.n_taps ? __ldg(p.taps + t) : 0.f;"),
              ("p.n_taps == kAppTaps ? launch_kernel",
               "p.n_taps <= kAppTaps ? launch_kernel")],
    # registers capped at 64 (two blocks of 512 threads an SM) and 80
    # (three of 256)
    "regs64": [("__launch_bounds__(kMaxBlockThreads)",
                "__launch_bounds__(kMaxBlockThreads, 2)")],
    "regs80": [("constexpr int kMaxBlockThreads = 512;",
                "constexpr int kMaxBlockThreads = 256;"),
               ("__launch_bounds__(kMaxBlockThreads)",
                "__launch_bounds__(kMaxBlockThreads, 3)")],
    # the median by bisection at every gap count
    "bisect_median": [("constexpr int kRankMax = 64;",
                       "constexpr int kRankMax = 0;")],
    # the median from the parent's two histograms (S + 1 bins each)
    "hist_median": [
        ("         align16(2 * (size_t(S) + 4 * kFrameThreads));",
         "         align16(2 * (size_t(S) + 4 * kFrameThreads)) +\n"
         "         align16(8 * (size_t(S) + 1));"),
        ("#pragma unroll\n      for (int which = 0; which < 2; ++which) {\n"
         "        const int n = which ? n_min : n_max;\n"
         "        const uint16_t* const gl = list + which * (S / 2);\n"
         "        const int k = (max(n, 1) - 1) / 2;\n        // this list's",
         _HIST_MEDIAN + "      for (int which = 0; which < 0; ++which) {\n"
         "        const int n = which ? n_min : n_max;\n"
         "        const uint16_t* const gl = list + which * (S / 2);\n"
         "        const int k = (max(n, 1) - 1) / 2;\n        // this list's")],
    # the two rank-counted medians one after the other, on all the
    # delineation threads
    "serial_medians": [("        const int lead = ranked ? which * half : 0;\n"
                        "        const int step = ranked ? half : TD;",
                        "        const int lead = 0;\n"
                        "        const int step = TD;")],
    # each FFT pass's stages unrolled in place (fully unrolled code: four
    # times the instructions of the constant-geometry loop)
    "fft_unrolled": [(
        "#pragma unroll 1\n    for (int i = 0; i < L; ++i) {\n"
        "      const float2* row = tw + (m - (m >> (s0 + i)));\n"
        "      float yr[E], yi[E];\n#pragma unroll\n"
        "      for (int j = 0; j < H; ++j) {\n"
        "        const float2 w = row[((j >> i) << rb) | r];\n"
        "        const float ar = xr[j], ai = xi[j], br = xr[j + H], "
        "bi = xi[j + H];\n"
        "        const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);\n"
        "        yr[2 * j] = __fadd_rn(ar, br);\n"
        "        yi[2 * j] = __fadd_rn(ai, bi);\n"
        "        yr[2 * j + 1] = __fsub_rn(__fmul_rn(dr, w.x), "
        "__fmul_rn(di, w.y));\n"
        "        yi[2 * j + 1] = __fadd_rn(__fmul_rn(dr, w.y), "
        "__fmul_rn(di, w.x));\n      }\n#pragma unroll\n"
        "      for (int v = 0; v < E; ++v) {\n        xr[v] = yr[v];\n"
        "        xi[v] = yi[v];\n      }\n    }",
        "#pragma unroll\n    for (int i = 0; i < L; ++i) {\n"
        "      const int bit = 1 << (L - 1 - i);\n"
        "      const float2* row = tw + (m - (m >> (s0 + i)));\n"
        "#pragma unroll\n      for (int v = 0; v < E; ++v) {\n"
        "        if (v & bit) continue;\n"
        "        const float2 w = row[((v & (bit - 1)) << rb) | r];\n"
        "        const float ar = xr[v], ai = xi[v], br = xr[v | bit], "
        "bi = xi[v | bit];\n"
        "        const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);\n"
        "        xr[v] = __fadd_rn(ar, br);\n"
        "        xi[v] = __fadd_rn(ai, bi);\n"
        "        xr[v | bit] = __fsub_rn(__fmul_rn(dr, w.x), "
        "__fmul_rn(di, w.y));\n"
        "        xi[v | bit] = __fadd_rn(__fmul_rn(dr, w.y), "
        "__fmul_rn(di, w.x));\n      }\n    }")],
    # the tables' copies issued before the first frame's wait
    "tables_first": [("    copy_async_wait_all();\n    sync_threads<T>(bar_all);\n"
                      "    if (!tables_issued) issue_tables();",
                      "    if (!tables_issued) issue_tables();\n"
                      "    copy_async_wait_all();\n    sync_threads<T>(bar_all);")],
    # the candidate tests two rounds an iteration
    "tests_unroll2": [("      for (int v0 = 0; v0 < nv; v0 += TD) {",
                       "#pragma unroll 2\n      for (int v0 = 0; v0 < nv; "
                       "v0 += TD) {")],
    # the untangle's loop unrolled by 3 (0.4 us slower at 8 frames)
    "untangle_unrolled": [("      for (int k = l; k <= m; k += kFftThreads)",
                           "#pragma unroll 3\n      for (int k = l; k <= m; "
                           "k += kFftThreads)")],
    # true radix-16 passes (not bitwise the plain chain)
    "radix16": [
        ("#include <stdint.h>\n", "#include <stdint.h>\n\n#include <utility>\n"),
        ("namespace {\n", "namespace {\n" + "@@DFT@@"),
        ("#pragma unroll 1\n    for (int i = 0; i < L; ++i) {", _RADIX16),
        ("      }\n    }\n#pragma unroll\n    for (int v = 0; v < E; ++v)\n"
         "      store(", "      }\n    }\n    }\n#pragma unroll\n    for (int "
         "v = 0; v < E; ++v)\n      store(")],
    # wrong: no refractory window (every candidate kept)
    "wrong_no_window": [("          for (int j0 = a; j0 <= b; j0 += 16) {",
                         "          for (int j0 = a; j0 < a; j0 += 16) {")],
    # wrong: no FFT passes
    "wrong_no_fft": [("for (int s0 = 0; s0 < M; s0 += 4, ++n_pass)",
                      "for (int s0 = M; s0 < M; s0 += 4, ++n_pass)")],
    # wrong: the FIR and its writes alone
    "wrong_fir_only": [("    if (!need_features) {           // uniform",
                        "    if (true) {           // uniform")],
}
# the kernel with clock64 stamps of its first frame in block (0, 0), taken
# by thread 0 (kernel and delineation) and by the first thread of the FFT
# warp (spectrum): where one frame's chain spends its cycles, alone
# (8 frames) and under load (the day). `STAMPS` names the intervals
# between stamps (a, b).
STAMPS = {"setup": (0, 1), "stage the frame": (1, 2), "FIR + reduce": (2, 3),
          "tests": (3, 4), "windows": (4, 5), "gaps": (5, 6),
          "median": (6, 7), "wait for the spectrum": (7, 8),
          "SVM + frame end": (8, 9), "to the FFT warp": (3, 10),
          "FFT": (10, 11), "untangle + bands": (11, 12)}
_STAMP = ("if ({who} && blockIdx.x == 0 && blockIdx.y == 0) "
          "asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(g_stamps[{k}]) "
          ":: \"memory\");\n")
_T0, _FFT0 = "threadIdx.x == 0", "l == 0 && threadIdx.x < T"
STAMPED = ("kernel",)
STAMP_SUBS = [
    ("namespace {\n", "namespace {\n__device__ long long g_stamps[16];\n")] + [
    (marker, _STAMP.format(k=k, who=who) + marker)
    for k, (who, marker) in enumerate((
        (_T0, "  const int G = p.groups;\n"),
        (_T0, "    // ---- stage 1: the frame to shared memory"),
        (_T0, "    // ---- the FIR from registers"),
        (_T0, "    const float mu = __fdiv_rn(red4[0], (float)S);"),
        (_T0, "      // ---- 2b:"),
        (_T0, "      // ---- 2c:"),
        (_T0, "      // ---- 2d:"),
        (_T0, "    };\n\n    // ---- stage 3: the packed FFT"),
        (_T0, "    if ((p.flags & kOutFeatures) && i < kFeatures)"),
        (_T0, "    sync_threads<T>(bar_all);   // the region and scratch"),
        (_FFT0, "      tables_wait(&tables_bar);\n      const int fft_threads"),
        (_FFT0, "      // untangle:"),
        (_FFT0, "    };\n\n    if (i < TD) {")))] + [
    ('extern "C" {\n', 'extern "C" {\n\nint biosignal_graph_stamps(long long* '
     'out) {\n  return (int)cudaMemcpyFromSymbol(out, g_stamps, '
     'sizeof(g_stamps));\n}\n')]
EMPTY = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int bx, int by, int threads, void* stream) {
  empty_kernel<<<dim3(bx, by), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def variant_sources() -> dict:
    """{name: CUDA source} of the kernel and every variant."""
    text = SOURCE.read_text()
    sources = {"kernel": text}
    for name, subs in VARIANTS.items():
        v = text
        for old, new in subs:
            if old not in v:
                raise ValueError(f"{name}: {old!r} is not in the source")
            v = v.replace(old, new, 1)
        sources[name] = v.replace("@@DFT@@", _asr_dft_helpers())
    return sources


def takes_dtype(text: str) -> bool:
    """Whether a source's launcher takes the signal's dtype code after x
    (sources before the 16-bit signal path do not)."""
    return "const void* x, int dtype" in text


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
    regs = []
    for part in log.split("Compiling entry function")[1:]:
        m = re.match(r" '\w*biosignal_graph_kernel(?:ILi(\d+)E)?", part)
        sp = re.search(r"(\d+) bytes spill stores", part)
        r = re.search(r"Used (\d+) registers", part)
        if m and sp and r:
            regs.append((m.group(1) or "-", sp.group(1), r.group(1)))
    print(f"built {name}: (KT, spill bytes, registers) "
          + " ".join(f"{kt}/{sp}/{r}" for kt, sp, r in regs)
          + sass_counts(lib, text), flush=True)
    return lib


def sass_counts(lib: Path, text: str) -> str:
    """Instructions by kind of the kAppTaps instantiation (the main path's
    11 taps), from cuobjdump -sass (static: loops counted once); the
    listing goes to ``build/biosignal_variants/<name>.sass``."""
    from repro_torch.kernels import _cuda

    tool = Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    app = re.search(r"constexpr int kAppTaps = (\d+);", text)
    body = None
    for name in ([rf"\w*biosignal_graph_kernelILi{app.group(1)}E\w*"]
                 if app else []) + [r"\w*biosignal_graph_kernel\w*"]:
        body = body or re.search(rf"Function : {name}\n([\s\S]*?)"
                                 r"(?:\n\s*Function :|\Z)", sass)
    if body is None:
        return ""
    (OUT / f"{lib.stem[3:]}.sass").write_text(body.group(1))
    ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     body.group(1))
    kinds = {}
    for op in ops:
        kind = ("fp32" if op in ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP",
                                 "FSEL") else
                "shared" if op in ("LDS", "STS", "ATOMS", "LDGSTS") else
                "global" if op in ("LDG", "STG", "RED", "ATOMG") else
                "warp" if op in ("SHFL", "VOTE", "WARPSYNC", "BAR", "BSSY",
                                 "BSYNC") else "other")
        kinds[kind] = kinds.get(kind, 0) + 1
    return f"; 11-tap SASS: {len(ops)} instructions {kinds}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="an earlier biosignal_graph.cu, timed first and last")
    ap.add_argument("--extra", nargs="+", default=[], metavar="NAME=FILE",
                    help="more sources with the same C interface, timed at "
                         "the default block_frames")
    ap.add_argument("--only", nargs="+", help="rows to run (default all)")
    ap.add_argument("--main-path", action="store_true",
                    help="also the main path's windows/s, parent and kernel "
                         "in turn (needs --parent)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("biosignal_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import (DAY_SAMPLES, HOP, WINDOW, bound_ms, card_line,
                            event_ms, extremum_counts, graph_work)
    from repro_torch.core.biosignal import (MIN_DISTANCE, MIN_PROMINENCE,
                                            band_edges, make_app,
                                            synthetic_respiration)
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.pipeline import cuda as pcuda
    from repro_torch.kernels.pipeline.graph import (get_graph_factory,
                                                    graph_stream_plain,
                                                    ring_chunk_samples,
                                                    stream_frame_count)
    from repro_torch.kernels.pipeline.kernel import BIOSIGNAL_BLOCK_FRAMES
    from repro_torch.serve.resident import ResidentConfig, ResidentStream
    from repro_torch.serve.stream import (BiosignalStream, StreamConfig,
                                          frame_signal)

    sources = {**variant_sources(), "empty": EMPTY}
    for name in STAMPED:
        stamped = sources[name]
        for old, new in STAMP_SUBS:
            if old not in stamped:
                raise ValueError(f"stamps: {old!r} is not in the source")
            stamped = stamped.replace(old, new, 1)
        sources[f"stamps_{name}"] = stamped
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    extra = dict(e.split("=", 1) for e in args.extra)
    sources.update({n: Path(f).read_text() for n, f in extra.items()})
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources, sources.values())))
    sig_spec = _cuda.KERNELS["biosignal_graph"].signatures
    handles, kerns = {}, {}
    for name in libs:
        if name == "empty" or name.startswith("stamps_"):
            continue
        handles[name] = ctypes.CDLL(str(libs[name]))
        kerns[name] = handles[name].biosignal_graph_launch
        argtypes, restype = sig_spec["biosignal_graph_launch"]
        if not takes_dtype(sources[name]):
            argtypes = argtypes[:1] + argtypes[2:]
        kerns[name].argtypes, kerns[name].restype = argtypes, restype
    empty = ctypes.CDLL(str(libs["empty"])).empty_launch
    empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p]
    empty.restype = ctypes.c_int

    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    app = make_app(device=dev)
    graph, ops = get_graph_factory("biosignal")(app)
    taps, wr, wi, u, w, b = ops
    C = w.shape[1]
    bands = (ctypes.c_int * 7)(*(int(e) for e in band_edges(app.fft_size)))
    sig = synthetic_respiration(1, DAY_SAMPLES, seed=0, device=dev)[0][0]
    n_day = stream_frame_count(DAY_SAMPLES, WINDOW, HOP)
    span8 = ring_chunk_samples(WINDOW, HOP, 8)
    chunk8 = sig[:span8]
    frames8 = frame_signal(chunk8, WINDOW, HOP)
    ring = sig[: 3 * 8 * HOP + span8].as_strided((4, span8), (8 * HOP, 1))
    chunk512 = sig[: ring_chunk_samples(WINDOW, HOP, 512)]
    feat, both = ("features", "margin", "class"), \
        ("filtered", "features", "margin", "class")
    # row: (x, n_slots, n_frames, frame_stride, slot_stride, outputs,
    #       input samples, reps)
    rows = {
        "stream 8": (chunk8, 1, 8, HOP, 0, feat, chunk8.numel(), 200),
        "frames 8": (frames8, 1, 8, WINDOW, 0, feat, frames8.numel(), 200),
        "ring 32": (ring, 4, 8, HOP, 8 * HOP, feat,
                    3 * 8 * HOP + span8, 200),
        "stream 512": (chunk512, 1, 512, HOP, 0, feat, chunk512.numel(),
                       100),
        "day": (sig, 1, n_day, HOP, 0, feat, sig.numel(), 10),
        "day +filtered": (sig, 1, n_day, HOP, 0, both, sig.numel(), 10),
    }

    # the plain version over the day, in slices; the rows' frames are its
    # first frames (the ring's slots are frames 0-31 too)
    plain = {o: [] for o in both}
    for f0 in range(0, n_day, 2048):
        f1 = min(n_day, f0 + 2048)
        res = graph_stream_plain(sig[f0 * HOP:(f1 - 1) * HOP + WINDOW], ops,
                                 graph=graph, window=WINDOW, hop=HOP)
        for o in both:
            plain[o].append(res[o])
    plain = {o: torch.cat(v) for o, v in plain.items()}
    cand, ext = extremum_counts(plain["filtered"])
    cand_cum = torch.cat([cand.new_zeros(1), cand.cumsum(0)]).tolist()
    ext_cum = torch.cat([ext.new_zeros(1), ext.cumsum(0)]).tolist()

    def call(name: str, blk: int, x, n_slots, n_frames, frame_stride,
             slot_stride, outputs):
        rows_ = n_slots * n_frames
        out = {"filtered": torch.empty(rows_, WINDOW, device=dev),
               "features": torch.empty(rows_, 12, device=dev),
               "margin": torch.empty(rows_, C, device=dev),
               "class": torch.empty(rows_, dtype=torch.int32, device=dev)}
        out = {k: v for k, v in out.items() if k in outputs}
        flags = sum(pcuda.OUT_BITS["biosignal_graph"][k] for k in out)
        st = torch.cuda.current_stream().cuda_stream
        if name == "empty":
            err = empty(-(-n_frames // blk), n_slots, 32, st)
        else:
            kern = kerns[name]
            dtype = (0,) if takes_dtype(sources[name]) else ()
            err = kern(x.data_ptr(), *dtype, slot_stride, frame_stride,
                       n_slots, n_frames, WINDOW, blk, taps.data_ptr(), taps.shape[0],
                       wr.data_ptr(), wi.data_ptr(), u.data_ptr(),
                       app.fft_size, w.data_ptr(), b.data_ptr(), 12, C,
                       bands, MIN_PROMINENCE, MIN_DISTANCE,
                       *(out[k].data_ptr() if k in out else None
                         for k in ("filtered", "features", "margin",
                                   "class")),
                       None, rows_, flags, st)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return out

    default = BIOSIGNAL_BLOCK_FRAMES
    runs = ([("parent", 1)] if "parent" in kerns else []) + \
        [("kernel", default)] + \
        [("kernel", blk) for blk in BLOCK_FRAMES if blk != default] + \
        [(name, blk) for name in (*VARIANTS, *extra, "empty", "kernel")
         for blk in VARIANT_BLOCKS.get(name, (default,))] + \
        ([("parent", 1)] if "parent" in kerns else [])
    report = {"card": card, "rows": {}}
    for tag, (x, ns, nf, fs, ss, outputs, nin, reps) in rows.items():
        if args.only and tag not in args.only:
            continue
        # the day's first frames (ring slot r holds frames 8r .. 8r + 7)
        want = {o: plain[o][:ns * nf] for o in outputs}
        nbytes, ops_ = graph_work(ns * nf, nin, outputs, cand_cum[ns * nf],
                                  ext_cum[ns * nf])
        bms, by = bound_ms(nbytes, ops_)
        line = f"{tag}: {ns * nf} frames, bound {bms:.6f} ms ({by})"
        report["rows"][tag] = {"frames": ns * nf, "bound_ms": bms,
                               "bound_by": by, "runs": []}
        for name, blk in runs:
            ms = event_ms(lambda: call(name, blk, x, ns, nf, fs, ss,
                                       outputs), reps)
            entry = {"name": name, "block_frames": blk, "ms": ms,
                     "x_bound": ms / bms}
            line += f" | {name}[{blk}] {ms:.4f} ms ({ms / bms:.1f}x bound"
            if name != "empty":
                got = call(name, blk, x, ns, nf, fs, ss, outputs)
                err = max(float((got[k] - want[k]).abs().max())
                          for k in ("features", "margin"))
                agree = float((got["class"] == want["class"]).float().mean())
                six = bool(torch.equal(got["features"][:, :6],
                                       want["features"][:, :6]))
                entry.update(max_abs_err=err, class_agreement=agree,
                             features6_bitwise=six)
                line += (f", err {err:.2e}, class {agree:.6f}, features[:6] "
                         + ("bitwise" if six else "DIFFER"))
                if "filtered" in outputs:
                    same = bool(torch.equal(got["filtered"],
                                            want["filtered"]))
                    entry["filtered_bitwise"] = same
                    line += ", filtered " + ("bitwise" if same else
                                             "DIFFERS")
                del got
            line += ")"
            report["rows"][tag]["runs"].append(entry)
        print(line, flush=True)

    # one frame's chain, stage by stage (clock64 cycles of the first frame
    # of block (0, 0), at the default block_frames)
    report["stamps"] = {}
    for name in STAMPED:
        stamp_lib = ctypes.CDLL(str(libs[f"stamps_{name}"]))
        kerns["stamps"] = stamp_lib.biosignal_graph_launch
        kerns["stamps"].argtypes, kerns["stamps"].restype = \
            sig_spec["biosignal_graph_launch"]
        read = stamp_lib.biosignal_graph_stamps
        read.argtypes, read.restype = [ctypes.c_void_p], ctypes.c_int
        for tag, blk in (("stream 8", 1), ("stream 8", default),
                         ("day", default)):
            x, ns, nf, fs, ss, outputs, _, _ = rows[tag]
            cycles = []
            for _ in range(5):
                call("stamps", blk, x, ns, nf, fs, ss, outputs)
                torch.cuda.synchronize()
                buf = (ctypes.c_longlong * 16)()
                if read(buf):
                    raise RuntimeError("stamps: copy failed")
                cycles.append([buf[b] - buf[a]
                               for a, b in STAMPS.values()])
            med = [sorted(c[k] for c in cycles)[2]
                   for k in range(len(STAMPS))]
            report["stamps"][f"{name}[{blk}] {tag}"] = dict(zip(STAMPS, med))
            print(f"stamps {name}[{blk}] {tag} (median of 5, cycles): " + ", ".join(
                f"{n} {c}" for n, c in zip(STAMPS, med))
                + f"; kernel start to frame end {med[0] + sum(med[1:9])} "
                f"[{card}]", flush=True)

    if args.main_path and "parent" in handles and \
            takes_dtype(sources["parent"]):
        # the port's launcher with the parent's library or the kernel's
        real = _cuda.library

        def use(name: str) -> None:
            lib = handles[name]
            sub = (lambda k: lib if k == "biosignal_graph" else real(k))
            _cuda.library = pcuda.library = sub

        main_rows = {}
        for B in (8, 512):
            cfg = StreamConfig(window=WINDOW, hop=HOP, batch_windows=B,
                               outputs=feat)
            main_rows[f"stream B={B}"] = BiosignalStream(app, cfg)
            main_rows[f"resident B={B}"] = ResidentStream(
                app, cfg, ResidentConfig(ring_depth=4, drain_interval=4))
        report["main_path"] = {}
        for tag, runner in main_rows.items():
            rates = []
            for name in ("parent", "kernel", "kernel", "parent"):
                use(name)
                runner.process(sig)               # warm
                torch.cuda.synchronize()
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                runner.process(sig)
                t1.record()
                t1.synchronize()
                rates.append((name, n_day / (t0.elapsed_time(t1) / 1e3)))
            _cuda.library = pcuda.library = real
            report["main_path"][tag] = rates
            print(f"main path {tag}: " + ", ".join(
                f"{nm} {r:.0f}" for nm, r in rates) + f" windows/s [{card}]",
                flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
