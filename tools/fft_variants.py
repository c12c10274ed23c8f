#!/usr/bin/env python3
"""Time the FFT kernel, its variants and its parent side by side on one card.

    python3 tools/fft_variants.py [--parent FILE]
    python3 tools/fft_variants.py --four-step [--only NAME ...]

Each variant is `csrc/fft.cu` with a few lines replaced; ``--parent`` is
another version of the file with the radix-2 kernel's C interface (e.g.
``git show 9c05792:src/repro_torch/kernels/fft/csrc/fft.cu >
build/parent_fft.cu``). All are built with the port's nvcc flags and
loaded beside each other. In one process, on one card, the FFT at
`asr_staged`'s shape (359,997 x 256, float32 and bfloat16) and at
`pipeline_staged`'s (10,797 x 256) runs through every variant and block
size in turn (the parent first and last where given, the kernel also
second to last), beside `torch.fft.fft` (float32 only), CUDA events
behind a device sleep, and beside a copy of the same bytes (`clone` of
both planes: what the card's memory sustains for this traffic). Each line
gives the time, its ratio to the byte bound and to `torch.fft.fft`, and
the max |diff| / max |plain| against the plain version. Needs a CUDA card
and nvcc.

``--four-step`` times the four-step transform instead (N past 8192), the
kernel and `FOUR_STEP_VARIANTS` (the tile's lines, a block's least
points, the largest cluster, the global cache policy: source patches,
with the host plan's constants set to match) in turns, kernel first and
last, over one 2^20 row, 64 rows of 2^20 and one 2^24 row in float32
(and 64 rows of 2^20 in bfloat16), beside `torch.fft.fft` and a `clone`
of the planes, each with its bytes bound (the planes read and written
once) and max |diff| / max |plain|.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/fft/csrc/fft.cu"
OUT = ROOT / "build" / "fft_variants"
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3
CASES = [("asr_staged", 359_997, 256), ("pipeline_staged", 10_797, 256)]
BLOCK_ROWS = (4, 16, 32)                # beside the default (8 at N 256)
# name -> [(text, replacement)] applied to the source
VARIANTS = {
    "kernel": [],
    # global loads and stores through the default cache policy
    "cached": [("__ldcs(reinterpret_cast<const V*>(p))",
                "*reinterpret_cast<const V*>(p)"),
               ("__stcs(reinterpret_cast<V*>(p), raw);",
                "*reinterpret_cast<V*>(p) = raw;")],
}

# name -> ([(text, replacement)], {host constant: value}) past 8192 points
FOUR_STEP_VARIANTS = {
    "kernel": ([], {}),
    # 32 lines a tile: 128-byte runs of float32, 64 of a 16-bit type
    "lines32": ([("constexpr int kFourStepLines = 16;",
                  "constexpr int kFourStepLines = 32;")],
                {"FOUR_STEP_LINES": 32}),
    # blocks of at least 8192 points: half the clusters' blocks
    "block8192": ([("constexpr int kFourStepBlockPoints = 4096;",
                    "constexpr int kFourStepBlockPoints = 8192;")],
                  {"FOUR_STEP_BLOCK_POINTS": 8192}),
    # clusters of at most 2 blocks: longer sub-lines in each block
    "cluster2": ([("constexpr int kMaxCluster = 8;",
                   "constexpr int kMaxCluster = 2;")], {"MAX_CLUSTER": 2}),
    # no cluster: a tile in one block where it fits (to 1024 points a line)
    "cluster1": ([("constexpr int kMaxCluster = 8;",
                   "constexpr int kMaxCluster = 1;")], {"MAX_CLUSTER": 1}),
    # 8 lines a tile: 32-byte runs of float32, 16 of a 16-bit type
    "lines8": ([("constexpr int kFourStepLines = 16;",
                 "constexpr int kFourStepLines = 8;")],
               {"FOUR_STEP_LINES": 8}),
    # blocks of at least 2048 points: clusters twice as wide
    "block2048": ([("constexpr int kFourStepBlockPoints = 4096;",
                    "constexpr int kFourStepBlockPoints = 2048;")],
                  {"FOUR_STEP_BLOCK_POINTS": 2048}),
    # wrong on purpose: each share stored in the block's own shared memory,
    # not its owner's (what the cluster's exchange costs)
    "wrong_no_exchange": ([("          yr = cg::this_cluster().map_shared_rank(yr, jj);\n"
                            "          yi = cg::this_cluster().map_shared_rank(yi, jj);\n",
                            "")], {}),
    # the tiles of a row in bit-reversed order: clusters running at once
    # take columns far apart (a power-of-2 row pitch maps a band of
    # neighbouring columns onto few memory channels)
    "tile_reverse": ([("  const int c0 = static_cast<int>(tile & ((1LL << lg_tiles) - 1)) << LC;",
                       "  const int c0 = static_cast<int>(__brev(static_cast<unsigned>(\n"
                       "      tile & ((1LL << lg_tiles) - 1))) >> (32 - lg_tiles)) << LC;")],
                     {}),
    # the scratch in pass 2's read order, scratch[k1 N2 + n2]
    "scratch_rows": ([("              base + ((((long long)(p >> LC) << lg_o) + c0 + c + CV(e))\n"
                       "                      << LC) + (p & (C - 1));",
                       "              base + ((long long)(c0 + c + CV(e)) << LGL) + p;"),
                      ("               : base + ((((long long)(c0 >> LC) << LGL) + k) << LC) + c;",
                       "               : base + ((long long)k << lg_o) + c0 + c;")], {}),
    # no programmatic dependent launch: each pass waits for the last
    "no_pdl": ([("  cfg.numAttrs = 2;", "  cfg.numAttrs = 1;")], {}),
    # dependents let in at a block's start, not once it reaches its stores
    "pdl_early": ([("  if (K > 1 && !stage) cluster_arrive_relaxed();\n"
                    "  wait_for_prerequisites();",
                    "  launch_dependents();\n"
                    "  if (K > 1 && !stage) cluster_arrive_relaxed();\n"
                    "  wait_for_prerequisites();")],
                  {}),
    # pass 1's radix-K step on its load's layout, no staging: a warp's
    # stores into another block 4 lines x 8 points
    "unstaged": ([("  const bool stage = !SECOND && K > 1 && staged;",
                   "  const bool stage = false;")], {}),
    "staged": ([("  const bool stage = !SECOND && K > 1 && staged;",
                 "  const bool stage = !SECOND && K > 1;")], {}),
    # registers capped at 48 a thread: more blocks an SM
    "regs48": ([("__global__ void __launch_bounds__(kMaxThreads)\nfour_step_kernel(",
                 "__global__ void __launch_bounds__(\n    four_step_threads(log_sub(LGL)),\n"
                 "    65536 / 48 / four_step_threads(log_sub(LGL)))\nfour_step_kernel(")],
               {}),
    # global stores through the default cache policy (kept in L2)
    "stores_cached": ([("__stcs(reinterpret_cast<V*>(p), raw);",
                        "*reinterpret_cast<V*>(p) = raw;")], {}),
    # global loads through the default cache policy
    "loads_cached": ([("__ldcs(reinterpret_cast<const V*>(p))",
                       "*reinterpret_cast<const V*>(p)")], {}),
}
FOUR_STEP_CASES = [("float32", 1, 1 << 20), ("float32", 64, 1 << 20),
                   ("float32", 1, 1 << 24), ("bfloat16", 64, 1 << 20)]


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
    regs = re.findall(r"_Z\w*fft_kernelILi8E\w*'[\s\S]*?Used (\d+) "
                      r"registers", log)
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
    print(f"built {name}: N=256 registers {regs}, spill stores {spills} B",
          flush=True)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="the radix-2 fft.cu, timed first and last")
    ap.add_argument("--four-step", action="store_true",
                    help="time the four-step variants (N past 8192)")
    ap.add_argument("--only", nargs="*", help="four-step variants to time")
    args = ap.parse_args(argv)
    if args.four_step:
        return four_step(args.only)

    import torch

    if not torch.cuda.is_available():
        print("fft_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fft import kernel as K

    text = SOURCE.read_text()
    sources = {}
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    for name, subs in VARIANTS.items():
        v = text
        for old, new in subs:
            if old not in v:
                raise ValueError(f"{name}: {old!r} is not in the source")
            v = v.replace(old, new)
        sources[name] = v
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources, sources.values())))
    argtypes, restype = _cuda.KERNELS["fft"].signatures["fft_launch"]
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).fft_launch
        if name == "parent":
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        else:
            fn.argtypes = argtypes
        fn.restype = restype
        fns[name] = fn

    def call(name, re_, im_, rows):
        out_r, out_i = torch.empty_like(re_), torch.empty_like(im_)
        n = re_.shape[1]
        stream = torch.cuda.current_stream().cuda_stream
        dt = K.DTYPES[re_.dtype]
        if name == "parent":
            wr, wi = K.device_twiddles(n, False, re_.device)
            err = fns[name](re_.data_ptr(), im_.data_ptr(), wr.data_ptr(),
                            wi.data_ptr(), out_r.data_ptr(),
                            out_i.data_ptr(), re_.shape[0], n,
                            max(1, 2048 // n), 0, dt, stream)
        else:
            tw = K.device_stockham_table(n, re_.device)
            err = fns[name](re_.data_ptr(), im_.data_ptr(), tw.data_ptr(),
                            out_r.data_ptr(), out_i.data_ptr(),
                            re_.shape[0], n, rows, 0, dt, stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return out_r, out_i

    def event_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    runs = [(n, K.default_block_rows(256)) for n in fns]
    runs += [("kernel", b) for b in BLOCK_ROWS]
    if "parent" in fns:
        runs += [("kernel", K.default_block_rows(256)),
                 ("parent", K.default_block_rows(256))]
    for tag, rows, n in CASES:
        zr = torch.randn(rows, n, generator=g, device=dev)
        zi = torch.randn(rows, n, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            xr, xi = zr.to(dtype), zi.to(dtype)
            want = K.fft_plain(xr, xi)
            elem = xr.element_size()
            bound = (4 * elem * rows * n) / PEAK_BYTES * 1e3
            line = f"{tag} {rows}x{n} {str(dtype)[6:]}: bound {bound:.5f} ms"
            copy_ms = event_ms(lambda: (xr.clone(), xi.clone()), 20)
            line += f" | clone {copy_ms:.4f} ms ({copy_ms / bound:.2f}x bound)"
            lib_ms = None
            if dtype == torch.float32:
                zc = torch.complex(xr, xi)
                lib_ms = event_ms(lambda: torch.fft.fft(zc), 20)
                line += f" | torch.fft.fft {lib_ms:.4f} ms"
                del zc
            for name, b in runs:
                got = call(name, xr, xi, b)
                ratio = max(float((a.float() - w.float()).abs().max()) /
                            float(w.float().abs().max())
                            for a, w in zip(got, want))
                ms = event_ms(lambda: call(name, xr, xi, b), 20)
                line += (f" | {name}" + ("" if name == "parent" else
                                         f"[{b}]") +
                         f" {ms:.4f} ms ({ms / bound:.2f}x bound"
                         + (f", {ms / lib_ms:.2f}x lib" if lib_ms else "")
                         + f", err {ratio:.1e})")
            print(line, flush=True)
    return 0


def four_step(only=None) -> int:
    """Time the four-step kernel and `FOUR_STEP_VARIANTS` in turns."""
    import torch

    if not torch.cuda.is_available():
        print("fft_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fft import kernel as K

    text = SOURCE.read_text()
    names = [n for n in FOUR_STEP_VARIANTS if not only or n in only
             or n == "kernel"]
    sources = {}
    for name in names:
        v = text
        for old, new in FOUR_STEP_VARIANTS[name][0]:
            if old not in v:
                raise ValueError(f"{name}: {old!r} is not in the source")
            v = v.replace(old, new)
        sources[name] = v
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(build, sources,
                                           sources.values())))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for sym, (argtypes, restype) in _cuda.KERNELS["fft"].signatures \
                .items():
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = argtypes, restype
        err = lib.fft_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        libs[name] = lib
    real_library = _cuda.library
    defaults = {k: getattr(K, k) for k in ("FOUR_STEP_LINES",
                                           "FOUR_STEP_BLOCK_POINTS",
                                           "MAX_CLUSTER")}

    def use(name):
        _cuda.library = lambda k: libs[name] if k == "fft" else \
            real_library(k)
        for k, v in {**defaults, **FOUR_STEP_VARIANTS[name][1]}.items():
            setattr(K, k, v)
        K.device_four_step_table.cache_clear()

    def event_ms(fn, reps: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def pass_ms(xr, xi) -> tuple:
        """Device ms of each four-step launch alone, as `_four_step`
        makes them."""
        R, n = xr.shape
        lib = _cuda.library("fft")
        table = K.device_four_step_table(n, xr.device)
        scratch = torch.empty((2, R, n), dtype=torch.float32,
                              device=xr.device)
        out_r, out_i = torch.empty_like(xr), torch.empty_like(xi)
        stream = torch.cuda.current_stream().cuda_stream

        def one(p):
            err = lib.fft_four_step_launch(
                xr.data_ptr(), xi.data_ptr(), table.data_ptr(),
                scratch[0].data_ptr(), scratch[1].data_ptr(),
                out_r.data_ptr(), out_i.data_ptr(), R, n, p, 0,
                K.DTYPES[xr.dtype], stream)
            if err:
                raise RuntimeError(f"pass {p} failed ({err})")
        return tuple(event_ms(lambda p=p: one(p)) for p in (0, 1))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    order = ["kernel"] + [n for n in names if n != "kernel"] + ["kernel"]
    for dname, rows, n in FOUR_STEP_CASES:
        dtype = getattr(torch, dname)
        xr = torch.randn(rows, n, generator=g, device=dev).to(dtype)
        xi = torch.randn(rows, n, generator=g, device=dev).to(dtype)
        use("kernel")
        want = K.fft_plain(xr, xi)
        K.device_twiddles.cache_clear()
        scale = max(float(w.float().abs().max()) for w in want)
        bound = 4 * xr.element_size() * rows * n / PEAK_BYTES * 1e3
        line = f"four-step {dname} {rows} x {n}: bound {bound:.5f} ms"
        line += f" | clone {event_ms(lambda: (xr.clone(), xi.clone())):.4f}"
        if dtype != torch.bfloat16:
            zc = torch.complex(xr, xi)
            line += f" | torch.fft.fft {event_ms(lambda: torch.fft.fft(zc)):.4f}"
            del zc
        for name in order:
            use(name)
            try:
                got = K.fft_cuda(xr, xi)
            except (RuntimeError, ValueError) as exc:
                line += f" | {name} refused ({str(exc)[:60]})"
                continue
            err = max(float((a.float() - w.float()).abs().max())
                      for a, w in zip(got, want)) / scale
            del got
            ms = event_ms(lambda: K.fft_cuda(xr, xi))
            passes = pass_ms(xr, xi)
            line += (f" | {name} {ms:.4f} ms ({ms / bound:.2f}x bound, "
                     f"passes {passes[0]:.4f} + {passes[1]:.4f}, err "
                     f"{err:.1e})")
        use("kernel")
        print(line + f" [{card}]", flush=True)
        del xr, xi, want
        torch.cuda.empty_cache()
    _cuda.library = real_library
    return 0


if __name__ == "__main__":
    sys.exit(main())
