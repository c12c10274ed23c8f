#!/usr/bin/env python3
"""Time the FFT kernel, its variants and its parent side by side on one card.

    python3 tools/fft_variants.py [--parent FILE]

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
    args = ap.parse_args(argv)

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


if __name__ == "__main__":
    sys.exit(main())
