#!/usr/bin/env python3
"""Time the shuffle kernel, its variants, its parent and its one-call
PyTorch counterparts side by side on one card.

    python3 tools/shuffle_variants.py [--parent FILE]

Each variant is `csrc/shuffle.cu` with a few lines replaced (`VARIANTS`);
``--parent`` is another version of the file with the word-gather C
interface (e.g. ``git show f195f5c:src/repro_torch/kernels/shuffle/csrc/
shuffle.cu > build/parent_shuffle.cu``). All are built with the port's
nvcc flags, in parallel, and loaded beside each other. In one process, on
one card:

1. every op, half and shift of the edge cases (N 2 to 7000, float32,
   bfloat16 and int32, aligned and offset bases) through the kernel and
   every variant, each output held bitwise against the plain version;
2. phase S's rows of `chip_smoke.py` (S1: 359,997 x 256 float32, every
   op and the interleave, bit reversal and shift of each half; S2:
   1,048,576 x 128 int32, every op; shift 32) through the parent first
   and last, the kernel second and second to last, the kernel and every
   variant at 4, 8 and 16 KB of A and B staged a block (`VARIANTS`: the
   staging through registers, or with the evict-first policy), and
   `chip_smoke.shuffle_library`'s one PyTorch call where there is one
   (held bitwise against the kernel), CUDA events behind a device sleep,
   beside a `clone` of the output (the bytes the bound counts). Every
   output is held bitwise against the plain version.

It prints the registers of every instantiation and leaves a JSON report
in ``build/shuffle_variants/report.json``. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/shuffle/csrc/shuffle.cu"
OUT = ROOT / "build" / "shuffle_variants"
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3
BLOCK_BYTES = (4 * 1024, 8 * 1024, 16 * 1024)
# tag, (R, N), dtype, (op, half) runs: phase S's rows
OPS = ("interleave", "prune_even", "prune_odd", "bit_reverse",
       "circular_shift")
ROWS = [("S1", (359_997, 256), "float32",
         [(op, "both") for op in OPS] +
         [(op, h) for op in ("interleave", "bit_reverse", "circular_shift")
          for h in ("lower", "upper")]),
        ("S2", (1 << 20, 128), "int32", [(op, "both") for op in OPS])]

# name -> [(text, replacement)] applied to the source
CP_ASYNC = ("""    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::
                 "r"((unsigned)__cvta_generic_to_shared(d)), "l"(s));""")
WAIT = """    asm volatile("cp.async.wait_all;\\n" ::);\n"""
VARIANTS = {
    "kernel": [],
    # the staging copies through registers, in place of cp.async
    "registers": [(CP_ASYNC, "    *reinterpret_cast<uint4*>(d) = "
                             "*reinterpret_cast<const uint4*>(s);"),
                  (WAIT, "")],
    # through registers with the evict-first policy, loads and stores
    "streaming": [(CP_ASYNC, "    *reinterpret_cast<uint4*>(d) = "
                             "__ldcs(reinterpret_cast<const uint4*>(s));"),
                  (WAIT, ""),
                  ("*reinterpret_cast<uint4*>(dst) = v;",
                   "__stcs(reinterpret_cast<uint4*>(dst), v);")],
}


def variant_sources(text: str) -> dict:
    sources = {}
    for name, subs in VARIANTS.items():
        v = text
        for old, new in subs:
            if old not in v:
                raise ValueError(f"{name}: {old!r} is not in the source")
            v = v.replace(old, new, 1)
        sources[name] = v
    return sources


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
    regs = sorted({int(n) for n in re.findall(r"Used (\d+) registers", log)})
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
    print(f"built {name}: registers {regs[0]}-{regs[-1]}, spill stores "
          f"{spills} B", flush=True)
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="the word-gather shuffle.cu, timed first and last")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("shuffle_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import shuffle_library
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.shuffle import kernel as K

    sources = {}
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    sources.update(variant_sources(SOURCE.read_text()))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources, sources.values())))
    argtypes, restype = _cuda.KERNELS["shuffle"].signatures["shuffle_launch"]
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).shuffle_launch
        fn.argtypes = [p, p, p, ll, i, i, i, i, i, i, i, p] \
            if name == "parent" else argtypes
        fn.restype = restype
        fns[name] = fn

    def call(name, a, b, out, op, half, amount=32, block_bytes=None):
        stream = torch.cuda.current_stream().cuda_stream
        default = K.SHUFFLE_BLOCK_BYTES
        K.SHUFFLE_BLOCK_BYTES = block_bytes or default
        try:
            args = K.shuffle_launch_args(a, b, out, op, half=half,
                                         amount=amount)
        finally:
            K.SHUFFLE_BLOCK_BYTES = default
        err = fns[name](*(args[:11] if name == "parent" else args), stream)
        if err:
            raise RuntimeError(f"{name}: launch failed ({err})")
        return out

    def bits(t):
        return t.view(torch.int32 if t.element_size() == 4 else torch.int16)

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
    print(card, flush=True)
    report = {"card": card}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(shape, dtype, offset=0):
        n = math.prod(shape)
        if dtype == torch.int32:
            buf = torch.randint(-2 ** 31, 2 ** 31 - 1, (n + offset,),
                                generator=g, device=dev, dtype=dtype)
        else:
            buf = torch.randn(n + offset, generator=g, device=dev).to(dtype)
        return buf[offset:].view(shape)

    # 1. the edge cases, bitwise against the plain version
    n_edge = 0
    for dtype, n, offset in itertools.product(
            (torch.float32, torch.bfloat16, torch.int32),
            (2, 6, 64, 128, 256, 1000, 3000, 7000), (0, 1)):
        R = 37 if n <= 256 else 5
        a, b = draw((R, n), dtype, offset), draw((R, n), dtype, offset)
        for op, half in itertools.product(K.OPS, K.HALVES):
            if (op == "bit_reverse" and n & (n - 1)) or \
                    (op.startswith("prune") and (n % 2 or half != "both")):
                continue
            amounts = (0, 32, -5, n, 2 * n + 3) \
                if op == "circular_shift" else (32,)
            for amount in amounts:
                want = K.shuffle_plain(a, b, op, half=half, amount=amount)
                for v in fns:
                    if v == "parent":
                        continue
                    got = call(v, a, b, torch.empty_like(want), op, half,
                               amount)
                    if not torch.equal(bits(got), bits(want)):
                        raise AssertionError(
                            f"{v} {op} {half} {amount} N={n} {dtype} "
                            f"offset={offset}: not bitwise the plain")
                    n_edge += 1
    torch.cuda.synchronize()
    print(f"edge cases: {n_edge} runs bitwise equal to the plain version",
          flush=True)
    report["edge_runs"] = n_edge

    # 2. phase S's rows
    report["rows"] = {}
    for tag, shape, dtype, runs in ROWS:
        dtype = getattr(torch, dtype)
        a, b = draw(shape, dtype), draw(shape, dtype)
        for op, half in runs:
            want = K.shuffle_plain(a, b, op, half=half)
            out_n = want.shape[1]
            nbytes = 2 * a.element_size() * shape[0] * out_n
            bound = nbytes / PEAK_BYTES * 1e3
            clone_ms = event_ms(lambda: want.clone(), 20)
            line = (f"{tag} {op} {half} ({shape[0]} x {shape[1]} "
                    f"{str(dtype)[6:]}): bound {bound:.5f} ms | clone "
                    f"{clone_ms:.4f} ms")
            row = {"bound_ms": bound, "clone_ms": clone_ms, "runs": []}
            order = ([("parent", None)] if "parent" in fns else []) + \
                [("kernel", None)] + \
                [(v, bb) for v in fns if v != "parent"
                 for bb in BLOCK_BYTES] + [("kernel", None)] + \
                ([("parent", None)] if "parent" in fns else [])
            lib = shuffle_library(a, b, op, half, 32)
            for v, bb in order + ([("library", None)] if lib else []):
                if v == "library":
                    fn = lib
                else:
                    out = torch.empty_like(want)

                    def fn(v=v, bb=bb, out=out):
                        return call(v, a, b, out, op, half, 32, bb)
                if not torch.equal(bits(fn()), bits(want)):
                    raise AssertionError(f"{tag} {op} {half} {v}[{bb}]: not "
                                         f"bitwise the plain")
                ms = event_ms(fn, 20)
                name = v + (f"[{bb // 1024}K]" if bb else "")
                row["runs"].append({"name": name, "ms": ms})
                line += (f" | {name} {ms:.4f} ms "
                         f"({100 * bound / ms:.0f}% of bound)")
            report["rows"][f"{tag} {op} {half}"] = row
            print(line, flush=True)
            del want
        del a, b
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
