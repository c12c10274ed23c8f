#!/usr/bin/env python3
"""Time variants of the flash-attention kernel side by side on one card.

    python3 tools/flash_variants.py [--parent FILE] [--only NAME ...]

Each variant is `csrc/flash_attention.cu` with a few lines replaced (or,
for ``--parent``, another version of the file, e.g. ``git show
HEAD~1:src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu >
build/parent.cu``), built with the port's nvcc flags for the bfloat16
instantiations the cases need (dh 64 and 120) and loaded beside the
others. In one process, on one card, the cases F1-F3 of `chip_smoke.py`
(phase S, bfloat16) run through every variant in turn (the parent first
and last where given, the kernel also second to last), each held against
`scaled_dot_product_attention` timed in the same process.
`no_kv_prefetch` and `no_lo_product` give wrong outputs on purpose: each
drops one piece of work to show what it costs. `one_block_per_sm` and
`cp_async_only` undo one choice of the design.

Prints one line per case: SDPA's time, then each variant's time, its
ratio to SDPA and its max |diff| from SDPA. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/flash_attention/csrc/" \
    "flash_attention.cu"
OUT = ROOT / "build" / "flash_variants"
# (case, (B, S, H, KV, dh), causal, window), as phase S of chip_smoke.py
CASES = [("F1", (4, 2048, 16, 16, 64), True, None),
         ("F3", (8, 1500, 16, 16, 64), False, None),
         ("F2", (1, 8192, 32, 8, 120), True, 4096)]
# name -> [(text, replacement)] applied to the source
VARIANTS = {
    "kernel": [],
    # drop a piece of work (wrong outputs), or undo a design choice
    # (only the first tile is loaded and waited for)
    "no_kv_prefetch": [("    if (jt + 1 < J1) load_kv(jt + 1, stage ^ 1);",
                        ""),
                       ("      mbar_wait(bar0 + 8 * stage, ((jt - J0) >> 1) "
                        "& 1);", "      if (jt == J0) mbar_wait(bar0, 0);")],
    "no_lo_product": [("      pv<DHN>(o, pl + 4 * kk, vt + kk * "
                       "(16 * 128));\n", "")],
    "one_block_per_sm": [("__launch_bounds__(kThreads, TMA && DHN <= 64 ? "
                          "2 : 1)", "__launch_bounds__(kThreads, 1)")],
    "cp_async_only": [("  const bool tma = vb == 16 &&",
                       "  const bool tma = false &&")],
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
    spills = re.findall(r"(\d+) bytes spill stores", proc.stdout +
                        proc.stderr)
    print(f"built {name}: spill stores {sorted(set(spills))} B")
    return lib


def variant_sources(parent: Path | None, only) -> dict:
    text = SOURCE.read_text()
    # only the instantiations the cases need
    text = re.sub(r"#define FLASH_DHN\(X\).*?X\(256\)\n",
                  "#define FLASH_DHN(X) X(64) X(120)\n", text, flags=re.S)
    out = {}
    if parent is not None:
        out["parent"] = parent.read_text()
    for name, subs in VARIANTS.items():
        if only and name not in only:
            continue
        v = text
        for old, new in subs:
            if old not in v:
                raise ValueError(f"{name}: {old!r} is not in the source")
            v = v.replace(old, new)
        out[name] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="another version of flash_attention.cu, timed "
                         "first and last")
    ap.add_argument("--only", nargs="*", help="variants to build")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import kernel as _flash

    sources = variant_sources(args.parent, args.only)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build, sources, sources.values())))
    argtypes, restype = _cuda.KERNELS["flash_attention"].signatures[
        "flash_attention_launch"]
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).flash_attention_launch
        fn.argtypes, fn.restype = argtypes, restype
        fns[name] = fn
    # parent, kernel, diagnostics, kernel, parent: drift shows as a gap
    # between the two readings of one build
    order = list(fns) + [n for n in ("kernel", "parent")
                         if "parent" in fns and n in fns]

    def call(fn, q, k, v, causal, window):
        B, Sq, H, dh = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, k.shape[2], Sq, k.shape[1], dh, *q.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(dh),
                 int(causal), int(window is not None),
                 0 if window is None else int(window), _flash.DTYPES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return out

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
    for tag, (B, S, H, KV, dh), causal, window in CASES:
        q = torch.randn(B, S, H, dh, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(B, S, KV, dh, generator=g, device=dev)
                .bfloat16() for _ in range(2))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window is not None:
            i = torch.arange(S, device=dev)[:, None]
            j = torch.arange(S, device=dev)[None, :]
            mask = (i - j < window) & (i >= j)

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        ref = sdpa().transpose(1, 2).float()
        lib_ms = event_ms(sdpa, 10)
        line = f"{tag} bfloat16: sdpa {lib_ms:.4f} ms"
        for name in order:
            fn = fns[name]
            diff = (call(fn, q, k, v, causal, window).float() - ref).abs()
            ms = event_ms(lambda: call(fn, q, k, v, causal, window), 10)
            line += (f" | {name} {ms:.4f} ms ({ms / lib_ms:.2f}x, max |diff| "
                     f"{diff.max().item():.1e})")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
