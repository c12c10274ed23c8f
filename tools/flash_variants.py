#!/usr/bin/env python3
"""Time variants of the flash-attention kernel side by side on one card.

    python3 tools/flash_variants.py [--parent FILE] [--only NAME ...]
                                    [--dtype bfloat16|float32]

Each variant is `csrc/flash_attention.cu` with a few lines replaced (or,
for ``--parent``, another version of the file, e.g. ``git show
HEAD~1:src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu >
build/parent.cu``), built with the port's nvcc flags for the
instantiations the cases need (bfloat16 dh 64 and 120, float32 dh padded
to 64 and 128) and loaded beside the others. In one process, on one card,
the cases F1-F3 of `chip_smoke.py` (phase S) run in bfloat16 and in
float32 through every variant of their dtype in turn (the parent first
and last where given, the kernel also second to last), each held against
`scaled_dot_product_attention` in the same dtype, timed in the same
process.

bfloat16 variants: `no_kv_prefetch` and `no_lo_product` give wrong
outputs on purpose, each dropping one piece of work to show what it
costs; `one_block_per_sm` and `cp_async_only` undo one choice of the
design. float32 variants: `no_lo_products` (wrong on purpose) drops the
two lo products of S and of P V, leaving one TF32 product each.
`f32_reuse_k` writes V^T into K's buffers once S has read them (no
buffers of its own, so its transpose no longer runs under S): it undoes
the layout chosen for the most blocks an SM; `f32_one_block_per_sm` pads
the shared memory so that one block holds an SM, and `f32_bk32` takes
32-key tiles at every dh (64 are chosen at dh <= 64). Two variants undo
the kernel's guards against the tensor core's rounding: `o_one_chain`
accumulates P V over the whole band in one wgmma accumulator, rescaled
in place, instead of a fresh accumulator a tile added to O by FFMA, and
`s_one_chain` runs S's three products in one accumulator instead of the
hi x hi product in one and the two lo products in another.

Prints one line per case and dtype: SDPA's time, then each variant's
time, its ratio to SDPA and its max |diff| from SDPA. With
``--accuracy``, then one line per case of ACC_CASES in float32: the
max |diff| from a float64 reference of the plain float32 version, of
every float32 variant (with its max |diff| from the plain version and
the query row and live keys where it is largest) and of three
emulations of 3xTF32 over the same inputs: `emul_exact` (every step
summed exactly, rounded once to float32) and `emul_rz_{s1,s2}_{band,
tile}` (each wgmma step's sum rounded toward zero to float32; S in one
chain or in the hi and lo chains apart, P V in one chain over the band
or one a 64-key tile: `rz_s2_tile` models the kernel, `rz_s1_band` the
kernel with both guards undone). Needs a CUDA card and nvcc.
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
# --accuracy: (case, (B, Sq, Skv, H, KV, dh), causal, window, sd of q and
# k), F1 and F3 as above, the +-30 scores and the long band of
# chip_smoke.py's FLASH_EDGES
ACC_CASES = [("F1", (4, 2048, 2048, 16, 16, 64), True, None, 1.0),
             ("F3", (8, 1500, 1500, 16, 16, 64), False, None, 1.0),
             ("+-30", (2, 192, 192, 4, 2, 64), True, None, 8 ** 0.5),
             ("Skv 32768", (1, 128, 32768, 4, 2, 64), False, None, 1.0)]
DTYPES = ("bfloat16", "float32")
# name -> (the dtype it runs, or None for both; [(text, replacement)]
# applied to the source)
VARIANTS = {
    "kernel": (None, []),
    # bfloat16: drop a piece of work (wrong outputs), or undo a design
    # choice (only the first tile is loaded and waited for)
    "no_kv_prefetch": ("bfloat16", [
        ("    if (jt + 1 < J1) load_kv(jt + 1, stage ^ 1);", ""),
        ("      mbar_wait(bar0 + 8 * stage, ((jt - J0) >> 1) & 1);",
         "      if (jt == J0) mbar_wait(bar0, 0);")]),
    "no_lo_product": ("bfloat16", [
        ("      pv<DHN>(o, pl + 4 * kk, vt + kk * (16 * 128));\n", "")]),
    "one_block_per_sm": ("bfloat16", [
        ("__launch_bounds__(kThreads, TMA && DHN <= 64 ? 2 : 1)",
         "__launch_bounds__(kThreads, 1)")]),
    "cp_async_only": ("bfloat16", [
        ("  const bool tma = vb == 16 &&", "  const bool tma = false &&")]),
    # float32: one TF32 product each for S and P V (wrong outputs)
    "no_lo_products": ("float32", [
        ("      Wt<BK>::ss(s2, tc::desc(sqh + qo), tc::desc(kl + ko), "
         "kk > 0);\n"
         "      Wt<BK>::ss(s2, tc::desc(sql + qo), tc::desc(kt + ko), 1);\n",
         ""),
        ("    for (int i = 0; i < BK / 2; ++i) s[i] += s2[i];\n", ""),
        ("      pv<N>(t, ph + 4 * kk, vtl + vo, 1);\n"
         "      pv<N>(t, pl + 4 * kk, vth + vo, 1);\n", "")]),
    # float32: where the rounding goes (right outputs)
    "o_one_chain": ("float32", [
        ("    float t[N / 2];                        // the first step "
         "overwrites\n",
         "    float* t = o + C0 / 2;\n#pragma unroll\n"
         "    for (int i = 0; i < N / 2; ++i) t[i] *= (i & 2) ? c1 : c0;\n"),
        ("      pv<N>(t, ph + 4 * kk, vth + vo, kk > 0);",
         "      pv<N>(t, ph + 4 * kk, vth + vo, 1);"),
        ("#pragma unroll\n    for (int i = 0; i < N / 2; ++i)\n"
         "      o[C0 / 2 + i] = fmaf(o[C0 / 2 + i], (i & 2) ? c1 : c0, "
         "t[i]);\n", "")]),
    "s_one_chain": ("float32", [
        ("      Wt<BK>::ss(s2, tc::desc(sqh + qo), tc::desc(kl + ko), "
         "kk > 0);\n"
         "      Wt<BK>::ss(s2, tc::desc(sql + qo), tc::desc(kt + ko), 1);\n",
         "      Wt<BK>::ss(s, tc::desc(sqh + qo), tc::desc(kl + ko), 1);\n"
         "      Wt<BK>::ss(s, tc::desc(sql + qo), tc::desc(kt + ko), 1);\n"),
        ("    for (int i = 0; i < BK / 2; ++i) s[i] += s2[i];\n", "")]),
    "f32_reuse_k": ("float32", [
        ("  static constexpr bool SEP = blocks_per_sm(smem_for(DHP, BK, 5)) "
         ">=", "  static constexpr bool SEP = false &&")]),
    "f32_one_block_per_sm": ("float32", [
        ("  static constexpr int DATA = SMEM - 1024;\n"
         "  static constexpr int NCB",
         "  static constexpr int DATA = (SMEM > 120000 ? SMEM : 120000) - "
         "1024;\n  static constexpr int NCB"),
        ("  constexpr int BK = Shape<DHP>::BK, smem = Shape<DHP>::SMEM;",
         "  constexpr int BK = Shape<DHP>::BK, smem = Shape<DHP>::DATA + "
         "1024;")]),
    "f32_bk32": ("float32", [
        ("      blocks_per_sm(Layout<DHP, 64>::SMEM) >= 2 ? 64 : 32;",
         "      32;")]),
}


def tf32(x):
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x) -> tuple:
    hi = tf32(x)
    return hi, tf32(x - hi)


def rz(x):
    """float64 ``x`` rounded toward zero to float32."""
    import torch

    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def chain(acc, pairs, width: int, step: int, eq: str, sl):
    """``acc`` plus the sum of every a b over ``width`` in steps of
    ``step``, each step's three products (in the kernel's order) added
    exactly and the sum rounded toward zero to float32, as one wgmma step
    is modelled here; ``sl(x, i, j)`` slices an operand along the summed
    axis."""
    import torch

    for i in range(0, width, step):
        j = min(i + step, width)
        for a, b in pairs:
            acc = rz(acc.double() + torch.einsum(eq, sl(a, i, j).double(),
                                                 sl(b, i, j).double()))
    return acc


def emulate(q, k, v, mask, mode: str):
    """3xTF32 attention of one kv head: q (B, Sq, G, dh), k and v (B, Skv,
    dh) float32, mask (Sq, Skv). ``mode`` "exact" sums every product
    exactly and rounds once; "rz_{s1,s2}_{band,tile}" round each 8-deep
    step toward zero (`chain`): S in one chain or in its hi x hi and lo
    chains added in float32, P V in one chain over the whole band or one
    a 64-key tile with the tiles added in float32. Softmax in float32
    with the row's max; returns (B, Sq, G, dh) float32."""
    import torch

    from repro_torch.models.attention import NEG_INF

    B, Sq, G, dh = q.shape
    Skv = k.shape[1]
    qh, ql = split(q * (1.0 / math.sqrt(dh)))
    kh, kl = split(k)
    pairs = ((qh, kh), (qh, kl), (ql, kh))
    eq_s, eq_o = "bqgd,bsd->bgqs", "bgqs,bsd->bgqd"
    zero = torch.zeros(B, G, Sq, Skv, device=q.device)
    if mode == "exact":
        s = sum(torch.einsum(eq_s, a.double(), b.double())
                for a, b in pairs).float()
    elif mode.startswith("rz_s2"):
        s = chain(zero, pairs[:1], dh, 8, eq_s, lambda x, i, j: x[..., i:j]) \
            + chain(zero, pairs[1:], dh, 8, eq_s, lambda x, i, j: x[..., i:j])
    else:
        s = chain(zero, pairs, dh, 8, eq_s, lambda x, i, j: x[..., i:j])
    del zero
    p = torch.exp(torch.where(mask, s, NEG_INF) -
                  torch.where(mask, s, NEG_INF).amax(-1, keepdim=True))
    del s
    l = p.sum(-1, keepdim=True)
    ph, pl = split(p)
    vh, vl = split(v)
    del p
    pairs = ((ph, vh), (ph, vl), (pl, vh))

    def keys(x, i, j):
        return x[..., i:j] if x.dim() == 4 else x[:, i:j]

    o = torch.zeros(B, G, Sq, dh, device=q.device)
    if mode == "exact":
        o = sum(torch.einsum(eq_o, a.double(), b.double())
                for a, b in pairs).float()
    elif mode.endswith("band"):
        o = chain(o, pairs, Skv, 8, eq_o, keys)
    else:
        for t0 in range(0, Skv, 64):
            t1 = min(t0 + 64, Skv)
            tile = tuple((keys(a, t0, t1), keys(b, t0, t1))
                         for a, b in pairs)
            o = o + chain(torch.zeros_like(o), tile, t1 - t0, 8, eq_o, keys)
    return (o / l).transpose(1, 2)


def reference64(q, k, v, mask):
    """float64 attention of one kv head (shapes as `emulate`)."""
    import torch

    from repro_torch.models.attention import NEG_INF

    s = torch.einsum("bqgd,bsd->bgqs", q.double(), k.double()) / \
        math.sqrt(q.shape[-1])
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    return torch.einsum("bgqs,bsd->bqgd", p, v.double())


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
    spills = re.findall(r"(\d+) bytes spill stores", log)
    # registers of the float32 instantiations, by dh padded to 32
    regs, dhp = {}, None
    for ln in log.splitlines():
        if m := re.search(r"entry function '\w*?flash_kernelILi(\d+)E", ln):
            dhp = m.group(1) if "3f3212flash" in ln else None
        elif (m := re.search(r"Used (\d+) registers", ln)) and dhp:
            regs[dhp] = m.group(1)
    print(f"built {name}: spill stores {sorted(set(spills))} B; float32 "
          f"registers " + ", ".join(f"dh {d}: {r}" for d, r in regs.items()))
    return lib


def variant_sources(parent: Path | None, only) -> dict:
    text = SOURCE.read_text()
    # only the instantiations the cases need
    text = re.sub(r"#define FLASH_DHN\(X\).*?X\(256\)\n",
                  "#define FLASH_DHN(X) X(64) X(120)\n", text, flags=re.S)
    text = re.sub(r"#define FLASH_F32_DHP\(X\).*?X\(256\)\n",
                  "#define FLASH_F32_DHP(X) X(64) X(128)\n", text,
                  flags=re.S)
    out = {}
    if parent is not None:
        out["parent"] = parent.read_text()
    for name, (_, subs) in VARIANTS.items():
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
    ap.add_argument("--dtype", choices=DTYPES, help="one dtype only")
    ap.add_argument("--accuracy", action="store_true",
                    help="then hold the float32 variants and emulations "
                         "against float64 at ACC_CASES")
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
        for name in DTYPES:
            if args.dtype and name != args.dtype:
                continue
            dt = getattr(torch, name)
            q = torch.randn(B, S, H, dh, generator=g, device=dev).to(dt)
            k, v = (torch.randn(B, S, KV, dh, generator=g, device=dev)
                    .to(dt) for _ in range(2))
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
            line = f"{tag} {name}: sdpa {lib_ms:.4f} ms"
            for var in order:
                if VARIANTS.get(var, (None,))[0] not in (None, name):
                    continue
                fn = fns[var]
                diff = (call(fn, q, k, v, causal, window).float() -
                        ref).abs()
                ms = event_ms(lambda: call(fn, q, k, v, causal, window), 10)
                line += (f" | {var} {ms:.4f} ms ({ms / lib_ms:.2f}x, max "
                         f"|diff| {diff.max().item():.1e})")
            print(line, flush=True)
            del q, k, v, qt, kt, vt, ref
    if args.accuracy:
        accuracy(fns, order, call, dev)
    return 0


def accuracy(fns: dict, order: list, call, dev) -> None:
    """The --accuracy lines (see the module's docstring)."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        FLASH_TOL, flash_attention_plain)

    atol, rtol = FLASH_TOL["float32"]
    g = torch.Generator(device=dev).manual_seed(1)
    for tag, (B, sq, skv, H, KV, dh), causal, window, amp in ACC_CASES:
        q = amp * torch.randn(B, sq, H, dh, generator=g, device=dev)
        k = amp * torch.randn(B, skv, KV, dh, generator=g, device=dev)
        v = torch.randn(B, skv, KV, dh, generator=g, device=dev)
        qp = torch.arange(sq, device=dev)[:, None]
        kp = torch.arange(skv, device=dev)[None, :]
        mask = torch.ones(sq, skv, dtype=torch.bool, device=dev)
        if causal:
            mask &= qp >= kp
        if window is not None:
            mask &= qp - kp < window
        live = mask.sum(-1)
        G = H // KV

        def per_head(fn):
            return torch.cat([fn(q[:, :, j * G:(j + 1) * G], k[:, :, j],
                                 v[:, :, j], mask) for j in range(KV)], 2)

        ref = per_head(reference64)
        plain = flash_attention_plain(q, k, v, causal=causal, window=window)
        lim = atol + rtol * plain.abs()

        def reading(name, out):
            d64 = (out.double() - ref).abs()
            d32 = (out - plain).abs()
            row = int(d64.amax((0, 2, 3)).argmax())
            return (f" | {name} {d64.max().item():.2e} (vs plain "
                    f"{d32.max().item():.2e}, {(d32 / lim).max().item():.2f}"
                    f" of FLASH_TOL; worst row {row}, {int(live[row])} keys)")

        line = (f"acc {tag} float32 vs float64: plain "
                f"{(plain.double() - ref).abs().max().item():.2e}")
        for var in order:
            if VARIANTS.get(var, (None,))[0] in (None, "float32"):
                line += reading(var, call(fns[var], q, k, v, causal, window))
        for mode in ("exact", "rz_s1_band", "rz_s1_tile", "rz_s2_band",
                     "rz_s2_tile"):
            line += reading(f"emul_{mode}", per_head(
                lambda a, b, c, m: emulate(a, b, c, m, mode)))
        print(line, flush=True)
        del q, k, v, ref, plain, lim


if __name__ == "__main__":
    sys.exit(main())
