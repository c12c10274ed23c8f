#!/usr/bin/env python3
"""Time the RoPE kernel, its variants and its parent side by side on one card.

    python3 tools/rope_variants.py [--parent FILE]

Each variant is `csrc/rope.cu` with a few lines replaced (`VARIANTS`);
``--parent`` is another version of the file with the one-thread-a-pair C
interface (e.g. ``git show f195f5c:src/repro_torch/kernels/rope/csrc/rope.cu
> build/parent_rope.cu``). All are built with the port's nvcc flags, in
parallel, and loaded beside each other. In one process, on one card:

1. every edge case (`edge_cases`: dh 2 to 256, heads 1 to 32, both
   layouts and dtypes, aligned and misaligned bases, an ``x[1:]`` view, a
   partial last block, positions up to 2^20) through the kernel and every
   variant that takes it, each output held bitwise against the parent's
   and within `ROPE_TOL` of the plain version;
2. phase S's rows of `chip_smoke.py` (R1: (4, 2048, 16, 64), theta 1e6,
   both layouts in float32 and bfloat16; R2: (1, 8192, 32, 120), theta
   1e4, neox, bfloat16; one int32 position a slot) through the parent
   first and last, the kernel second and second to last, the kernel and
   every variant at the default and at 1, 2, 4 and 8 slots a block (taken
   literally: the threads a block shrink to the block's rows), CUDA
   events behind a device
   sleep, beside a `clone` of the same bytes (what the card's memory
   sustains for this traffic). Every output is held bitwise against the
   parent's. These readings find x in L2 (50 MB) when it fits there, as
   R1 bfloat16's 16.8 MB does; so each row is read again cold: the
   parent, the kernel and the `clone`, each launch timed alone after
   `FLUSH_BYTES` of another buffer are read (a read, so that L2 holds
   clean lines and no write-back of them falls into the timed launch).

It prints the registers and spills of every instantiation, the SASS
instruction count of each of the kernel's, and leaves a JSON report in
``build/rope_variants/report.json``. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/rope/csrc/rope.cu"
OUT = ROOT / "build" / "rope_variants"
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3
ROPE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}   # as chip_smoke.py
# tag, x (B, S, H, dh), theta, (layout, dtype) runs: phase S's rows
ROWS = [("R1", (4, 2048, 16, 64), 1e6,
         tuple((lay, dt) for lay in ("neox", "interleaved")
               for dt in ("float32", "bfloat16"))),
        ("R2", (1, 8192, 32, 120), 1e4, (("neox", "bfloat16"),))]
BLOCK_SLOTS = (1, 2, 4, 8)
FLUSH_BYTES = 256 << 20                 # read between cold launches

# neox with half rows that 16-byte vectors do not tile (R2: 120 B):
# the block's span staged through shared memory by 16-byte vectors, each
# pair rotated there in place, and written back by 16-byte vectors, in
# place of one 8-byte vector from each half
STAGED_KERNEL = r"""
template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_staged(const T* __restrict__ x, const void* __restrict__ pos,
            T* __restrict__ out, long long slots, int heads, int dh,
            int block_slots, float two_over_dh, float neg_log_theta,
            int pos_dtype) {
  extern __shared__ float4 smem[];
  const int h = dh >> 1;
  const long long slot0 = (long long)blockIdx.x * block_slots;
  const int nslots = (int)min((long long)block_slots, slots - slot0);
  const int plane = (block_slots * h + 3) & ~3;
  float* const tc = reinterpret_cast<float*>(smem);
  float* const ts = tc + plane;
  uint4* const span = reinterpret_cast<uint4*>(ts + plane);
  T* const e = reinterpret_cast<T*>(span);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long long base = slot0 * heads * (long long)dh;
  const int nvec = (int)((long long)nslots * heads * dh * sizeof(T) / 16);
  const uint4* src = reinterpret_cast<const uint4*>(x + base);
  for (int v = tid; v < nvec; v += nthreads) span[v] = __ldcs(src + v);
  {
    const int hh = min(h, nthreads);
    const int sstep = nthreads / hh;
    const int s0 = tid / hh, i0 = tid - s0 * hh;
    if (s0 < sstep) {
      for (int s = s0; s < nslots; s += sstep) {
        const float p = position(pos, pos_dtype, slot0 + s);
        for (int i = i0; i < h; i += hh) {
          const float inv = expf(__fmul_rn(__fmul_rn((float)i, two_over_dh),
                                           neg_log_theta));
          const float ang = __fmul_rn(p, inv);
          tc[s * h + i] = cosf(ang);
          ts[s * h + i] = sinf(ang);
        }
      }
    }
  }
  __syncthreads();
  const int nrows = nslots * heads;
  int k = tid / h, u = tid - k * h;
  int s = k / heads, r = k - s * heads;
  const int dk = nthreads / h, du = nthreads - dk * h;
  const int ds = dk / heads, dr = dk - ds * heads;
  while (k < nrows) {
    T* p = e + k * dh + u;
    float x1 = to_f(p[0]), x2 = to_f(p[h]);
    rotate(x1, x2, tc[s * h + u], ts[s * h + u]);
    p[0] = from_f<T>(x1);
    p[h] = from_f<T>(x2);
    u += du;
    k += dk;
    s += ds;
    r += dr;
    if (r >= heads) { r -= heads; ++s; }
    if (u >= h) {
      u -= h;
      ++k;
      if (++r == heads) { r = 0; ++s; }
    }
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(out + base);
  for (int v = tid; v < nvec; v += nthreads) __stcs(dst + v, span[v]);
}

template <typename T>
cudaError_t launch_staged(const void* x, const void* pos, void* out,
                          long long slots, int heads, int dh,
                          int block_slots, float two_over_dh,
                          float neg_log_theta, int pos_dtype,
                          cudaStream_t stream) {
  const long long blocks = (slots + block_slots - 1) / block_slots;
  const size_t smem =
      2 * sizeof(float) * (size_t)((block_slots * (dh >> 1) + 3) & ~3) +
      (size_t)block_slots * heads * dh * sizeof(T);
  cudaFuncSetAttribute(rope_staged<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  rope_staged<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), pos, static_cast<T*>(out), slots, heads, dh,
      block_slots, two_over_dh, neg_log_theta, pos_dtype);
  return cudaGetLastError();
}

template <typename T, bool kNeox>
cudaError_t launch_vec("""

# name -> [(text, replacement)] applied to the source
VARIANTS = {
    "kernel": [],
    # global loads and stores through the evict-first policy
    "streaming": [("*reinterpret_cast<const uint4*>(p)",
                   "__ldcs(reinterpret_cast<const uint4*>(p))"),
                  ("*reinterpret_cast<const uint2*>(p)",
                   "__ldcs(reinterpret_cast<const uint2*>(p))"),
                  ("*reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], "
                   "w[2], w[3]);",
                   "__stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], "
                   "w[1], w[2], w[3]));"),
                  ("*reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);",
                   "__stcs(reinterpret_cast<uint2*>(p), make_uint2(w[0], "
                   "w[1]));")],
    # units loaded before the first is rotated
    "depth1": [("constexpr int kDepth = 2;", "constexpr int kDepth = 1;")],
    "depth4": [("constexpr int kDepth = 2;", "constexpr int kDepth = 4;")],
    # neox over half rows of 8-byte vectors staged through shared memory
    "staged": [("template <typename T, bool kNeox>\ncudaError_t launch_vec(",
                STAGED_KERNEL),
               ("  if (vec_bytes == 8)\n",
                "  if (vec_bytes == 8 && kNeox)\n"
                "    return launch_staged<T>(x, pos, out, slots, heads, dh,\n"
                "                            block_slots, two_over_dh,\n"
                "                            neg_log_theta, pos_dtype, "
                "stream);\n"
                "  if (vec_bytes == 8)\n")],
}
# variants timed on the rows only where they change the code those rows run
ONLY_ON = {"staged": ("R2",)}


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


def build(name: str, text: str) -> tuple:
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
    regs = re.findall(r"Function properties for (\w+)[\s\S]*?Used (\d+) "
                      r"registers", log)
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
    print(f"built {name}: registers " +
          " ".join(f"{instantiation(f)}:{n}" for f, n in regs) +
          f"; spill stores {spills} B", flush=True)
    return lib, log


def instantiation(mangled: str) -> str:
    """rope_kernel<T, VB, neox> as 'f32/16/neox', from a mangled name."""
    m = re.search(r"(rope_\w+?)I(f|13__nv_bfloat16)(?:Li(\d+)ELb(\d))?", mangled)
    if not m:
        return mangled
    t = "f32" if m.group(2) == "f" else "bf16"
    if m.group(3) is None:
        return f"{m.group(1)}<{t}>"
    return f"{t}/{m.group(3)}/{'neox' if m.group(4) == '1' else 'inter'}"


def sass_counts(lib: Path) -> dict:
    """Instructions of each kernel function in ``lib`` (cuobjdump -sass)."""
    from repro_torch.kernels import _cuda

    tool = shutil.which("cuobjdump") or str(Path(_cuda._nvcc()).parent /
                                            "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        if m := re.search(r"Function : (\S+)", ln):
            name = instantiation(m.group(1))
            counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4}\*/", ln):
            counts[name] += 1
    return counts


def edge_cases(torch, dev, g) -> list:
    """(label, x, positions, layout, heads) cases whose shapes and bases
    take every path of the kernel."""
    cases = []
    for dh in (2, 18, 24, 32, 64, 120, 128, 256):
        for heads in (1, 3, 16, 32):
            for dt in (torch.float32, torch.bfloat16):
                for lay in ("interleaved", "neox"):
                    # offsets of 0, one element and 8 bytes: the 16-byte,
                    # scalar and 8-byte paths' bases
                    for mis in (0, 1, 8 // (4 if dt == torch.float32
                                            else 2)):
                        slots = 9 if heads >= 16 else 37
                        R = slots * heads
                        buf = torch.randn(R * dh + 4, generator=g,
                                          device=dev).to(dt)
                        x = buf[mis: mis + R * dh].view(R, dh)
                        pos = torch.randint(0, 1 << 20, (slots,),
                                            generator=g, device=dev,
                                            dtype=torch.int32)
                        cases.append((f"dh={dh} heads={heads} {dt} {lay} "
                                      f"offset={mis}", x, pos, lay, heads))
    for dt in (torch.float32, torch.bfloat16):
        # an x[1:] view: contiguous, its base one row in
        big = torch.randn(8 * 16 + 1, 120, generator=g, device=dev).to(dt)
        pos = torch.randint(0, 8192, (8,), generator=g, device=dev)
        cases.append((f"x[1:] {dt}", big[1:], pos, "neox", 16))
        # 13 slots: a partial last block at every slot count a block
        x = torch.randn(13 * 32, 64, generator=g, device=dev).to(dt)
        pos = torch.randint(0, 1 << 20, (13,), generator=g, device=dev)
        for lay in ("interleaved", "neox"):
            cases.append((f"13 slots {dt} {lay}", x, pos, lay, 32))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="the one-thread-a-pair rope.cu, timed first and "
                         "last and the reference of every bitwise check")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("rope_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.rope import kernel as K

    sources = {}
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    sources.update(variant_sources(SOURCE.read_text()))
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources, sources.values())))
    report = {"ptxas": {k: v[1] for k, v in built.items()},
              "sass": sass_counts(built["kernel"][0])}
    print("sass instructions of the kernel: " + ", ".join(
        f"{k} {n}" for k, n in report["sass"].items()), flush=True)
    argtypes, restype = _cuda.KERNELS["rope"].signatures["rope_launch"]
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    fns = {}
    for name, (lib, _) in built.items():
        fn = ctypes.CDLL(str(lib)).rope_launch
        fn.argtypes = [p, p, p, ll, i, i, f, f, i, i, i, p] \
            if name == "parent" else argtypes
        fn.restype = restype
        fns[name] = fn

    def call(name, x, pos, out, theta, lay, heads, block_slots=None):
        stream = torch.cuda.current_stream().cuda_stream
        if name == "parent":
            c1, c2 = K.rope_constants(x.shape[1], theta)
            err = fns[name](x.data_ptr(), pos.data_ptr(), out.data_ptr(),
                            x.shape[0], x.shape[1], heads, c1, c2,
                            K.LAYOUTS.index(lay), K.DTYPES[x.dtype],
                            K.POS_DTYPES[pos.dtype], stream)
        else:
            a = list(K.rope_launch_args(x, pos, out, theta=theta, layout=lay,
                                        heads=heads))
            if block_slots is not None:       # literally, threads to fit
                geo = K.rope_geometry(x.shape[0], x.shape[1], heads,
                                      x.element_size(), lay, a[12])
                a[13] = block_slots
                a[14] = geo.units * min(K.ROPE_THREADS // geo.units,
                                        block_slots * heads)
            err = fns[name](*a, stream)
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

    flush = None

    def cold_ms(fn, reps: int) -> float:
        """Mean device time of ``reps`` single launches of ``fn``, each
        after `FLUSH_BYTES` are read, so none of its bytes is in L2."""
        nonlocal flush
        if flush is None:
            flush = torch.ones(FLUSH_BYTES // 4, device=dev)
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        events = []
        for _ in range(reps):
            flush.sum()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in events) / reps

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    report["card"] = card
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    ref = "parent" if "parent" in fns else "kernel"

    # 1. the edge cases, bitwise against the parent
    n_edge, worst = 0, {"float32": 0.0, "bfloat16": 0.0}
    for label, x, pos, lay, heads in edge_cases(torch, dev, g):
        want = call(ref, x, pos, torch.empty_like(x), 1e4, lay, heads)
        plain = K.rope_plain(x, pos, theta=1e4, layout=lay, heads=heads)
        name = str(x.dtype)[6:]
        scale = float(plain.float().abs().max())
        for v in fns:
            if v in ("parent", "staged"):
                continue
            got = call(v, x, pos, torch.full_like(x, float("nan")), 1e4, lay,
                       heads)
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"{v} {label}: not bitwise the {ref}'s")
            diff = float((got.float() - plain.float()).abs().max())
            if not diff <= ROPE_TOL[name] * scale:
                raise AssertionError(f"{v} {label}: |diff| vs plain {diff}")
            worst[name] = max(worst[name], diff / scale)
            n_edge += 1
    torch.cuda.synchronize()
    print(f"edge cases: {n_edge} runs bitwise equal to the {ref}'s; max "
          f"|diff| / max |plain| float32 {worst['float32']:.3e} bfloat16 "
          f"{worst['bfloat16']:.3e} (tol {ROPE_TOL})", flush=True)
    report["edge"] = {"runs": n_edge, "worst": worst}

    # 2. phase S's rows
    report["rows"] = {}
    for tag, shape, theta, runs in ROWS:
        B, S, H, dh = shape
        x32 = torch.randn(B * S * H, dh, generator=g, device=dev)
        pos = torch.arange(S, device=dev, dtype=torch.int32).repeat(B)
        for lay, dt in runs:
            x = x32.to(getattr(torch, dt))
            elem = x.element_size()
            nbytes = 2 * elem * x.numel() + 4 * pos.numel()
            bound = nbytes / PEAK_BYTES * 1e3
            want = call(ref, x, pos, torch.empty_like(x), theta, lay, H)
            order = ([("parent", None)] if "parent" in fns else []) + \
                [(v, bs) for v in fns if v != "parent" and
                 tag in ONLY_ON.get(v, (tag,))
                 for bs in (None,) + BLOCK_SLOTS] + \
                [("kernel", None)] + \
                ([("parent", None)] if "parent" in fns else [])
            clone_ms = event_ms(lambda: x.clone(), 50)
            line = (f"{tag} {lay} {dt} x ({B * S * H}, {dh}) heads {H}: "
                    f"bound {bound:.5f} ms | clone {clone_ms:.4f} ms")
            row = {"bound_ms": bound, "clone_ms": clone_ms, "runs": []}
            for v, bs in order:
                out = torch.empty_like(x)
                call(v, x, pos, out, theta, lay, H, bs)
                same = torch.equal(bits(out), bits(want))
                if not same:
                    raise AssertionError(f"{tag} {lay} {dt} {v}[{bs}]: not "
                                         f"bitwise the {ref}'s")
                ms = event_ms(lambda: call(v, x, pos, out, theta, lay, H, bs),
                              50)
                tagv = v + (f"[{bs}]" if bs else "")
                row["runs"].append({"name": tagv, "ms": ms})
                line += (f" | {tagv} {ms:.4f} ms ({100 * bound / ms:.0f}% of "
                         f"bound)")
            # cold L2: the parent and the kernel first and last
            cold = ["parent"] if "parent" in fns else []
            cold = cold + ["kernel", "clone", "kernel"] + cold
            line += " || cold L2:"
            row["cold"] = []
            for v in cold:
                out = torch.empty_like(x)
                fn = (lambda: x.clone()) if v == "clone" else \
                    (lambda v=v, out=out: call(v, x, pos, out, theta, lay, H))
                ms = cold_ms(fn, 50)
                row["cold"].append({"name": v, "ms": ms})
                line += (f" | {v} {ms:.4f} ms ({100 * bound / ms:.0f}% of "
                         f"bound)")
            report["rows"][f"{tag} {lay} {dt}"] = row
            print(line, flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "report.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
