// Flash attention (online softmax) with grouped-query heads, a causal mask
// aligned top-left and an optional sliding window, as CUDA kernels for
// Hopper (sm_90a), bound to PyTorch through a plain C interface
// (kernels/flash_attention/kernel.py). q is (B, Sq, H, dh), k and v are
// (B, Skv, KV, dh), read in that public layout through their strides;
// query head h reads kv head h / (H / KV). For query position i and key
// position j (both counted from 0) a score is live when
//
//     (!causal || i >= j) && (!window || i - j < window);
//
// the output is softmax(q k^T / sqrt(dh)) v over the live keys, accumulated
// in float32 and written in q's type (float32 or bfloat16). Masked scores
// get -1e30 after the scaling, as the reference's fill, and the running max
// starts at -1e30: a row whose keys in one live tile are all masked gets
// p = 1 there for a moment, and the next tile with a live key cancels it
// exactly through exp(-1e30 - m) = 0; keys past Skv get -inf and weigh 0.
// The output divides by max(l, 1e-30). Key tiles outside a 64-row query
// group's causal/window band are skipped.
//
// Replaces flash_attention_pallas of
// src/repro/kernels/flash_attention/kernel.py:102 (body _kernel :28),
// which walks a (batch x heads, q-chunk, kv-chunk) grid with the running
// max, sum and accumulator in VMEM scratch across the kv axis and skips
// the chunks outside the causal or window band.
//
// What bounds it on this card. 4 dh operations per live (query, key) pair
// (the two products) against 2 dh elements of q and out per query and of k
// and v per key: at S in the thousands that is hundreds of operations per
// byte, so it is operation-bound, on the tensor cores: in bfloat16 at 989
// TFLOP/s dense; in float32 as 3xTF32 (below), three TF32 products at 495
// TFLOP/s, a float32-accurate 165 TFLOP/s against the CUDA cores' 67. One
// TF32 rounding of q, k, p or v (10 mantissa bits) is past the float32
// tolerance; the split into two TF32 halves is not. Around the products,
// the softmax's exp2, conversions and reductions run on the CUDA cores: at
// dh 64 they take about as long as the bfloat16 products, so they must
// overlap them, and every instruction the load path adds shows.
//
// bfloat16: the tensor-core kernel (namespace tc). One block of two
// consumer warpgroups per (batch x head, 128-query tile); warpgroup w owns
// 64 query rows; two blocks share an SM at dh <= 64, where 128 registers
// suffice, so four warpgroups overlap their products and softmaxes. q's
// tile goes to shared memory once; the 64-key K and V tiles of the band
// stream through a two-stage ring, tile j + 1 loading while tile j
// computes. Where every pointer and stride is 16-byte aligned (and
// cuTensorMapEncodeTiled takes the map), one thread loads a tile by TMA
// (boxes of 64 columns, 128-byte swizzled, zero past Skv and dh) that
// completes on the stage's mbarrier, so the other threads spend no
// instruction or register on loads; else every thread copies by cp.async
// (16, 8, 4 or 2 bytes, zero-filled) into the same swizzle.
// S = Q K^T is wgmma m64n64k16 with both operands in shared memory (K
// stored [key][d] is K-major), over dh padded to 16. The softmax stays in
// registers: each row's max and sum reduce over the 4 threads that hold it
// (two shuffles), ex2.approx takes scale * log2(e) folded in, and the
// correction rescales the O accumulator in place (skipped where no row of
// the warp moved its max). Only the tiles that hold the diagonal, a window
// edge or the end of Skv evaluate the mask. O += P V takes P from
// registers, since the f32 accumulator layout of S is the A-register
// layout of a 16-bit product, and V through a transposed (MN-major)
// descriptor, in chunks of up to 64 columns over dh padded to 8.
//
// P is split: p_hi = bf16(p), p_lo = bf16(p - p_hi), two products into one
// float32 accumulator. The plain version keeps p in float32; rounding it
// once to bfloat16 moves outputs by up to a bfloat16 step of their own
// before the final rounding adds another, which breaks the bfloat16
// tolerance at a few percent of outputs (tests/
// test_torch_kernel_standalone.py pins this on the CPU). hi + lo carries p
// to 16 bits, and costs 6 dh instead of 4 dh tensor operations per pair.
// One instantiation per dh padded to 8 (8..256) and copy route.
//
// float32: 3xTF32 on the tensor cores (namespace f32). Every operand x is
// split once into x_hi = tf32(x) and x_lo = tf32(x - x_hi) (cvt.rna; x -
// x_hi is exact), and each product a b is a_hi b_hi + a_hi b_lo + a_lo b_hi
// accumulated in float32 (a_lo b_lo, ~2^-22 relative, is dropped): as
// accurate as a float32 product to the tolerance, at 3 TF32 products a
// step (tests/test_torch_kernel_standalone.py pins both on the CPU: one
// product fails the tolerance at a third of the outputs, three hold it).
// A wgmma step rounds its sum toward zero, so a chain of n steps into one
// accumulator drifts by up to n ulps of its running sum (measured on the
// card against a model of that rounding, tools/flash_variants.py
// --accuracy): S's hi x hi product runs in one accumulator and its two lo
// products in another, added by FADD, and each tile's P V runs in a fresh
// accumulator added to O by FFMA, so that no chain grows with the band.
// One block of one consumer warpgroup per (batch x head, 64-query tile),
// walking the band in tiles of 64 keys (dh <= 64) or 32. q's tile lands
// raw (TMA, or cp.async where a pointer or stride is not 16-byte aligned,
// in the bfloat16 kernel's 128-byte swizzle with boxes of 32 floats), is
// scaled by 1/sqrt(dh) and split in place into Q_hi and Q_lo once. Each K
// and V tile lands raw; K is split in place into K_hi with K_lo beside it,
// and S runs as wgmma m64nBKk8.tf32 over dh / 8 steps (Q and K stored
// [row][d] are K-major, the only major TF32 takes in shared memory). The
// softmax is the bfloat16 kernel's, with log2(e) alone folded into ex2 (q
// carries the scale). P is split in registers and is the A operand: the S
// accumulator gives thread (g, t) = (lane / 4, lane % 4) keys 2t and 2t +
// 1 of each 8-key group and the TF32 A fragment wants columns t and t + 4,
// so keys are permuted within each group (column t <-> key 2t, t + 4 <->
// key 2t + 1). V arrives [key][d], MN-major for P V, so the threads write
// V^T, split and key-permuted (transpose_v, conflict-free 16-byte
// accesses), and P_hi V_hi + P_hi V_lo + P_lo V_hi runs as wgmma
// m64n64k8 / m64n32k8 with P from registers. Each block's split, softmax
// and transpose are serial with its own products, so the shared-memory
// layout is the one that lets most blocks share an SM (Layout): V^T in
// buffers of its own where that costs no block (its transpose then runs
// under S, and tile j + 1 loads under this tile's softmax and P V), else
// in K's buffers once S has read them. dh 64: 64-key tiles, own V^T, two
// blocks an SM; dh 128: 32-key tiles, V^T in K's buffers, two blocks. One
// instantiation per dh padded to 32, the copy route chosen at run time.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's mask fill

struct Args {
  const void* q; const void* k; const void* v; void* out;
  int B, H, KV, Sq, Skv, dh;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
  int causal, has_window;
  long long window;
};

// ------------------------------------------------ bfloat16 tensor cores

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int kBQ = 128;            // queries per block, 64 a warpgroup
constexpr int kBK = 64;             // keys per tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: `src_bytes` of `BYTES` read, the rest zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- mbarriers and TMA tile loads
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n" :: "r"(bar)
               : "memory");
}
// arrive once, expecting `bytes` of TMA writes before the phase completes
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// expect `bytes` more in the current phase, without arriving
__device__ __forceinline__ void mbar_more(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// the box at (column, head, row, batch) of a (B, S, heads, dh) tensor map
// into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& m,
                                         int col, int head, int row,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&m)), "r"(col),
         "r"(head), "r"(row), "r"(batch), "r"(bar) : "memory");
}

// shared-memory writes of this thread become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x on the MUFU: ex2.approx, relative error below 2^-22, denormal
// results flushed to 0 (exp2f adds range fix-ups around the same op)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses to accumulator registers across
// an asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Descriptor of a 128-byte-swizzled operand at shared address `addr`
// (1024-byte atoms of 8 rows x 128 B). Both byte offsets are 1024, the
// stride between 8-row groups: a K-major operand reads only that one, and
// an MN-major one never spans two 64-element column blocks here (its N is
// at most 64), so whichever field holds the group stride, it is right.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  constexpr uint64_t kOff = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (kOff << 16) | (kOff << 32) |
         (1ull << 62);
}

// wgmma m64nNk16, bfloat16 in, float32 accumulated in d[N / 2]:
// ss reads A and B through shared-memory descriptors (both K-major),
// rs takes A from four registers and B (MN-major, transposed) through
// a descriptor and always accumulates (scale-d 1).
template <int N> struct Wg;
template <> struct Wg<8> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};
template <> struct Wg<16> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};
template <> struct Wg<24> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};
template <> struct Wg<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};
template <> struct Wg<40> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};
template <> struct Wg<48> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};
template <> struct Wg<56> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};
template <> struct Wg<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(1));
  }
};

// Rows [0, R) of a tile whose row 0 is at `src`, rows `rs` elements apart
// and `nrows` of them inside the tensor, into NCB = ceil(NCH / 8) column
// blocks of R rows x 128 B at shared address `dst`, in the 128-byte
// swizzle: the 16-byte chunk c of row r lands in block c / 8 at byte
// r * 128 + ((c % 8) ^ (r % 8)) * 16. NCH chunks a row are filled, zero
// past nrows and past dh. Copies of VB bytes: cp.async for 16, 8 and 4,
// a plain load and store for 2.
template <int R, int NCH, int VB>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          long long rs, int nrows, int dh) {
  constexpr int PER = 16 / VB, N = R * NCH * PER;   // copies a chunk, all
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int r = i / (NCH * PER), c = i % (NCH * PER) / PER;
    const int pc = i % PER, col = c * 8 + pc * (VB / 2);
    const int bytes = r < nrows ? max(0, min(VB, 2 * (dh - col))) : 0;
    const bf16* g = bytes ? src + r * rs + col : src;
    const uint32_t s = dst + (c >> 3) * (R * 128) + r * 128 +
                       (((c & 7) ^ (r & 7)) << 4) + pc * VB;
    if constexpr (VB >= 4) {
      cp_async<VB>(s, g, bytes);
    } else {
      const unsigned short x =
          bytes ? *reinterpret_cast<const unsigned short*>(g) : 0;
      asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(s), "h"(x)
                   : "memory");
    }
  }
}

template <int R, int NCH>
__device__ __forceinline__ void load(int vb, uint32_t dst, const bf16* src,
                                     long long rs, int nrows, int dh) {
  switch (vb) {
    case 16: load_rows<R, NCH, 16>(dst, src, rs, nrows, dh); break;
    case 8: load_rows<R, NCH, 8>(dst, src, rs, nrows, dh); break;
    case 4: load_rows<R, NCH, 4>(dst, src, rs, nrows, dh); break;
    default: load_rows<R, NCH, 2>(dst, src, rs, nrows, dh); break;
  }
}

// O[:, 64 NB:] += P V for one 16-key step: one wgmma of up to 64 columns
// per column block of V, A = the four P registers
template <int DHN, int NB = 0>
__device__ __forceinline__ void pv(float* o, const uint32_t* p, uint32_t v) {
  if constexpr (NB * 64 < DHN) {
    constexpr int N = DHN - NB * 64 < 64 ? DHN - NB * 64 : 64;
    Wg<N>::rs(o + NB * 32, p, desc(v + NB * (kBK * 128)));
    pv<DHN, NB + 1>(o, p, v);
  }
}

template <int DHN>
struct Shape {
  static constexpr int DHK = (DHN + 15) / 16 * 16;  // QK^T depth
  static constexpr int NCH = DHK / 8;               // 16-byte chunks a row
  static constexpr int NCB = (DHK + 63) / 64;       // 128-byte blocks a row
  static constexpr int QB = NCB * kBQ * 128;        // q tile bytes
  static constexpr int KB = NCB * kBK * 128;        // K (or V) tile bytes
  static constexpr int SMEM = 1024 + QB + 4 * KB;   // q, 2 x (K, V)
};

// the live key tiles [j0, j1) of query rows [r0, r0 + 64): empty past Sq
__device__ __forceinline__ void band(const Args& a, int r0, int& j0,
                                     int& j1) {
  j0 = 0;
  j1 = (a.Skv + kBK - 1) / kBK;
  if (r0 >= a.Sq) {
    j1 = 0;
    return;
  }
  const int r1 = min(r0 + 64, a.Sq) - 1;
  if (a.causal) j1 = min(j1, r1 / kBK + 1);
  if (a.has_window) {
    const long long first = (long long)r0 - a.window + 1;  // least key
    if (first > 0) j0 = (int)min(first / kBK, (long long)j1);
  }
}

// Tensor maps of q, k and v for TMA
struct Maps {
  CUtensorMap q, k, v;
};

// TMA: q, k and v come by TMA through `maps`; else (a pointer or stride
// not 16-byte aligned, or a map cuTensorMapEncodeTiled refuses) every
// thread copies with cp.async, `vb` bytes a copy.
// Two blocks an SM where TMA leaves a narrow head enough of 128 registers;
// the cp.async copies would spill there.
template <int DHN, bool TMA>
__global__ void __launch_bounds__(kThreads, TMA && DHN <= 64 ? 2 : 1)
flash_kernel(Args a, int vb, const __grid_constant__ Maps maps) {
  using Sh = Shape<DHN>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2];   // the ring's stages, by TMA
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Sh::QB, sv = sk + 2 * Sh::KB;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  // the last query tiles first: under a causal mask they have most keys
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;

  // this warpgroup's band and the block's (the union of both)
  const int r0w = q_lo + 64 * wg;
  int j0, j1, o0, o1;
  band(a, r0w, j0, j1);
  band(a, q_lo + 64 * (1 - wg), o0, o1);
  const int J0 = j1 > j0 && o1 > o0 ? min(j0, o0) : j1 > j0 ? j0 : o0;
  const int J1 = max(j1, o1);
  const int rlast = min(r0w + 64, a.Sq) - 1;
  // Tile jt into ring stage `st`: by TMA, one thread for the block,
  // completing on full[st]; else by cp.async from every thread, one group.
  const uint32_t bar0 = smem_u32(&full[0]);
  auto load_kv = [&](int jt, int st) {
    const int k_lo = jt * kBK;
    if constexpr (TMA) {
      if (tid == 0) {
        mbar_expect(bar0 + 8 * st, 2 * Sh::KB);
#pragma unroll
        for (int cb = 0; cb < Sh::NCB; ++cb) {
          tma_load(sk + st * Sh::KB + cb * (kBK * 128), maps.k, 64 * cb, kvh,
                   k_lo, b, bar0 + 8 * st);
          tma_load(sv + st * Sh::KB + cb * (kBK * 128), maps.v, 64 * cb, kvh,
                   k_lo, b, bar0 + 8 * st);
        }
      }
    } else {
      load<kBK, Sh::NCH>(vb, sk + st * Sh::KB, kp + k_lo * a.kss, a.kss,
                         a.Skv - k_lo, a.dh);
      load<kBK, Sh::NCH>(vb, sv + st * Sh::KB, vp + k_lo * a.vss, a.vss,
                         a.Skv - k_lo, a.dh);
      cp_async_commit();
    }
  };
  // the q tile with the first key tile (nothing where no key is live)
  if constexpr (TMA) {
    if (J0 < J1 && tid == 0) {
      mbar_init(bar0);
      mbar_init(bar0 + 8);
      mbar_more(bar0, Sh::QB);     // load_kv(J0, 0) arrives on it
#pragma unroll
      for (int cb = 0; cb < Sh::NCB; ++cb)
        tma_load(sq + cb * (kBQ * 128), maps.q, 64 * cb, h, q_lo, b, bar0);
    }
    __syncthreads();          // the barriers are initialised
  } else if (J0 < J1) {
    load<kBQ, Sh::NCH>(vb, sq, qp + q_lo * a.qss, a.qss, a.Sq - q_lo, a.dh);
  }
  if (J0 < J1) load_kv(J0, 0);

  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)
  const int row0 = r0w + 16 * warp + (lane >> 2);    // and row0 + 8
  float o[DHN / 2];
#pragma unroll
  for (int i = 0; i < DHN / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int jt = J0; jt < J1; ++jt) {
    // stage (jt - J0) % 2, used for the ((jt - J0) / 2)-th time
    const int stage = (jt - J0) & 1;
    if constexpr (TMA) {
      mbar_wait(bar0 + 8 * stage, ((jt - J0) >> 1) & 1);
    } else {
      cp_async_wait_all();
      fence_proxy_async();
    }
    __syncthreads();          // tile jt is in; tile jt - 1 is consumed
    if (jt + 1 < J1) load_kv(jt + 1, stage ^ 1);
    if (jt < j0 || jt >= j1) continue;      // uniform in the warpgroup

    // S = Q K^T over DHK / 16 steps of 16
    const uint32_t kt = sk + stage * Sh::KB, vt = sv + stage * Sh::KB;
    float s[kBK / 2];                       // the first step overwrites
    fence_regs<kBK / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Sh::DHK / 16; ++kk)
      Wg<kBK>::ss(s,
                  desc(sq + (kk >> 2) * (kBQ * 128) + wg * (64 * 128) +
                       (kk & 3) * 32),
                  desc(kt + (kk >> 2) * (kBK * 128) + (kk & 3) * 32),
                  kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kBK / 2>(s);

    // s[4 n + e]: row row0 + 8 (e / 2), key k_lo + 8 n + 2 (lane % 4) +
    // e % 2. Edge tiles scale and mask in place (sc = 1); interior tiles
    // keep raw scores and fold the scale into exp2's argument (sc = sl2).
    // m, l and the exponents are in log2 units.
    const int k_lo = jt * kBK;
    float sc = sl2;
    if (k_lo + kBK > a.Skv || (a.causal && k_lo + kBK - 1 > r0w) ||
        (a.has_window && (long long)rlast - k_lo >= a.window)) {
      sc = 1.f;
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int key = k_lo + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        s[i] *= sl2;
        if (key >= a.Skv)
          s[i] = -INFINITY;
        else if ((a.causal && row < key) ||
                 (a.has_window && (long long)row - key >= a.window))
          s[i] = kNegInf;
      }
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      if (i & 2) x1 = fmaxf(x1, s[i]);
      else x0 = fmaxf(x0, s[i]);
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, sh));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, sh));
    }
    const float n0 = fmaxf(m0, x0 * sc), n1 = fmaxf(m1, x1 * sc);
    const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= c0;
    l1 *= c1;
    // p split into bfloat16 hi + lo, packed as the A registers of P V
    uint32_t ph[kBK / 4], pl[kBK / 4];
#pragma unroll
    for (int i = 0; i < kBK / 2; i += 2) {
      const float mx = (i & 2) ? n1 : n0;
      const float p0 = ex2(fmaf(s[i], sc, -mx));
      const float p1 = ex2(fmaf(s[i + 1], sc, -mx));
      if (i & 2) l1 += p0 + p1;
      else l0 += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
      ph[i / 2] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[i / 2] = *reinterpret_cast<const uint32_t*>(&lo);
    }
    if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
      for (int i = 0; i < DHN / 2; ++i) o[i] *= (i & 2) ? c1 : c0;
    }

    // O += P_hi V + P_lo V, over kBK / 16 steps of 16 keys
    fence_regs<DHN / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pv<DHN>(o, ph + 4 * kk, vt + kk * (16 * 128));
      pv<DHN>(o, pl + 4 * kk, vt + kk * (16 * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<DHN / 2>(o);
  }

  // publish: out is a contiguous (B, Sq, H, dh); o[4 n + e] is column
  // 8 n + 2 (lane % 4) + e % 2 of row row0 + 8 (e / 2)
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float li[2] = {fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f)};
  bf16* op = static_cast<bf16*>(a.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = row0 + 8 * half;
    if (qpos >= a.Sq) continue;
    bf16* row = op + (((long long)b * a.Sq + qpos) * a.H + h) * a.dh;
#pragma unroll
    for (int n = 0; n < DHN / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      const float y0 = o[4 * n + 2 * half] / li[half];
      const float y1 = o[4 * n + 2 * half + 1] / li[half];
      if ((a.dh & 1) == 0 && d + 1 < a.dh) {
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(y0, y1);
      } else {
        if (d < a.dh) row[d] = __float2bfloat16_rn(y0);
        if (d + 1 < a.dh) row[d + 1] = __float2bfloat16_rn(y1);
      }
    }
  }
}

template <int DHN, bool TMA>
cudaError_t launch_tma(const Args& a, int vb, const Maps& maps,
                       cudaStream_t stream) {
  const int smem = Shape<DHN>::SMEM;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DHN, TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + kBQ - 1) / kBQ);
  flash_kernel<DHN, TMA><<<grid, kThreads, smem, stream>>>(a, vb, maps);
  return cudaGetLastError();
}

template <int DHN>
cudaError_t launch_dhn(const Args& a, int vb, bool tma, const Maps& maps,
                       cudaStream_t stream) {
  return tma ? launch_tma<DHN, true>(a, vb, maps, stream)
             : launch_tma<DHN, false>(a, vb, maps, stream);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime (so the
// library needs no link against libcuda); null where there is none.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map of a (B, S, heads, dh) bfloat16 tensor with the given element
// strides, read in boxes of 64 columns (128 B) x `rows` rows of one head,
// 128-byte swizzled as the wgmma descriptors read them, zero outside the
// tensor. False where cuTensorMapEncodeTiled refuses it (a stride it
// cannot take).
bool encode(CUtensorMap* m, const void* base, int dh, int heads, int S,
            int B, long long sh, long long ss, long long sb, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dim[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                             (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dim, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the widest copy (16, 8, 4 or 2 bytes) that every pointer and stride of
// q, k and v allows
int copy_bytes(const Args& a) {
  unsigned long long g = (unsigned long long)(uintptr_t)a.q |
                         (uintptr_t)a.k | (uintptr_t)a.v;
  for (long long s : {a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb,
                      a.vss, a.vsh})
    g |= (unsigned long long)s * 2;
  return (g & 15) == 0 ? 16 : (g & 7) == 0 ? 8 : (g & 3) == 0 ? 4 : 2;
}

#define FLASH_DHN(X)                                                      \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(72) X(80) X(88) X(96)  \
  X(104) X(112) X(120) X(128) X(136) X(144) X(152) X(160) X(168) X(176)   \
  X(184) X(192) X(200) X(208) X(216) X(224) X(232) X(240) X(248) X(256)

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int vb = copy_bytes(a);
  Maps maps{};
  const bool tma = vb == 16 &&
             encode(&maps.q, a.q, a.dh, a.H, a.Sq, a.B, a.qsh, a.qss, a.qsb,
                    kBQ) &&
             encode(&maps.k, a.k, a.dh, a.KV, a.Skv, a.B, a.ksh, a.kss,
                    a.ksb, kBK) &&
             encode(&maps.v, a.v, a.dh, a.KV, a.Skv, a.B, a.vsh, a.vss,
                    a.vsb, kBK);
  switch ((a.dh + 7) / 8 * 8) {
#define FLASH_CASE(n) \
    case n: return launch_dhn<n>(a, vb, tma, maps, stream);
    FLASH_DHN(FLASH_CASE)
#undef FLASH_CASE
    default: return cudaErrorInvalidValue;
  }
}

size_t smem_bytes(int dh) {
  switch ((dh + 7) / 8 * 8) {
#define FLASH_CASE(n) \
    case n: return Shape<n>::SMEM;
    FLASH_DHN(FLASH_CASE)
#undef FLASH_CASE
    default: return 0;
  }
}

}  // namespace tc

// ------------------------------------------- float32: 3xTF32 tensor cores

namespace f32 {

constexpr int kThreads = 128;       // one consumer warpgroup
constexpr int kBQ = 64;             // queries per block
constexpr int kMaxSmem = 232448;    // shared memory one block may opt in to
constexpr int kSmemSM = 233472;     // shared memory of an SM
constexpr int kReserved = 1024;     // of it, reserved for each block

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as the float32 whose low 13 bits are 0
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo to about 22 bits: hi = tf32(x), lo = tf32(x - hi), where
// x - hi is exact in float32
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32(x);
  lo = tf32(x - hi);
}

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// wgmma m64nNk8, TF32 in, float32 accumulated in d[N / 2], or d
// overwritten where acc is 0: ss reads A and B through shared-memory
// descriptors (both K-major, the only major TF32 takes there), rs takes A
// from four registers.
template <int N> struct Wt;
template <> struct Wt<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <> struct Wt<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// Blocks an SM holds by registers: the launch bound promises this many
// (ptxas may then use up to 65536 / (kBlocksRegs * kThreads) registers a
// thread; chip_smoke.py's phase 1 prints what it used), and the layout
// below counts no more.
constexpr int kBlocksRegs = 2;

// A block's shared memory: 1024 bytes to align the data to 1024 (the
// mbarriers live in them), Q_hi, Q_lo and `tiles` buffers of one K or V
// tile of `bk` keys; and how many such blocks an SM holds.
constexpr int smem_for(int dhp, int bk, int tiles) {
  return 1024 + 2 * kBQ * dhp * 4 + tiles * bk * dhp * 4;
}
constexpr int blocks_per_sm(int smem) {
  return smem > kMaxSmem ? 0
         : kSmemSM / (smem + kReserved) < kBlocksRegs
             ? kSmemSM / (smem + kReserved)
             : kBlocksRegs;
}

// Each block's split, softmax and transpose are serial with its own
// products; other blocks' products are what they overlap, so the layout
// at (DHP, BK) is the one that lets most blocks share an SM, this one
// where both do. SEP: V^T in two buffers of its own beside (K, K_lo, V),
// so that V's transpose runs under S's products and tile j + 1 loads
// under this tile's softmax and P V. Else V^T goes into K's buffers once
// S has read them, and tile j + 1 loads after P V.
template <int DHP, int BK>
struct Layout {
  static constexpr bool SEP = blocks_per_sm(smem_for(DHP, BK, 5)) >=
                              blocks_per_sm(smem_for(DHP, BK, 3));
  static constexpr int SMEM = smem_for(DHP, BK, SEP ? 5 : 3);
};

template <int DHP>
struct Shape {
  // Keys per tile: 64 where two blocks of them still share an SM (dh <=
  // 64: each k-step of S then reads its Q_hi / Q_lo slice from shared
  // memory for 64 keys instead of 32), else 32.
  static constexpr int BK =
      blocks_per_sm(Layout<DHP, 64>::SMEM) >= 2 ? 64 : 32;
  static constexpr bool SEP = Layout<DHP, BK>::SEP;
  static constexpr int SMEM = Layout<DHP, BK>::SMEM;
  static constexpr int DATA = SMEM - 1024;
  static constexpr int NCB = DHP / 32;              // 128-byte blocks a row
  static constexpr int QB = kBQ * DHP * 4;          // Q_hi (or Q_lo) bytes
  static constexpr int KB = BK * DHP * 4;           // a K, K_lo or V tile
};

// the live BK-key tiles [j0, j1) of query rows [q_lo, q_lo + kBQ)
template <int BK>
__device__ __forceinline__ void band(const Args& a, int q_lo, int& j0,
                                     int& j1) {
  j0 = 0;
  j1 = (a.Skv + BK - 1) / BK;
  const int r1 = min(q_lo + kBQ, a.Sq) - 1;
  if (a.causal) j1 = min(j1, r1 / BK + 1);
  if (a.has_window) {
    const long long first = (long long)q_lo - a.window + 1;  // least key
    if (first > 0) j0 = (int)min(first / BK, (long long)j1);
  }
}

// Rows [0, R) of a tile whose row 0 is at `src`, rows `rs` elements apart
// and `nrows` of them inside the tensor, into NCB column blocks of R rows
// x 128 B at shared address `dst`, as TMA's 128-byte swizzle puts them:
// the 16-byte chunk c (4 floats) of row r lands in block c / 8 at byte
// r * 128 + ((c % 8) ^ (r % 8)) * 16; zero past nrows and past dh. By
// cp.async of VB bytes (16, 8 or 4).
template <int R, int NCB, int VB>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src,
                                          long long rs, int nrows, int dh) {
  constexpr int PER = 16 / VB, N = R * NCB * 8 * PER;
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const int r = i / (NCB * 8 * PER), c = i % (NCB * 8 * PER) / PER;
    const int pc = i % PER, col = c * 4 + pc * (VB / 4);
    const int bytes = r < nrows ? max(0, min(VB, 4 * (dh - col))) : 0;
    const float* g = bytes ? src + r * rs + col : src;
    tc::cp_async<VB>(dst + (c >> 3) * (R * 128) + r * 128 +
                         (((c & 7) ^ (r & 7)) << 4) + pc * VB,
                     g, bytes);
  }
}

template <int R, int NCB>
__device__ __forceinline__ void load(int vb, uint32_t dst, const float* src,
                                     long long rs, int nrows, int dh) {
  switch (vb) {
    case 16: load_rows<R, NCB, 16>(dst, src, rs, nrows, dh); break;
    case 8: load_rows<R, NCB, 8>(dst, src, rs, nrows, dh); break;
    default: load_rows<R, NCB, 4>(dst, src, rs, nrows, dh); break;
  }
}

// The N 16-byte chunks at `x` split in place: x = tf32(v) and, at `lo`,
// tf32(v - tf32(v)), for v = x (times `scale` where SCALE). Both tiles
// keep the same swizzled layout, so the split goes chunk by chunk.
template <bool SCALE, int N>
__device__ __forceinline__ void split_tile(unsigned char* x,
                                           unsigned char* lo, float scale) {
  float4* xv = reinterpret_cast<float4*>(x);
  float4* lv = reinterpret_cast<float4*>(lo);
  for (int i = threadIdx.x; i < N; i += kThreads) {
    float4 v = xv[i], h, l;
    if (SCALE) {
      v.x = __fmul_rn(v.x, scale);
      v.y = __fmul_rn(v.y, scale);
      v.z = __fmul_rn(v.z, scale);
      v.w = __fmul_rn(v.w, scale);
    }
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    xv[i] = h;
    lv[i] = l;
  }
}

// V's tile as loaded ([key][d] at `vr`, BK rows) into V^T_hi at `vh` and
// V^T_lo at `vl`, K-major for P V: row d of BK / 32 blocks of DHP rows x
// 128 B, block kb holding key slots [32 kb, 32 kb + 32), 16-byte chunk c
// of row d at ((c ^ (d % 8)) * 16). In each group of 8 slots, slot j
// holds key 2 j (j < 4) or 2 (j - 4) + 1 (j >= 4), so that A-fragment
// columns t and t + 4 are the S accumulator's keys 2 t and 2 t + 1. One
// unit: keys 8 n + e + 2 i (i < 4) x 4 columns, read as four 16-byte rows
// and written as four 16-byte slot chunks per half. The unit map keeps
// every 8-thread phase of those 16-byte accesses on 8 distinct bank
// groups, reads and writes alike.
template <int DHP, int BK>
__device__ __forceinline__ void transpose_v(const unsigned char* vr,
                                            unsigned char* vh,
                                            unsigned char* vl) {
  constexpr int UNITS = (BK / 4) * (DHP / 4), NH = BK / 32;
  for (int u = threadIdx.x; u < UNITS; u += kThreads) {
    const int e = u & 1, nl = (u >> 1) & 3, p = u >> 3, rest = p >> 3;
    const int n = nl + 4 * (rest % NH), cb = rest / NH;
    const int cc = ((((nl >> 1) ^ (p >> 1)) & 1) << 2) |
                   ((((nl & 1) ^ (p >> 2)) & 1) << 1) | (p & 1);
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 8 * n + e + 2 * i;
      const float4 v = *reinterpret_cast<const float4*>(
          vr + cb * (BK * 128) + r * 128 + ((cc ^ (r & 7)) << 4));
      x[i][0] = v.x;
      x[i][1] = v.y;
      x[i][2] = v.z;
      x[i][3] = v.w;
    }
    const int sc = 2 * n + e, kb = sc >> 3;       // slot chunk, its block
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const int d = 32 * cb + 4 * cc + dd;
      const int off = kb * (DHP * 128) + d * 128 + (((sc & 7) ^ (d & 7)) << 4);
      float4 h, l;
      split(x[0][dd], h.x, l.x);
      split(x[1][dd], h.y, l.y);
      split(x[2][dd], h.z, l.z);
      split(x[3][dd], h.w, l.w);
      *reinterpret_cast<float4*>(vh + off) = h;
      *reinterpret_cast<float4*>(vl + off) = l;
    }
  }
}

// t[0, N / 2) = (t +) P V^T over rows [0, N) of V^T at `v` for one 8-key
// step: one wgmma of up to 64 columns per 64 rows of V^T (N is a multiple
// of 32), A = the four P registers; t overwritten where acc is 0
template <int N, int NB = 0>
__device__ __forceinline__ void pv(float* t, const uint32_t* p, uint32_t v,
                                   int acc) {
  if constexpr (NB * 64 < N) {
    if constexpr (N - NB * 64 >= 64)
      Wt<64>::rs(t + NB * 32, p, tc::desc(v + NB * (64 * 128)), acc);
    else
      Wt<32>::rs(t + NB * 32, p, tc::desc(v + NB * (64 * 128)), acc);
    pv<N, NB + 1>(t, p, v, acc);
  }
}

// O = O c + P_hi V^T_hi + P_hi V^T_lo + P_lo V^T_hi for one tile, up to
// 128 columns at a time from column C0: the tile's product runs as one
// chain of 3 BK / 8 wgmma steps into a fresh accumulator t and joins O by
// FFMA, so that no wgmma chain grows with the band.
template <int DHP, int BK, int C0 = 0>
__device__ __forceinline__ void pv_tile(float* o, const uint32_t* ph,
                                        const uint32_t* pl, uint32_t vth,
                                        uint32_t vtl, float c0, float c1) {
  if constexpr (C0 < DHP) {
    constexpr int N = DHP - C0 < 128 ? DHP - C0 : 128;
    float t[N / 2];                        // the first step overwrites
    tc::fence_regs<N / 2>(t);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t vo = C0 * 128 + (kk >> 2) * (DHP * 128) + (kk & 3) * 32;
      pv<N>(t, ph + 4 * kk, vth + vo, kk > 0);
      pv<N>(t, ph + 4 * kk, vtl + vo, 1);
      pv<N>(t, pl + 4 * kk, vth + vo, 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs<N / 2>(t);
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      o[C0 / 2 + i] = fmaf(o[C0 / 2 + i], (i & 2) ? c1 : c0, t[i]);
    pv_tile<DHP, BK, C0 + N>(o, ph, pl, vth, vtl, c0, c1);
  }
}

// TMA: q, k and v come by TMA through `maps`; else every thread copies
// with cp.async, `vb` bytes a copy.
template <int DHP>
__global__ void __launch_bounds__(kThreads, kBlocksRegs)
flash_kernel(Args a, int vb, int tma, const __grid_constant__ tc::Maps maps) {
  using Sh = Shape<DHP>;
  constexpr int BK = Sh::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  // Q_hi, Q_lo, K (K_hi once split, V^T_hi once P V is next), K_lo
  // (V^T_lo), V as loaded, then V^T_hi and V^T_lo where SEP
  const uint32_t sqh = (raw + 1023) & ~1023u, sql = sqh + Sh::QB;
  const uint32_t kt = sql + Sh::QB, kl = kt + Sh::KB, vr = kl + Sh::KB;
  const uint32_t vth = Sh::SEP ? vr + Sh::KB : kt, vtl = vth + Sh::KB;
  // the loads' mbarrier (TMA) in the 1024 bytes of alignment: before the
  // data where they leave 8 bytes there, else after it; no static shared
  // memory, so that dh 128 fits two blocks an SM
  const uint32_t bar = sqh - raw >= 8 ? raw : sqh + Sh::DATA;
  auto at = [&](uint32_t addr) { return smem_raw + (addr - raw); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  // the last query tiles first: under a causal mask they have most keys
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qp = static_cast<const float*>(a.q) + b * a.qsb + h * a.qsh;
  const float* kp = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vp = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;
  int j0, j1;
  band<BK>(a, q_lo, j0, j1);
  const int rlast = min(q_lo + kBQ, a.Sq) - 1;
  // Tile jt into K's and V's buffers: by TMA, one thread for the block,
  // completing on the mbarrier; else by cp.async from every thread, one
  // group.
  auto load_kv = [&](int jt) {
    const int k_lo = jt * BK;
    if (tma) {
      if (tid == 0) {
        tc::mbar_expect(bar, 2 * Sh::KB);
#pragma unroll
        for (int cb = 0; cb < Sh::NCB; ++cb) {
          tc::tma_load(kt + cb * (BK * 128), maps.k, 32 * cb, kvh, k_lo, b,
                       bar);
          tc::tma_load(vr + cb * (BK * 128), maps.v, 32 * cb, kvh, k_lo, b,
                       bar);
        }
      }
    } else {
      load<BK, Sh::NCB>(vb, kt, kp + k_lo * a.kss, a.kss, a.Skv - k_lo,
                         a.dh);
      load<BK, Sh::NCB>(vb, vr, vp + k_lo * a.vss, a.vss, a.Skv - k_lo,
                         a.dh);
      tc::cp_async_commit();
    }
  };
  // the q tile with the first key tile (nothing where no key is live)
  if (j0 < j1) {
    if (tma) {
      if (tid == 0) {
        tc::mbar_init(bar);
        tc::mbar_more(bar, Sh::QB);      // load_kv(j0) arrives on it
#pragma unroll
        for (int cb = 0; cb < Sh::NCB; ++cb)
          tc::tma_load(sqh + cb * (kBQ * 128), maps.q, 32 * cb, h, q_lo, b,
                       bar);
      }
    } else {
      load<kBQ, Sh::NCB>(vb, sqh, qp + q_lo * a.qss, a.qss, a.Sq - q_lo,
                         a.dh);
    }
    load_kv(j0);
  }
  __syncthreads();            // the barrier is initialised

  constexpr float kLog2e = 1.4426950408889634f;
  const int row0 = q_lo + 16 * warp + (lane >> 2);   // and row0 + 8
  float o[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int jt = j0; jt < j1; ++jt) {
    const int it = jt - j0;   // the barrier's (it + 1)-th phase
    if (tma) {
      tc::mbar_wait(bar, it & 1);
    } else {
      tc::cp_async_wait_all();
      __syncthreads();        // every thread's copies of tile jt are in
    }

    // the operands split once: Q (scaled) with the first tile, K here
    if (it == 0) split_tile<true, Sh::QB / 16>(at(sqh), at(sql), a.scale);
    split_tile<false, Sh::KB / 16>(at(kt), at(kl), 1.f);
    tc::fence_proxy_async();
    __syncthreads();

    // S = Q_hi K_hi^T + (Q_hi K_lo^T + Q_lo K_hi^T) over DHP / 8 steps of
    // 8: the hi chain in s, the lo chain in s2, added by FADD (so that
    // the large sum takes DHP / 8 rounded steps, not 3 DHP / 8)
    float s[BK / 2], s2[BK / 2];           // the first step overwrites
    tc::fence_regs<BK / 2>(s);
    tc::fence_regs<BK / 2>(s2);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 8; ++kk) {
      const uint32_t qo = (kk >> 2) * (kBQ * 128) + (kk & 3) * 32;
      const uint32_t ko = (kk >> 2) * (BK * 128) + (kk & 3) * 32;
      Wt<BK>::ss(s, tc::desc(sqh + qo), tc::desc(kt + ko), kk > 0);
      Wt<BK>::ss(s2, tc::desc(sqh + qo), tc::desc(kl + ko), kk > 0);
      Wt<BK>::ss(s2, tc::desc(sql + qo), tc::desc(kt + ko), 1);
    }
    tc::wgmma_commit();
    if constexpr (Sh::SEP) {
      // V^T split and key-permuted into its buffers while S runs (P V of
      // tile jt - 1 finished reading them before the barrier above)
      transpose_v<DHP, BK>(at(vr), at(vth), at(vtl));
      tc::fence_proxy_async();
    }
    tc::wgmma_wait_all();
    tc::fence_regs<BK / 2>(s);
    tc::fence_regs<BK / 2>(s2);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] += s2[i];
    if (Sh::SEP) {
      __syncthreads();        // S has read K, V^T is written, V is read
      if (jt + 1 < j1) load_kv(jt + 1);
    }

    // s[4 n + e]: row row0 + 8 (e / 2), key k_lo + 8 n + 2 (lane % 4) +
    // e % 2, already scaled (q was). Edge tiles take log2(e) and the mask
    // in place (sc = 1); interior tiles fold log2(e) into exp2's argument
    // (sc = log2(e)). m, l and the exponents are in log2 units.
    const int k_lo = jt * BK;
    float sc = kLog2e;
    if (k_lo + BK > a.Skv || (a.causal && k_lo + BK - 1 > q_lo) ||
        (a.has_window && (long long)rlast - k_lo >= a.window)) {
      sc = 1.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = k_lo + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        s[i] *= kLog2e;
        if (key >= a.Skv)
          s[i] = -INFINITY;
        else if ((a.causal && row < key) ||
                 (a.has_window && (long long)row - key >= a.window))
          s[i] = kNegInf;
      }
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (i & 2) x1 = fmaxf(x1, s[i]);
      else x0 = fmaxf(x0, s[i]);
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, sh));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, sh));
    }
    const float n0 = fmaxf(m0, x0 * sc), n1 = fmaxf(m1, x1 * sc);
    const float c0 = tc::ex2(m0 - n0), c1 = tc::ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= c0;
    l1 *= c1;
    // p split into TF32 hi + lo, as the A registers of P V^T: per 8-key
    // group, (row g, column t) = key 2 t, (g + 8, t), (g, t + 4) = key
    // 2 t + 1, (g + 8, t + 4), with g = lane / 4 and t = lane % 4
    uint32_t ph[BK / 2], pl[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 4) {
      const float p0 = tc::ex2(fmaf(s[i], sc, -n0));
      const float p1 = tc::ex2(fmaf(s[i + 1], sc, -n0));
      const float p2 = tc::ex2(fmaf(s[i + 2], sc, -n1));
      const float p3 = tc::ex2(fmaf(s[i + 3], sc, -n1));
      l0 += p0 + p1;
      l1 += p2 + p3;
      const float pf[4] = {p0, p2, p1, p3};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float hi, lo;
        split(pf[r], hi, lo);
        ph[i + r] = __float_as_uint(hi);
        pl[i + r] = __float_as_uint(lo);
      }
    }

    if constexpr (!Sh::SEP) {
      // V^T split and key-permuted into the K and K_lo buffers, which S
      // has finished reading
      __syncthreads();
      transpose_v<DHP, BK>(at(vr), at(vth), at(vtl));
      tc::fence_proxy_async();
      __syncthreads();
    }

    pv_tile<DHP, BK>(o, ph, pl, vth, vtl, c0, c1);
    fence_u32<BK / 2>(ph);
    fence_u32<BK / 2>(pl);
    if (!Sh::SEP && jt + 1 < j1) {
      __syncthreads();        // every warp's P V has read V^T
      load_kv(jt + 1);
    }
  }

  // publish: out is a contiguous (B, Sq, H, dh); o[4 n + e] is column
  // 8 n + 2 (lane % 4) + e % 2 of row row0 + 8 (e / 2)
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, sh);
    l1 += __shfl_xor_sync(0xffffffffu, l1, sh);
  }
  const float li[2] = {fmaxf(l0, 1e-30f), fmaxf(l1, 1e-30f)};
  float* op = static_cast<float*>(a.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = row0 + 8 * half;
    if (qpos >= a.Sq) continue;
    float* row = op + (((long long)b * a.Sq + qpos) * a.H + h) * a.dh;
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n) {
      const int d = 8 * n + 2 * (lane & 3);
      const float y0 = o[4 * n + 2 * half] / li[half];
      const float y1 = o[4 * n + 2 * half + 1] / li[half];
      if ((a.dh & 1) == 0 && d + 1 < a.dh) {
        *reinterpret_cast<float2*>(row + d) = make_float2(y0, y1);
      } else {
        if (d < a.dh) row[d] = y0;
        if (d + 1 < a.dh) row[d + 1] = y1;
      }
    }
  }
}

bool encode(CUtensorMap* m, const void* base, int dh, int heads, int S,
            int B, long long sh, long long ss, long long sb, int rows);

template <int DHP>
cudaError_t launch_dhp(const Args& a, int vb, cudaStream_t stream) {
  constexpr int BK = Shape<DHP>::BK, smem = Shape<DHP>::SMEM;
  tc::Maps maps{};
  const bool tma = vb == 16 &&
             encode(&maps.q, a.q, a.dh, a.H, a.Sq, a.B, a.qsh, a.qss, a.qsb,
                    kBQ) &&
             encode(&maps.k, a.k, a.dh, a.KV, a.Skv, a.B, a.ksh, a.kss,
                    a.ksb, BK) &&
             encode(&maps.v, a.v, a.dh, a.KV, a.Skv, a.B, a.vsh, a.vss,
                    a.vsb, BK);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.Sq + kBQ - 1) / kBQ);
  flash_kernel<DHP><<<grid, kThreads, smem, stream>>>(a, vb, tma, maps);
  return cudaGetLastError();
}

// A map of a (B, S, heads, dh) float32 tensor with the given element
// strides, read in boxes of 32 columns (128 B) x `rows` rows of one head,
// 128-byte swizzled as the wgmma descriptors read them, zero outside the
// tensor. False where cuTensorMapEncodeTiled refuses it.
bool encode(CUtensorMap* m, const void* base, int dh, int heads, int S,
            int B, long long sh, long long ss, long long sb, int rows) {
  const tc::EncodeTiled fn = tc::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dim[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                             (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t stride[3] = {(cuuint64_t)sh * 4, (cuuint64_t)ss * 4,
                                (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base),
            dim, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the widest copy (16, 8 or 4 bytes) that every pointer and stride of q,
// k and v allows
int copy_bytes(const Args& a) {
  unsigned long long g = (unsigned long long)(uintptr_t)a.q |
                         (uintptr_t)a.k | (uintptr_t)a.v;
  for (long long s : {a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb,
                      a.vss, a.vsh})
    g |= (unsigned long long)s * 4;
  return (g & 15) == 0 ? 16 : (g & 7) == 0 ? 8 : 4;
}

// one instantiation per dh padded to 32
#define FLASH_F32_DHP(X) \
  X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256)

cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int vb = copy_bytes(a);
  switch ((a.dh + 31) / 32 * 32) {
#define FLASH_CASE(n) \
    case n: return launch_dhp<n>(a, vb, stream);
    FLASH_F32_DHP(FLASH_CASE)
#undef FLASH_CASE
    default: return cudaErrorInvalidValue;
  }
}

size_t smem_bytes(int dh) {
  switch ((dh + 31) / 32 * 32) {
#define FLASH_CASE(n) \
    case n: return Shape<n>::SMEM;
    FLASH_F32_DHP(FLASH_CASE)
#undef FLASH_CASE
    default: return 0;
  }
}

}  // namespace f32

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at head dimension `dh` for `dtype`
// (0: float32, 1: bfloat16).
size_t flash_attention_smem_bytes(int dh, int dtype) {
  return dtype == 1 ? tc::smem_bytes(dh) : f32::smem_bytes(dh);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out = attention(q, k, v) for q (B, Sq, H, dh) and k, v (B, Skv, KV, dh)
// of `dtype` (0: float32, 1: bfloat16) given by their batch, sequence and
// head strides in elements (the head dimension contiguous), into a
// contiguous (B, Sq, H, dh) out, on `stream`, on the calling thread's
// current device. dh <= 256, H % KV == 0; `scale` is float32(1/sqrt(dh));
// `window` is read when `has_window` is 1. Returns cudaGetLastError()
// after the launch (0 on success). Allocates nothing and does not
// synchronise.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int KV, int Sq, int Skv,
                           int dh, long long qsb, long long qss,
                           long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss,
                           long long vsh, float scale, int causal,
                           int has_window, long long window, int dtype,
                           void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 || dh < 1 ||
      dh > 256 || (long long)B * H > 0x7fffffffLL ||
      (Sq + f32::kBQ - 1) / f32::kBQ > 65535 ||
      (causal != 0 && causal != 1) ||
      (has_window != 0 && has_window != 1) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, H, KV, Sq, Skv, dh, qsb, qss, qsh, ksb,
               kss, ksh, vsb, vss, vsh, scale, causal, has_window, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? f32::launch(a, st) : tc::launch(a, st);
  return static_cast<int>(err);
}

}  // extern "C"
