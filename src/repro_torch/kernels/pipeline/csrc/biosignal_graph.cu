// The fused MBioTracker stage graph (FIR -> delineation -> interval time
// features + packed-rFFT band powers -> linear SVM) as one CUDA kernel for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (cuda.py).
//
// Replaces the TPU kernel bodies graph_kernel and graph_stream_kernel of
// src/repro/kernels/pipeline/graph.py:382/395, at their three pallas_call
// sites graph_frames_call (:479), graph_stream_call (:526) and
// graph_ring_call (:575). One kernel serves all three: frame f of slot r
// starts at x + r*slot_stride + f*frame_stride (frame_stride = window for
// pre-framed rows, hop for a raw signal; slot_stride = a ring's row stride).
//
// What bounds it on this card. Per frame of 2048 samples the graph reads
// 8 KB and does on the order of 1e5 float operations (11-tap FIR, three
// reductions, the extremum tests, the +-15-sample window at each candidate,
// a 256-point FFT). Over a whole recording that is operation-bound at the
// card's fp32 rate when only features/margin/class are written, and
// byte-bound when the (frames x window) filtered output is written too.
// Neither bound is near: a frame is a chain of dependent steps (load and
// filter, reduce, test, window, scan, select; the FFT passes and the band
// sums; the SVM), so what sets the time is the length of that chain at the
// default 8-frame dispatch, and the frames an SM holds at once over a
// recording.
//
// What the design does about it.
// - A frame is owned by kFrameThreads = T = 128 threads (four warps) that
//   sync only with each other, on named barriers: a block holds G =
//   min(block_frames, kMaxBlockThreads / T) such groups over its
//   block_frames frames (1 by default: a frame to an SM at 8 frames), and
//   nothing a frame computes depends on which frames share its block. The
//   only block-wide barrier is the one after the table barrier's init,
//   before any frame's work.
// - After the FIR the frame's chain forks: its first three warps delineate
//   (named barrier of 96) while its last warp runs the FFT, the untangle
//   and the band powers (__syncwarp alone), so the two chains overlap and
//   join once, for the SVM.
// - The tables (the used part of each twiddle row, compacted; untangle;
//   svm_w; svm_b) are copied to shared memory once a block with cp.async,
//   issued once each group's first frame has landed and awaited on an
//   mbarrier only by the FFT warp and the SVM.
// - The FIR runs from registers: thread i filters 16-byte vectors v = i +
//   T j with the NH vectors before each (the frame staged by 16-byte
//   cp.async where it lies on 16 bytes, by 4-byte copies elsewhere; one
//   order of products and sums for both), writes the filtered frame once to
//   shared memory and reduces its sum, max, min and FFT-segment sum on the
//   way. Two instantiations: the app's 11 taps exactly, held in
//   registers, and any count up to kMaxTaps, read through L1.
// - The extremum tests take 4 consecutive samples a thread; a warp ballot
//   appends the candidates to the warp's own segment of a per-frame list,
//   whose +-d windows are then shared out evenly over the delineation
//   threads (a minimum's samples
//   negated, so one running max serves both) and set the mask bits. The
//   gap scan runs on each thread's contiguous words of the two 1-bit
//   masks: one scan gives every extremum its predecessor and its rank, so
//   each gap goes to its place in a per-mask list. The lower median (k =
//   (n - 1) / 2) is taken by rank counting over that list, half of the
//   threads a mask (both n <= kRankMax), else by bisection on the gap
//   value with a count over the threads a step: exact for every n, no
//   (S + 1)-bin histogram.
// - The packed FFT runs fft_stages' radix-2 stages in groups of four in
//   registers: a pass over stages s0 .. s0 + L - 1 closes over 2^L points
//   (in_pos below), so each of min(32, m/16) threads holds 16 points, runs
//   the four stages (one loop body in constant geometry) with their own
//   twiddle rows and the plain version's rounding, and exchanges once
//   through padded shared memory (two buffers of the frame's own, beside
//   the filtered frame that the delineation still reads).
// Products and sums that the plain PyTorch version also computes
// elementwise (FIR, FFT stages, untangle, SVM) use explicit
// round-to-nearest intrinsics in its order, so `filtered`, the spectrum
// and the margin arithmetic match it without FMA contraction; the integer
// gap statistics are exact in any order. The delineation mean, the
// segment mean and the band sums reduce in another order. No fast-math:
// sqrtf, division and log1pf stay IEEE.
//
// The signal may be float32, bfloat16, float16, int16, int32, int8 or
// uint8 (the kernel is instantiated per element type, In). A frame of any
// other type than float32 is widened to float32 as it is staged (loads of
// 4 samples where
// the frame lies on 4 samples' bytes, of 1 elsewhere), as the reference
// stages it, so every step after the load is the float32 one; `filtered`
// is stored in the signal's own type: rounded to nearest even for a
// 16-bit float, truncated toward zero and saturated for an integer, which
// is the plain version's cast. A 16-bit signal halves the bytes the frame
// loads and the `filtered` stores move, an 8-bit one quarters them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/saturate.cuh"

namespace {

constexpr int kFrameThreads = 128;    // T: the threads of one frame
constexpr int kFftThreads = 32;       // the frame's warp that takes the FFT
constexpr int kMaxBlockThreads = 512;
constexpr int kFeatures = 12;
constexpr int kMaxTaps = 64;
constexpr int kMaxClasses = 32;
constexpr int kMaxWindow = 32767;     // positions and gaps fit 15 bits
constexpr int kRankMax = 64;          // gap lists ranked pairwise up to this
constexpr int kMaxSmemBytes = 232448;
constexpr unsigned kFull = 0xffffffffu;

// output selection bits (cuda.py keeps the same values)
constexpr int kOutFiltered = 1;
constexpr int kOutFeatures = 2;
constexpr int kOutMargin = 4;
constexpr int kOutClass = 8;

// signal element types (cuda.py keeps the same codes)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;
constexpr int kInt16 = 3;
constexpr int kInt32 = 4;
constexpr int kInt8 = 5;
constexpr int kUInt8 = 6;

// ---- the signal's element type In: loads widen to float32; stores of
// `filtered` round back to nearest even (bfloat16, float16) or, for an
// integer type (int8_t, uint8_t, int16_t, int32_t), truncate toward zero,
// saturated at the type's range with NaN to 0, as the plain version's cast
// and the reference's astype do (`saturate`, kernels/csrc/saturate.cuh).
// ld4/st4 take 4 samples that lie on 4 * sizeof(In) bytes. (The same
// helpers as asr_graph.cu's.)
template <class In>
constexpr bool kHalfFloat = std::is_same<In, __nv_bfloat16>::value ||
                            std::is_same<In, __half>::value;
template <class In>
__device__ __forceinline__ float widen(unsigned short b);
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
template <>
__device__ __forceinline__ float widen<__half>(unsigned short b) {
  return __half2float(__ushort_as_half(b));
}
template <class In>
__device__ __forceinline__ unsigned short narrow(float v);
template <>
__device__ __forceinline__ unsigned short narrow<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ unsigned short narrow<__half>(float v) {
  return __half_as_ushort(__float2half_rn(v));
}
template <class In>
__device__ __forceinline__ float ld1(const In* p) {
  if constexpr (std::is_same<In, float>::value) {
    return __ldg(p);
  } else if constexpr (kHalfFloat<In>) {
    return widen<In>(__ldg(reinterpret_cast<const unsigned short*>(p)));
  } else {
    return static_cast<float>(__ldg(p));
  }
}
template <class In>
__device__ __forceinline__ float4 ld4(const In* p) {
  if constexpr (std::is_same<In, float>::value) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else if constexpr (kHalfFloat<In>) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(widen<In>(u.x & 0xffffu), widen<In>(u.x >> 16),
                       widen<In>(u.y & 0xffffu), widen<In>(u.y >> 16));
  } else if constexpr (sizeof(In) == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    return make_float4(static_cast<float>(q.x), static_cast<float>(q.y),
                       static_cast<float>(q.z), static_cast<float>(q.w));
  } else if constexpr (sizeof(In) == 1 && std::is_signed<In>::value) {
    const char4 q = __ldg(reinterpret_cast<const char4*>(p));
    return make_float4(static_cast<float>(q.x), static_cast<float>(q.y),
                       static_cast<float>(q.z), static_cast<float>(q.w));
  } else if constexpr (sizeof(In) == 1) {
    const uchar4 q = __ldg(reinterpret_cast<const uchar4*>(p));
    return make_float4(static_cast<float>(q.x), static_cast<float>(q.y),
                       static_cast<float>(q.z), static_cast<float>(q.w));
  } else {
    const short4 q = __ldg(reinterpret_cast<const short4*>(p));
    return make_float4(static_cast<float>(q.x), static_cast<float>(q.y),
                       static_cast<float>(q.z), static_cast<float>(q.w));
  }
}
template <class In>
__device__ __forceinline__ void st1(In* p, float v) {
  if constexpr (std::is_same<In, float>::value) {
    *p = v;
  } else if constexpr (kHalfFloat<In>) {
    *reinterpret_cast<unsigned short*>(p) = narrow<In>(v);
  } else {
    *p = saturate<In>(v);
  }
}
template <class In>
__device__ __forceinline__ void st4(In* p, const float (&y)[4]) {
  if constexpr (std::is_same<In, float>::value) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(y[0], y[1], y[2], y[3]));
  } else if constexpr (kHalfFloat<In>) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(narrow<In>(y[0]) | (unsigned(narrow<In>(y[1])) << 16),
                      narrow<In>(y[2]) | (unsigned(narrow<In>(y[3])) << 16)));
  } else if constexpr (sizeof(In) == 4) {
    __stcs(reinterpret_cast<int4*>(p),
           make_int4(saturate<In>(y[0]), saturate<In>(y[1]),
                     saturate<In>(y[2]), saturate<In>(y[3])));
  } else if constexpr (sizeof(In) == 1) {
    const auto bits = [](float v) {
      return unsigned(static_cast<unsigned char>(saturate<In>(v)));
    };
    __stcs(reinterpret_cast<unsigned int*>(p),
           bits(y[0]) | (bits(y[1]) << 8) | (bits(y[2]) << 16) |
               (bits(y[3]) << 24));
  } else {
    const auto bits = [](float v) {
      return unsigned(static_cast<unsigned short>(saturate<In>(v)));
    };
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(bits(y[0]) | (bits(y[1]) << 16),
                      bits(y[2]) | (bits(y[3]) << 16)));
  }
}

struct Params {
  const void* x;          // (In) the signal
  long long slot_stride;
  long long frame_stride;
  int n_frames;
  int window;
  int block_frames;
  int groups;             // frame groups a block holds at once
  const float* taps;
  int n_taps;
  const float* tw_re;     // (log2 m, m/2) Stockham twiddles, m = fft/2
  const float* tw_im;
  const float* untangle;  // (2, m) cos/sin(-2 pi k / fft)
  int fft_size;
  const float* svm_w;     // (12, C)
  const float* svm_b;     // (C,)
  int n_classes;
  int bands[7];           // band edges over the fft/2+1 power bins
  float prominence;
  int min_distance;
  void* out_filtered;     // (rows, window) of In, or null
  float* out_features;    // (rows, 12) or null
  float* out_margin;      // (rows, C) or null
  int* out_class;         // (rows,) or null
  int* retired;           // frame counter (ring sweeps) or null
  int valid_rows;         // only rows below this count as retired
  int flags;
};

// ---- shared memory. A block: the tables, then G frame regions of
// group_bytes each. A frame region: the filtered frame, the FFT's two
// exchange buffers, the two mask bitmaps, the frame's scratch and a list
// of 16-bit entries (the candidates, each delineation warp's in its own
// segment, then the two gap lists).
__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}
// one exchange plane of m points: point q at q + (q >> 4)
__host__ __device__ inline int plane_words(int m) { return m + (m >> 4); }
__host__ __device__ inline int mask_words(int S) { return (S + 31) / 32; }
// scratch: 12 features, 3 reduction slots of 4 warps x 8 words (two that
// the delineation threads alternate, one for the whole group), the
// delineation warps' candidate counts
constexpr int kFeatOff = 0;
constexpr int kRedOff = 16;
constexpr int kRedSlot = 4 * 8;
constexpr int kRedAll = kRedOff + 2 * kRedSlot;
constexpr int kCountOff = kRedOff + 3 * kRedSlot;
constexpr int kScratchWords = kCountOff + 4;
__host__ __device__ inline size_t group_bytes(int S, int m) {
  return 4 * (size_t((S + 3) & ~3) + size_t((4 * plane_words(m) + 3) & ~3) +
              2 * ((mask_words(S) + 3) & ~3) + kScratchWords) +
         align16(2 * (size_t(S) + 4 * kFrameThreads));
}
// the compacted twiddles (row s: its m >> (s + 1) used entries, from
// m - (m >> s)), the untangle factors (float2 each), svm_w and svm_b
__host__ __device__ inline size_t table_bytes(int m, int C) {
  return 8 * size_t(2 * m - 1) + align16(4 * size_t(13 * C));
}

__device__ __forceinline__ int pad(int q) { return q + (q >> 4); }

__host__ __device__ constexpr int bitrev(int v, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((v >> i) & 1) << (bits - 1 - i);
  return r;
}

// ---- synchronisation of N threads on named barrier `id`
template <int N>
__device__ __forceinline__ void sync_threads(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
}

// ---- the tables' copy: cp.async 4 bytes at a time, tracked by an
// mbarrier that completes once every thread's copies have landed
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
__device__ __forceinline__ void tables_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void tables_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void tables_wait(uint64_t* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

// ---- reductions and scans over N threads (thread `idx` of them, whole
// warps, synchronised by sync_threads<N>(bar)), in a fixed order. Within a
// warp a butterfly of a commutative op leaves every lane the same value;
// across warps the warp results combine in warp order through one of two
// scratch slots, alternated by `phase` so that one sync a call is enough
// (a single slot, phase null, where the calls are a group sync apart).
template <int N, int K, class V, class Op>
__device__ __forceinline__ void group_allreduce(V (&v)[K], Op op, V* red,
                                                int* phase, int idx, int bar) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = op(k, v[k], __shfl_xor_sync(kFull, v[k], o));
  }
  if constexpr (N > 32) {
    const int w = idx >> 5;
    V* slot = red;
    if (phase != nullptr) slot += ((*phase)++ & 1) * kRedSlot;
    if ((idx & 31) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) slot[w * K + k] = v[k];
    }
    sync_threads<N>(bar);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      V a = slot[k];
      for (int j = 1; j < N / 32; ++j) a = op(k, a, slot[j * K + k]);
      v[k] = a;
    }
  }
}

// exclusive scan in thread order of K ints with op(k, a, b) and identity
// id(k); `total` receives the whole group's combination
template <int N, int K, class Op, class Id>
__device__ __forceinline__ void group_exclusive_scan(int (&v)[K],
                                                     int (&total)[K], Op op,
                                                     Id id, int* red,
                                                     int* phase, int idx,
                                                     int bar) {
  const int lane = idx & 31;
  int inc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) inc[k] = v[k];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = __shfl_up_sync(kFull, inc[k], o);
      if (lane >= o) inc[k] = op(k, inc[k], t);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = __shfl_up_sync(kFull, inc[k], 1);
    v[k] = lane == 0 ? id(k) : e;
    total[k] = __shfl_sync(kFull, inc[k], 31);
  }
  if constexpr (N > 32) {
    const int w = idx >> 5;
    int* const slot = red + ((*phase)++ & 1) * kRedSlot;
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k < K; ++k) slot[w * K + k] = total[k];
    }
    sync_threads<N>(bar);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int before = id(k), all = id(k);
      for (int j = 0; j < N / 32; ++j) {
        if (j == w) before = all;
        all = op(k, all, slot[j * K + k]);
      }
      v[k] = op(k, before, v[k]);
      total[k] = all;
    }
  }
}

// ---- the FIR: KT taps exactly, held in registers, or, for KT = 0, any
// count up to kMaxTaps, read through L1, with a uniform branch out of the
// unrolled loop after n_taps. Instantiated for kAppTaps (the MBioTracker
// filter's count: straight-line code, faster than a capped loop at that
// count) and for 0. History vectors a round holds: the KT - 1 samples
// before its 4 (kLongHistory for KT = 0).
constexpr int kAppTaps = 11;
constexpr int kLongHistory = 16;
static_assert(4 * kLongHistory + 1 >= kMaxTaps, "KT = 0 takes every count");
__host__ __device__ constexpr int history_vectors(int kt) {
  return kt == 0 ? kLongHistory : (kt + 2) / 4;
}
// Two rounds' 4 outputs: x[r][4 NH + c] is sample 4v + c of round r's
// vector v, x[r][4 NH + c - i] the one i before; acc = 0, then the taps in
// ascending order, each product and sum rounded (the plain version's).
template <int KT, int NH = history_vectors(KT)>
__device__ __forceinline__ void fir8(const float (&x)[2][4 * NH + 4],
                                     const float (&held)[KT ? KT : 1],
                                     const float* __restrict__ taps,
                                     int n_taps, float (&y)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) y[r][c] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < (KT ? KT : 4 * NH + 1); ++i) {
    if (KT == 0 && i >= n_taps) break;
    const float tap = KT ? held[KT ? i : 0] : __ldg(taps + i);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        y[r][c] = __fadd_rn(y[r][c], __fmul_rn(tap, x[r][4 * NH + c - i]));
    }
  }
}

// ---- one FFT pass: fft_stages' stages s0 .. s0 + L - 1 of an m = 2^M
// point transform. Group (q, r), q of s0 bits and r of rb = M - s0 - L
// bits, holds points in_pos(v) = q << (M - s0) | v << rb | r, v < 2^L, and
// writes point v to out_pos(v) = bitrev(v) << (M - L) | q << rb | r. The
// L butterfly stages are those of the in-place chain (stage s0 + i pairs
// v with v | bit, bit = 2^(L-1-i), twiddle row s0 + i at (v & (bit - 1))
// << rb | r), run in constant geometry so that one short loop body serves
// every stage: before stage i point v sits in slot rotl^i(v) (rotation of
// L bits), so the stage pairs slots j and j + 2^(L-1), its twiddle sits at
// (j >> i) << rb | r, and its outputs go to slots 2j and 2j + 1; after L
// stages point v is back in slot v.
template <int L, class Load, class Store>
__device__ __forceinline__ void fft_pass(int M, int s0, int i0, int step,
                                         const float2* tw, Load load,
                                         Store store) {
  constexpr int E = 1 << L, H = E / 2;
  const int rb = M - s0 - L;
  const int m = 1 << M;
  for (int grp = i0; grp < (1 << (M - L)); grp += step) {
    const int r = grp & ((1 << rb) - 1), q = grp >> rb;
    float xr[E], xi[E];
#pragma unroll
    for (int v = 0; v < E; ++v)
      load((q << (M - s0)) | (v << rb) | r, xr[v], xi[v]);
#pragma unroll 1
    for (int i = 0; i < L; ++i) {
      const float2* row = tw + (m - (m >> (s0 + i)));
      float yr[E], yi[E];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float2 w = row[((j >> i) << rb) | r];
        const float ar = xr[j], ai = xi[j], br = xr[j + H], bi = xi[j + H];
        const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
        yr[2 * j] = __fadd_rn(ar, br);
        yi[2 * j] = __fadd_rn(ai, bi);
        yr[2 * j + 1] = __fsub_rn(__fmul_rn(dr, w.x), __fmul_rn(di, w.y));
        yi[2 * j + 1] = __fadd_rn(__fmul_rn(dr, w.y), __fmul_rn(di, w.x));
      }
#pragma unroll
      for (int v = 0; v < E; ++v) {
        xr[v] = yr[v];
        xi[v] = yi[v];
      }
    }
#pragma unroll
    for (int v = 0; v < E; ++v)
      store((bitrev(v, L) << (M - L)) | (q << rb) | r, xr[v], xi[v]);
  }
}

template <class Load, class Store>
__device__ __forceinline__ void fft_pass_any(int L, int M, int s0, int i0,
                                             int step, const float2* tw,
                                             Load load, Store store) {
  switch (L) {
    case 1: fft_pass<1>(M, s0, i0, step, tw, load, store); break;
    case 2: fft_pass<2>(M, s0, i0, step, tw, load, store); break;
    case 3: fft_pass<3>(M, s0, i0, step, tw, load, store); break;
    default: fft_pass<4>(M, s0, i0, step, tw, load, store); break;
  }
}

// One block: G frame groups of T threads (group g on threads [g T, (g+1) T))
// over the block's block_frames frames, group g taking frames g, g + G, ...
// A frame's last warp takes the FFT and the band powers while its first TD
// = T - 32 threads take the delineation, each part synchronised on its own
// (a warp; named barrier 1 + kMaxBlockThreads / T + g), the whole group on
// named barrier 1 + g. KT: the filter's taps exactly, or 0 for any count
// (fir8). In: the signal's element type.
template <int KT, class In>
__global__ void __launch_bounds__(kMaxBlockThreads)
biosignal_graph_kernel(const Params p) {
  constexpr int T = kFrameThreads;
  constexpr int TD = T - kFftThreads;   // delineation threads
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t tables_bar;

  const int S = p.window;
  const int N = p.fft_size;
  const int m = N / 2;
  int M = 0;
  while ((1 << M) < m) ++M;
  const int C = p.n_classes;
  const int tid = threadIdx.x;
  const int g = tid / T, i = tid % T;
  const int G = p.groups;
  const int bar_all = 1 + g, bar_delin = 1 + kMaxBlockThreads / T + g;
  const bool need_features =
      (p.flags & (kOutFeatures | kOutMargin | kOutClass)) != 0;
  const bool need_svm = (p.flags & (kOutMargin | kOutClass)) != 0;

  constexpr int NH = history_vectors(KT);
  float taps[KT ? KT : 1];
#pragma unroll
  for (int t = 0; t < KT; ++t) taps[t] = __ldg(p.taps + t);

  // ---- tables: one copy a block, issued once each group's first frame
  // has landed (off its chain) and awaited on an mbarrier where first
  // read
  float2* const tw = reinterpret_cast<float2*>(smem);   // 2m - 1 float2
  float2* const ut = tw + (m - 1);
  float* const svm_w = reinterpret_cast<float*>(ut + m);
  float* const svm_b = svm_w + kFeatures * C;
  if (need_features) {
    if (tid == 0) tables_init(&tables_bar, blockDim.x);
    __syncthreads();   // the init, before any frame's work
  }
  bool tables_issued = !need_features;
  auto issue_tables = [&] {
    for (int s = 0; s < M; ++s) {
      const int half = m >> (s + 1);
      float* const row = reinterpret_cast<float*>(tw + (m - (m >> s)));
      for (int j = tid; j < half; j += blockDim.x) {
        copy_async4(row + 2 * j, p.tw_re + s * (m / 2) + j);
        copy_async4(row + 2 * j + 1, p.tw_im + s * (m / 2) + j);
      }
    }
    float* const utf = reinterpret_cast<float*>(ut);
    for (int k = tid; k < m; k += blockDim.x) {
      copy_async4(utf + 2 * k, p.untangle + k);
      copy_async4(utf + 2 * k + 1, p.untangle + m + k);
    }
    for (int j = tid; j < kFeatures * C; j += blockDim.x)
      copy_async4(svm_w + j, p.svm_w + j);
    for (int j = tid; j < C; j += blockDim.x) copy_async4(svm_b + j, p.svm_b + j);
    tables_arrive(&tables_bar);
    tables_issued = true;
  };

  // ---- this group's frame region
  const int W = mask_words(S);
  const int Wp = (W + 3) & ~3;
  const int P = plane_words(m);
  unsigned char* const base =
      smem + align16(table_bytes(m, C)) + size_t(g) * group_bytes(S, m);
  float* const filt = reinterpret_cast<float*>(base);
  float* const fftb = filt + ((S + 3) & ~3);   // two buffers of 2P words
  unsigned* const mask =
      reinterpret_cast<unsigned*>(fftb + ((4 * P + 3) & ~3));   // max, min
  int* const scratch = reinterpret_cast<int*>(mask + 2 * Wp);
  uint16_t* const list = reinterpret_cast<uint16_t*>(scratch + kScratchWords);
  float* const feats = reinterpret_cast<float*>(scratch + kFeatOff);
  int* const red_i = scratch + kRedOff;
  float* const red_f = reinterpret_cast<float*>(red_i);
  float* const red_all = reinterpret_cast<float*>(scratch + kRedAll);
  int* const cand_counts = scratch + kCountOff;

  const int f_begin = blockIdx.x * p.block_frames;
  const int f_end = min(p.n_frames, f_begin + p.block_frames);
  const In* const slot =
      static_cast<const In*>(p.x) + (long long)blockIdx.y * p.slot_stride;
  const long long slot_row = (long long)blockIdx.y * p.n_frames;
  int retired = 0;

  for (int f = f_begin + g; f < f_end; f += G) {
    const long long row = slot_row + f;
    const In* const src = slot + (long long)f * p.frame_stride;
    In* const dst = (p.flags & kOutFiltered)
                        ? static_cast<In*>(p.out_filtered) + row * S
                        : nullptr;
    retired += row < p.valid_rows;

    // ---- stage 1: the frame to shared memory, as float32: by cp.async
    // for a float32 signal (16 bytes a copy where the frame lies on 16
    // bytes, else 4), all of it in flight at once; any other loaded 4
    // samples a thread where it lies on 4 samples' bytes, else 1, and
    // widened. The tables' copies once the first frame is in
    const int nv = (S + 3) / 4;              // 4-sample vectors a frame
    const int rounds = (nv + T - 1) / T;     // vector v = i + T j in round j
    const bool vec_in =
        (reinterpret_cast<uintptr_t>(src) & (4 * sizeof(In) - 1)) == 0 &&
        (S & 3) == 0;
    if constexpr (std::is_same<In, float>::value) {
      if (vec_in) {
        for (int v = i; v < nv; v += T)
          copy_async16(filt + 4 * v, src + 4 * v);
      } else {
        for (int t = i; t < S; t += T) copy_async4(filt + t, src + t);
      }
    } else if (vec_in) {
      for (int v = i; v < nv; v += T)
        reinterpret_cast<float4*>(filt)[v] = ld4(src + 4 * v);
    } else {
      for (int t = i; t < S; t += T) filt[t] = ld1(src + t);
    }
    if (need_features)
      for (int w = i; w < 2 * Wp; w += T) mask[w] = 0u;
    copy_async_wait_all();
    sync_threads<T>(bar_all);
    if (!tables_issued) issue_tables();

    // ---- the FIR from registers, in place: rounds from the last to the
    // first, two a step, every read of a step before its writes, so that
    // each vector a step reads (its own and the NH before it, the zero
    // history before the frame) is still raw. The filtered frame stays in
    // shared memory; its sum, max, min and FFT-segment sum on the way.
    float red4[4] = {0.f, -INFINITY, INFINITY, 0.f};
    {
      const bool vec_out =
          (reinterpret_cast<uintptr_t>(dst) & (4 * sizeof(In) - 1)) == 0;
      const float4* const raw4 = reinterpret_cast<const float4*>(filt);
      for (int j1 = rounds - 1; j1 >= 0; j1 -= 2) {
        float x[2][4 * NH + 4], y[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int v = i + T * (j1 - r);
#pragma unroll
          for (int h = 0; h <= NH; ++h) {
            const int u = v - NH + h;
            const float4 q = j1 - r >= 0 && u >= 0 && u < nv
                                 ? raw4[u]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            x[r][4 * h] = q.x;
            x[r][4 * h + 1] = q.y;
            x[r][4 * h + 2] = q.z;
            x[r][4 * h + 3] = q.w;
          }
        }
        fir8<KT>(x, taps, p.taps, p.n_taps, y);
        sync_threads<T>(bar_all);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int v = i + T * (j1 - r), t0 = 4 * v;
          if (j1 - r < 0 || v >= nv) continue;
          if (t0 + 4 <= S) {
            reinterpret_cast<float4*>(filt)[v] =
                make_float4(y[r][0], y[r][1], y[r][2], y[r][3]);
            if (dst != nullptr) {
              if (vec_out) {
                st4(dst + t0, y[r]);
              } else {
#pragma unroll
                for (int c = 0; c < 4; ++c) st1(dst + t0 + c, y[r][c]);
              }
            }
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (t0 + c < S) {
                filt[t0 + c] = y[r][c];
                if (dst != nullptr) st1(dst + t0 + c, y[r][c]);
              }
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (t0 + c < S) {
              red4[0] += y[r][c];
              red4[1] = fmaxf(red4[1], y[r][c]);
              red4[2] = fminf(red4[2], y[r][c]);
              if (t0 + c < N) red4[3] += y[r][c];
            }
          }
        }
      }
    }
    if (!need_features) {           // uniform across the block
      sync_threads<T>(bar_all);     // the region, free for the next frame
      continue;
    }
    // its barrier also publishes the filtered frame
    group_allreduce<T>(
        red4,
        [](int k, float a, float b) {
          return k == 1 ? fmaxf(a, b) : k == 2 ? fminf(a, b) : a + b;
        },
        red_all, nullptr, i, bar_all);
    const float mu = __fdiv_rn(red4[0], (float)S);
    const float seg_mean = __fdiv_rn(red4[3], (float)N);

    // ---- stage 2: delineation on threads [0, TD): the masks, the gaps,
    // their mean, lower median and RMS
    auto delineate = [&](const int di) {
      const int lane = di & 31;
      int phase = 0;
      const float thr_hi =
          __fadd_rn(mu, __fmul_rn(p.prominence, __fsub_rn(red4[1], mu)));
      const float thr_lo =
          __fsub_rn(mu, __fmul_rn(p.prominence, __fsub_rn(mu, red4[2])));
      // ---- 2a: neighbour and amplitude tests, 4 samples a thread, TD
      // vectors a round; each warp appends its candidates (bit 15: a
      // minimum) by ballot to its own segment of the list (room for 4
      // candidates a thread a round), in any order (the windows do not
      // depend on it), and publishes their count
      const int dw = di >> 5;
      const int seg = 128 * ((nv + TD - 1) / TD);
      int n_cand = 0;    // this warp's
      const unsigned below = (1u << lane) - 1u;
      for (int v0 = 0; v0 < nv; v0 += TD) {
        const int v = v0 + di, t0 = 4 * v;
        unsigned cmax = 0u, cmin = 0u;   // bit c: sample t0 + c
        if (v < nv) {
          const float4 q = reinterpret_cast<const float4*>(filt)[v];
          const float xs[6] = {t0 > 0 ? filt[t0 - 1] : 0.f, q.x, q.y, q.z,
                               q.w, t0 + 4 < S ? filt[t0 + 4] : 0.f};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float prev = xs[c], x0 = xs[c + 1], nxt = xs[c + 2];
            const bool inner = t0 + c > 0 && t0 + c < S - 1;
            cmax |= (unsigned)(inner && x0 > prev && x0 >= nxt && x0 > thr_hi)
                    << c;
            cmin |= (unsigned)(inner && x0 < prev && x0 <= nxt && x0 < thr_lo)
                    << c;
          }
        }
        // the candidates before this thread's: a ballot of each bit of the
        // threads' counts (0 to 4)
        const unsigned both = cmax | cmin;
        const int k = __popc(both);
        const unsigned b0 = __ballot_sync(kFull, k & 1), b1 = __ballot_sync(
            kFull, k & 2), b2 = __ballot_sync(kFull, k & 4);
        int at = dw * seg + n_cand + __popc(b0 & below) +
                 2 * __popc(b1 & below) + 4 * __popc(b2 & below);
        n_cand += __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if ((both >> c) & 1u)
            list[at++] = (uint16_t)((t0 + c) | ((cmin >> c) & 1u) << 15);
        }
      }
      if (lane == 0) cand_counts[dw] = n_cand;
      sync_threads<TD>(bar_delin);
      int counts[TD / 32];
      n_cand = 0;
#pragma unroll
      for (int w = 0; w < TD / 32; ++w) {
        counts[w] = cand_counts[w];
        n_cand += counts[w];
      }

      // ---- 2b: the +-d window at each candidate, shared out evenly; a
      // minimum's samples negated so that one max serves both; 16
      // independent reads at a time, clamped into the window (a repeated
      // sample does not change its max)
      {
        const int d = p.min_distance;
        for (int c = di; c < n_cand; c += TD) {
          // candidate c: entry c - (the counts before) of its warp's
          // segment
          int at = c, w = 0;
#pragma unroll
          for (int w2 = 0; w2 < TD / 32 - 1; ++w2) {
            if (w == w2 && at >= counts[w2]) {
              at -= counts[w2];
              ++w;
            }
          }
          const int e = list[w * seg + at], t = e & 0x7fff, is_min = e >> 15;
          const float sgn = is_min ? -1.f : 1.f;
          const float v = sgn * filt[t];
          const int a = max(0, t - d), b = min(S - 1, t + d);
          float hi[4] = {v, v, v, v};
          for (int j0 = a; j0 <= b; j0 += 16) {
#pragma unroll
            for (int u = 0; u < 16; ++u)
              hi[u & 3] = fmaxf(hi[u & 3], sgn * filt[min(j0 + u, b)]);
          }
          if (v >= fmaxf(fmaxf(hi[0], hi[1]), fmaxf(hi[2], hi[3])))
            atomicOr(mask + is_min * Wp + (t >> 5), 1u << (t & 31));
        }
      }
      sync_threads<TD>(bar_delin);

      // ---- 2c: gaps. Thread di takes the contiguous mask words [w0,
      // w1); one scan gives each extremum its predecessor (prefix max of
      // the last set bit) and its rank (prefix popcount): the gap of
      // extremum number b goes to list[b - 1] of its mask (max at 0, min
      // at S/2)
      int n_max, n_min, s1[2] = {0, 0}, s2[2] = {0, 0};
      {
        const int cw = (W + TD - 1) / TD;
        const int w0 = min(W, di * cw), w1 = min(W, w0 + cw);
        int sc[4] = {-1, -1, 0, 0}, total[4];
        for (int w = w0; w < w1; ++w) {
#pragma unroll
          for (int which = 0; which < 2; ++which) {
            const unsigned word = mask[which * Wp + w];
            if (word != 0u) sc[which] = 32 * w + 31 - __clz(word);
            sc[2 + which] += __popc(word);
          }
        }
        group_exclusive_scan<TD>(
            sc, total,
            [](int k, int a, int b) { return k < 2 ? max(a, b) : a + b; },
            [](int k) { return k < 2 ? -1 : 0; }, red_i, &phase, di,
            bar_delin);
        n_max = max(total[2] - 1, 0);
        n_min = max(total[3] - 1, 0);
#pragma unroll
        for (int which = 0; which < 2; ++which) {
          int last = sc[which], rank = sc[2 + which];
          uint16_t* const gl = list + which * (S / 2);
          for (int w = w0; w < w1; ++w) {
            unsigned word = mask[which * Wp + w];
            while (word != 0u) {
              const int t = 32 * w + __ffs(word) - 1;
              word &= word - 1u;
              if (last >= 0) {
                const int gap = t - last;
                gl[rank - 1] = (uint16_t)gap;
                s1[which] += gap;
                s2[which] += gap * gap;
              }
              last = t;
              ++rank;
            }
          }
        }
      }
      {
        int sums[4] = {s1[0], s2[0], s1[1], s2[1]};
        // its barrier also publishes the gap lists
        group_allreduce<TD>(sums, [](int, int a, int b) { return a + b; },
                            red_i, &phase, di, bar_delin);
        s1[0] = sums[0];
        s2[0] = sums[1];
        s1[1] = sums[2];
        s2[1] = sums[3];
      }

      // ---- 2d: mean, lower median and RMS of each mask's gaps. Up to
      // kRankMax gaps in both lists, each half of the threads takes one
      // list; else the lists one after the other, by all of them.
      const bool ranked = n_max <= kRankMax && n_min <= kRankMax;
      constexpr int half = TD / 2;
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const int n = which ? n_min : n_max;
        const uint16_t* const gl = list + which * (S / 2);
        const int k = (max(n, 1) - 1) / 2;
        // this list's threads: [lead, lead + step)
        const int lead = ranked ? which * half : 0;
        const int step = ranked ? half : TD;
        if (ranked) {
          // the gap e with less(e) <= k < less(e) + equal(e), first of its
          // value, writes the median
          if (di >= lead && di < lead + step) {
            for (int e = di - lead; e < n; e += step) {
              const int ge = gl[e];
              int less = 0, equal = 0, before = 0;
#pragma unroll 8
              for (int j = 0; j < n; ++j) {
                const int gj = gl[j];
                less += gj < ge;
                equal += gj == ge;
                before += gj == ge && j < e;
              }
              if (before == 0 && less <= k && k < less + equal)
                feats[3 * which + 1] = (float)ge;
            }
            if (n == 0 && di == lead) feats[3 * which + 1] = 0.f;
          }
        } else {
          // bisection: the least value v with more than k gaps <= v
          int lo = 0, hi = S;
          while (hi - lo > 1) {
            const int mid = (lo + hi) / 2;
            int cnt[1] = {0};
            for (int e = di; e < n; e += TD) cnt[0] += gl[e] <= mid;
            group_allreduce<TD>(cnt, [](int, int a, int b) { return a + b; },
                                red_i, &phase, di, bar_delin);
            if (cnt[0] > k) {
              hi = mid;
            } else {
              lo = mid;
            }
          }
          if (di == 0) feats[3 * which + 1] = n > 0 ? (float)hi : 0.f;
        }
        if (di == lead) {
          const float nf = (float)max(n, 1);
          feats[3 * which] = __fdiv_rn((float)s1[which], nf);
          feats[3 * which + 2] = sqrtf(__fdiv_rn((float)s2[which], nf));
        }
      }
    };

    // ---- stage 3: the packed FFT of the mean-subtracted first N samples
    // on one warp, in passes of four radix-2 stages (pass k writes buffer
    // (k + 1) & 1 of fftb, each an re and an im plane of P words); the
    // untangle and the six band powers
    auto spectrum = [&](const int l) {
      tables_wait(&tables_bar);
      const int fft_threads = min(kFftThreads, max(1, m >> 4));
      int n_pass = 0;
      for (int s0 = 0; s0 < M; s0 += 4, ++n_pass) {
        const int L = min(4, M - s0);
        float* const out = fftb + ((n_pass + 1) & 1) * 2 * P;
        auto store = [out, P](int q, float re, float im) {
          out[pad(q)] = re;
          out[P + pad(q)] = im;
        };
        if (l < fft_threads) {
          if (n_pass == 0) {
            auto load = [filt, seg_mean](int q, float& re, float& im) {
              const float2 z = reinterpret_cast<const float2*>(filt)[q];
              re = __fsub_rn(z.x, seg_mean);
              im = __fsub_rn(z.y, seg_mean);
            };
            fft_pass_any(L, M, s0, l, fft_threads, tw, load, store);
          } else {
            const float* const in = fftb + (n_pass & 1) * 2 * P;
            auto load = [in, P](int q, float& re, float& im) {
              re = in[pad(q)];
              im = in[P + pad(q)];
            };
            fft_pass_any(L, M, s0, l, fft_threads, tw, load, store);
          }
        }
        __syncwarp();
      }
      // untangle: X[k] = (Z[k] + conj Z[-k])/2 - i/2 e^{-2 pi i k/N} (Z[k]
      // - conj Z[-k]); power into the six bands
      const float* const zr = fftb + (n_pass & 1) * 2 * P;
      const float* const zi = zr + P;
      float band[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int k = l; k <= m; k += kFftThreads) {
        float xr, xi;
        if (k == m) {
          xr = __fsub_rn(zr[0], zi[0]);
          xi = 0.f;
        } else {
          const int idx = k == 0 ? 0 : m - k;
          const float ar = zr[pad(k)], ai = zi[pad(k)];
          const float cr = zr[pad(idx)], ci = -zi[pad(idx)];
          const float er = __fmul_rn(__fadd_rn(ar, cr), 0.5f);
          const float ei = __fmul_rn(__fadd_rn(ai, ci), 0.5f);
          const float o_r = __fmul_rn(__fsub_rn(ar, cr), 0.5f);
          const float o_i = __fmul_rn(__fsub_rn(ai, ci), 0.5f);
          const float2 u = ut[k];
          const float pr = __fsub_rn(__fmul_rn(u.x, o_r), __fmul_rn(u.y, o_i));
          const float pi = __fadd_rn(__fmul_rn(u.x, o_i), __fmul_rn(u.y, o_r));
          xr = __fadd_rn(er, pi);
          xi = __fsub_rn(ei, pr);
        }
        const float pw = __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
#pragma unroll
        for (int b = 0; b < 6; ++b)
          if (k >= p.bands[b] && k < p.bands[b + 1]) band[b] += pw;
      }
      group_allreduce<kFftThreads>(
          band, [](int, float a, float b) { return a + b; }, red_f, nullptr,
          l, 0);
#pragma unroll
      for (int b = 0; b < 6; ++b)
        if (l == b) feats[6 + b] = log1pf(band[b]);
    };

    if (i < TD) {
      delineate(i);
    } else {
      spectrum(i - TD);
    }
    sync_threads<T>(bar_all);   // the 12 features
    if ((p.flags & kOutFeatures) && i < kFeatures)
      p.out_features[row * kFeatures + i] = feats[i];

    // ---- stage 4: linear SVM margin (features in index order) + class
    if (need_svm && i < 32) {
      tables_wait(&tables_bar);
      float mg = 0.f;
      if (i < C) {
        float acc = __fmul_rn(feats[0], svm_w[i]);
        for (int f2 = 1; f2 < kFeatures; ++f2)
          acc = __fadd_rn(acc, __fmul_rn(feats[f2], svm_w[f2 * C + i]));
        mg = __fadd_rn(acc, svm_b[i]);
        if (p.flags & kOutMargin) p.out_margin[row * C + i] = mg;
      }
      if (p.flags & kOutClass) {
        // first index of the largest margin; NaN counts as largest
        int best = 0;
        float bv = __shfl_sync(kFull, mg, 0);
        for (int c = 1; c < C; ++c) {
          const float v = __shfl_sync(kFull, mg, c);
          if (!isnan(bv) && (v > bv || isnan(v))) {
            best = c;
            bv = v;
          }
        }
        if (i == 0) p.out_class[row] = best;
      }
    }
    sync_threads<T>(bar_all);   // the region and scratch, free for the next frame
  }
  // a group with no frame still copies its share of the tables
  if (!tables_issued) issue_tables();

  // ---- retire: each group counts its valid frames once they are written
  if (p.retired != nullptr && i == 0 && retired) atomicAdd(p.retired, retired);
  if (need_features) tables_wait(&tables_bar);   // no copy outlives the block
}

template <int KT, class In>
cudaError_t launch_kernel(const Params& p, size_t smem, int n_slots,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        biosignal_graph_kernel<KT, In>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.n_frames + p.block_frames - 1) / p.block_frames, n_slots);
  biosignal_graph_kernel<KT, In>
      <<<grid, p.groups * kFrameThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class In>
cudaError_t launch_taps(const Params& p, size_t smem, int n_slots,
                        cudaStream_t stream) {
  return p.n_taps == kAppTaps ? launch_kernel<kAppTaps, In>(p, smem, n_slots,
                                                             stream)
                              : launch_kernel<0, In>(p, smem, n_slots, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes a block of one frame group needs for a (window,
// fft_size) frame (the launch puts more groups in a block where they fit).
size_t biosignal_graph_smem_bytes(int window, int fft_size) {
  const int m = fft_size / 2;
  return align16(table_bytes(m, kMaxClasses)) + group_bytes(window, m);
}

const char* biosignal_graph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the graph over n_slots x n_frames frames on `stream`, on the
// calling thread's current device; returns cudaGetLastError() after the
// launch (0 on success). Allocates nothing and does not synchronise.
// `bands` is a host array of 7 band edges. When `retired` is not null the
// kernel adds to it the frames it wrote among the first `valid_rows`.
// `dtype` is the element type of x and out_filtered: kFloat32, kBFloat16,
// kFloat16, kInt16, kInt32, kInt8 or kUInt8.
int biosignal_graph_launch(
    const void* x, int dtype, long long slot_stride, long long frame_stride,
    int n_slots, int n_frames, int window, int block_frames,
    const float* taps, int n_taps, const float* tw_re, const float* tw_im,
    const float* untangle, int fft_size, const float* svm_w,
    const float* svm_b, int n_features, int n_classes, const int* bands,
    float prominence, int min_distance, void* out_filtered,
    float* out_features, float* out_margin, int* out_class, int* retired,
    int valid_rows, int flags, void* stream) {
  const int m = fft_size / 2;
  if (n_taps < 1 || n_taps > kMaxTaps || n_classes < 1 ||
      n_classes > kMaxClasses || n_features != kFeatures || n_slots < 1 ||
      n_slots > 65535 || n_frames < 1 || block_frames < 1 || window < 2 ||
      window > kMaxWindow || fft_size < 4 || fft_size > window ||
      (m & (m - 1)) != 0 || dtype < kFloat32 || dtype > kUInt8)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.slot_stride = slot_stride;
  p.frame_stride = frame_stride;
  p.n_frames = n_frames;
  p.window = window;
  p.block_frames = block_frames;
  p.taps = taps;
  p.n_taps = n_taps;
  p.tw_re = tw_re;
  p.tw_im = tw_im;
  p.untangle = untangle;
  p.fft_size = fft_size;
  p.svm_w = svm_w;
  p.svm_b = svm_b;
  p.n_classes = n_classes;
  for (int i = 0; i < 7; ++i) p.bands[i] = bands[i];
  p.prominence = prominence;
  p.min_distance = min_distance;
  p.out_filtered = out_filtered;
  p.out_features = out_features;
  p.out_margin = out_margin;
  p.out_class = out_class;
  p.retired = retired;
  p.valid_rows = valid_rows;
  p.flags = flags;
  constexpr int T = kFrameThreads;
  const size_t tables = align16(table_bytes(m, n_classes));
  const size_t per_group = group_bytes(window, m);
  int groups = block_frames < kMaxBlockThreads / T ? block_frames
                                                   : kMaxBlockThreads / T;
  while (groups > 1 && tables + groups * per_group > kMaxSmemBytes) --groups;
  if (tables + per_group > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  p.groups = groups;
  const size_t smem = tables + groups * per_group;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kFloat32    ? launch_taps<float>(p, smem, n_slots, st)
      : dtype == kBFloat16 ? launch_taps<__nv_bfloat16>(p, smem, n_slots, st)
      : dtype == kFloat16  ? launch_taps<__half>(p, smem, n_slots, st)
      : dtype == kInt16    ? launch_taps<int16_t>(p, smem, n_slots, st)
      : dtype == kInt32    ? launch_taps<int32_t>(p, smem, n_slots, st)
      : dtype == kInt8     ? launch_taps<int8_t>(p, smem, n_slots, st)
                           : launch_taps<uint8_t>(p, smem, n_slots, st));
}

}  // extern "C"
