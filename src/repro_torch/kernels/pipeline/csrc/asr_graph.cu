// The streaming ASR feature front-end (pre-emphasis FIR -> periodic Hann ->
// |packed rFFT|^2 -> log1p(power @ mel_w)) as one CUDA kernel for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (cuda.py).
//
// Replaces the ASR stage bodies of src/repro/kernels/pipeline/asr.py
// (_hann_body :115, _power_body :127, _logmel_body :140) as compiled into
// graph_kernel / graph_stream_kernel of src/repro/kernels/pipeline/graph.py
// at its three pallas_call sites graph_frames_call (:479),
// graph_stream_call (:526) and graph_ring_call (:575). One kernel serves
// all three, with the strided frame addressing of biosignal_graph.cu: frame
// f of slot r starts at x + r*slot_stride + f*frame_stride.
//
// What bounds it on this card. Per frame of the whisper-style configuration
// (window 512, 2 taps, 512-point rFFT, 64 mels) the graph reads ~640 new
// input bytes at hop 160 and writes 256 bytes of logmel, and needs ~18k
// float operations: the FIR and Hann, the 256-point complex FFT, the
// untangle and |X|^2, and the mel product over the filterbank's ~500
// nonzero weights (of 16,448). Over an hour of audio the byte bound and
// the fp32 operation bound are about equal (~0.1 ms each). What holds the
// kernel above them is latency: a frame is a chain of dependent steps
// (loads, two FFT exchanges, the untangle, the mel sums), an SM holds as
// many frames as registers allow, and a dispatch of a few dozen frames
// takes one frame's chain on every SM it reaches.
//
// What the design does about it.
// - A frame is owned by m/16 threads (m = fft_size / 2 packed points; one
//   thread for m <= 16), each holding 16 complex points in registers. The
//   packed m-point FFT runs as fft.cu's Stockham passes: m = 16^q * 2^r
//   takes q radix-16 passes and at most one radix-2^r pass (256: two),
//   each DFT in registers with constant twiddles inside, the passes'
//   twiddles from kernels/fft's float64-built table (stockham_table)
//   through the read-only cache. Between passes the points cross threads
//   once through the frame's padded exchange buffer; a frame of up to 32
//   threads (fft_size <= 1024) syncs with __syncwarp over its own lanes, a
//   wider one with one __syncthreads per exchange.
// - Blocks hold block_frames frames (fewer slots, looped, where that would
//   pass kMaxThreads threads), so a 32-frame dispatch runs on many SMs and
//   the hour on all of them.
// - Every step issues its global loads together before it uses one. The
//   FIR and Hann take 4 samples a thread at a time, kInBatch vectors at
//   once, and write the packed halves straight into the exchange buffer;
//   where the frame, Hann and `filtered` row lie on 16 bytes and the
//   filter has 1 or 2 taps (pre-emphasis), in 16-byte loads and stores
//   with no bounds to check, the sample before each vector taken from the
//   neighbouring lane by a warp shuffle; elsewhere (an unaligned ring
//   slot, longer filters) with checked scalar loads.
// - The untangle gives one thread both bins k and m - k, which need the
//   same Z[k] and Z[m - k]; once every Z is read, the powers go to the
//   first m + 1 words of the re plane, unpadded.
// - The mel product reads, for column j, only the bins from its first
//   nonzero weight to its last (a span table built on the host from mel_w,
//   asr.py:mel_spans): exact for any mel_w, interior zeros included. The
//   table is copied to shared memory once a block where it fits
//   (kMelStage weights). Thread t of a frame takes columns t, t + T, ...,
//   so the short low-frequency spans and the long high ones mix in every
//   thread.
// - Registers are the compiler's choice (up to 128 at 512 threads a
//   block): a cap of 64, for twice the warps, spills the batched loads and
//   was slower (tools/asr_variants.py's regs_64).
// Each frame is filtered with zero history before its first sample and is
// computed by its own threads, so stream == framed == ring slot bitwise,
// whatever frames share its block: both in-stage paths do the FIR's
// operations in the same order on the same values. The FIR uses explicit
// round-to-nearest intrinsics in the plain PyTorch version's order, so
// `filtered` matches it bitwise; the FFT, untangle and mel sums run in
// another order (and with FMA), so logmel agrees to float32 rounding
// (ASR_LOGMEL_TOL), not bitwise. No fast-math: log1pf stays IEEE.
//
// The signal may be float32, bfloat16, float16, int16, int32, int8 or
// uint8 (the kernel is instantiated per element type, In): a sample is widened to float32 at
// its load (the vector path loads 4 samples, 4 * sizeof(In) bytes, and
// then needs the frame on that many), as the reference stages it, so every
// step after the load is the float32 one; `filtered` is stored in the
// signal's own type: rounded to nearest even for a 16-bit float, truncated
// toward zero and saturated for an integer, which is the plain version's
// cast.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "../../csrc/saturate.cuh"

namespace {

constexpr int kMaxThreads = 512;   // threads of one block at most
constexpr int kMaxLog = 13;        // m = fft_size / 2 up to 8192 points
constexpr int kMaxTaps = 64;
constexpr int kMaxMels = 256;
constexpr int kMelStage = 4096;    // span weights a block copies to shared
constexpr int kInBatch = 4;        // FIR vectors a thread loads at once

// output selection bits (cuda.py keeps the same values)
constexpr int kOutFiltered = 1;
constexpr int kOutLogmel = 2;

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
// ld4/st4 take 4 samples that lie on 4 * sizeof(In) bytes.
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

// ---- the plan of one m = 2^lg, as fft.cu's (kernels/fft/kernel.py's
// stockham_plan and stockham_table follow it)
__host__ __device__ constexpr int points_per_thread(int lg) {
  return lg < 4 ? (1 << lg) : 16;
}
__host__ __device__ constexpr int log_threads_per_frame(int lg) {
  return lg < 4 ? 0 : lg - 4;
}
__host__ __device__ constexpr int n_passes(int lg) {
  return lg <= 4 ? 1 : (lg + 3) / 4;
}
// log2 of pass p's radix: 4 but for one shorter last pass
__host__ __device__ constexpr int log_radix(int lg, int p) {
  return lg <= 4 ? lg : (p < lg / 4 ? 4 : lg % 4);
}
// log2 of Ns, the product of the radices before pass p
__host__ __device__ constexpr int log_span(int lg, int p) {
  return lg <= 4 ? 0 : 4 * p;
}
// complex twiddle entries before pass p's block (pass 0 needs none)
__host__ __device__ constexpr int twiddle_offset(int lg, int p) {
  int off = 0;
  for (int q = 1; q < p; ++q) off += 1 << (log_span(lg, q) + log_radix(lg, q));
  return off;
}

// ---- the exchange buffer of one frame: point q of the re plane at
// pad(q) = q + (q >> pad_shift), the im plane plane_words on, frames
// frame_words apart. Chosen by enumerating the banks of every access of
// the in-stage, the passes and the untangle's reads over a warp's frames:
// none conflicts at m <= 16, at most 2-way above.
__host__ __device__ constexpr int pad_shift(int lg) {
  constexpr int kPadShift[kMaxLog + 1] = {3, 3, 3, 3, 3, 4, 4,
                                          4, 4, 5, 5, 5, 5, 5};
  return kPadShift[lg];
}
__host__ __device__ constexpr int frame_gap(int lg) {
  constexpr int kFrameGap[kMaxLog + 1] = {1, 1, 1, 1, 1, 2, 4,
                                          8, 16, 0, 0, 0, 0, 0};
  return kFrameGap[lg];
}
__host__ __device__ constexpr int plane_words(int lg) {
  return (1 << lg) + ((1 << lg) >> pad_shift(lg));
}
__host__ __device__ constexpr int frame_words(int lg) {
  return 2 * plane_words(lg) + frame_gap(lg);
}
// frames a block holds at once, and its dynamic shared memory
__host__ __device__ constexpr int frame_slots(int lg, int block_frames) {
  return block_frames < (kMaxThreads >> log_threads_per_frame(lg))
             ? block_frames
             : (kMaxThreads >> log_threads_per_frame(lg));
}
// the span table in shared memory (offsets, first bins, weights), where
// its weights number at most kMelStage; else it is read from global memory
__host__ __device__ constexpr int stage_words(int n_mels, int n_packed) {
  return n_packed <= kMelStage ? 2 * n_mels + 1 + n_packed : 0;
}
__host__ __device__ constexpr size_t smem_bytes(int lg, int block_frames,
                                                int n_mels, int n_packed) {
  return sizeof(float) * (size_t(frame_words(lg)) *
                              frame_slots(lg, block_frames) +
                          stage_words(n_mels, n_packed));
}

// ---- compile-time loops: f(std::integral_constant<int, i>) for i < N
template <class F, int... Is>
__device__ __forceinline__ void static_for(F&& f,
                                           std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for(f, std::make_integer_sequence<int, N>{});
}
#define CV(x) decltype(x)::value

// ---- complex arithmetic in registers (fft.cu's)
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// cos and -sin of 2 pi e / 16, e < 16
__host__ __device__ constexpr float cos16(int e) {
  const float q[5] = {1.0f, 0.92387953251128674f, 0.70710678118654752f,
                      0.38268343236508977f, 0.0f};
  return e <= 4 ? q[e] : e <= 8 ? -q[8 - e] : e <= 12 ? -q[e - 8] : q[16 - e];
}
__host__ __device__ constexpr float neg_sin16(int e) {
  return -cos16((e + 12) & 15);   // -sin(a) = -cos(a - pi/2)
}

// v * exp(-2 pi i E / M), M dividing 16; multiples of a quarter turn are
// swaps and sign flips
template <int M, int E>
__device__ __forceinline__ float2 rot(float2 v) {
  constexpr int e = (E % M) * (16 / M);
  if constexpr (e == 0) {
    return v;
  } else if constexpr (e == 4) {
    return make_float2(v.y, -v.x);
  } else if constexpr (e == 8) {
    return make_float2(-v.x, -v.y);
  } else if constexpr (e == 12) {
    return make_float2(-v.y, v.x);
  } else {
    constexpr float c = cos16(e), ns = neg_sin16(e);
    return cmul(v, make_float2(c, ns));
  }
}

// In-place DFT of R = 1, 2, 4, 8 or 16 points, natural order in and out.
// R = A B: A-point DFTs over x[B n1 + n2], twiddles w_R^(n2 k1), B-point
// DFTs, out at k1 + A k2 (A = 4, or 2 for R = 8).
template <int R>
__device__ __forceinline__ void dft(float2 (&x)[R]) {
  if constexpr (R == 2) {
    const float2 a = x[0];
    x[0] = cadd(a, x[1]);
    x[1] = csub(a, x[1]);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(x[0], x[2]), t1 = csub(x[0], x[2]);
    const float2 t2 = cadd(x[1], x[3]), t3 = rot<4, 1>(csub(x[1], x[3]));
    x[0] = cadd(t0, t2);
    x[2] = csub(t0, t2);
    x[1] = cadd(t1, t3);
    x[3] = csub(t1, t3);
  } else if constexpr (R >= 8) {
    constexpr int A = R == 8 ? 2 : 4, B = R / A;
    float2 y[R];  // y[k1 B + n2]
    static_for<B>([&](auto n2) {
      float2 t[A];
      static_for<A>([&](auto n1) { t[CV(n1)] = x[B * CV(n1) + CV(n2)]; });
      dft<A>(t);
      static_for<A>([&](auto k1) {
        y[CV(k1) * B + CV(n2)] = rot<R, CV(k1) * CV(n2)>(t[CV(k1)]);
      });
    });
    static_for<A>([&](auto k1) {
      float2 t[B];
      static_for<B>([&](auto n2) { t[CV(n2)] = y[CV(k1) * B + CV(n2)]; });
      dft<B>(t);
      static_for<B>([&](auto k2) { x[CV(k1) + A * CV(k2)] = t[CV(k2)]; });
    });
  }
}

struct Params {
  const void* x;            // (In) the signal
  long long slot_stride;
  long long frame_stride;
  int n_frames;
  int window;
  int block_frames;
  const float* taps;
  int n_taps;
  const float* hann;        // (fft_size,) periodic Hann
  const float2* twiddles;   // stockham_table(m): the passes' twiddles
  const float* untangle;    // (2, m) cos/sin(-2 pi k / fft_size)
  const int* mel_first;     // (n_mels,) first bin of column j's span
  const int* mel_offset;    // (n_mels + 1,) column j's weights' offset
  const float* mel_packed;  // the spans' weights, column after column
  int n_packed;             // their count
  int n_mels;
  void* out_filtered;       // (rows, window) of In, or null
  float* out_logmel;        // (rows, n_mels) or null
  int* retired;             // frame counter (ring sweeps) or null
  int valid_rows;           // only rows below this count as retired
  int flags;
};

// The FIR with zero history before the frame, in the plain version's
// order: acc = 0, then acc += taps[i] * x[t - i] for i = 0, 1, ..., each
// product and sum rounded. y[c] = the FIR at sample t0 + c, from x[t0 ..
// t0 + 3] in `x`, x[t0 - 1] in `xm1` and the 2 taps of a pre-emphasis ...
__device__ __forceinline__ void fir2(float4 x, float xm1, float tap0,
                                     float tap1, float (&y)[4]) {
  const float cur[4] = {x.x, x.y, x.z, x.w};
  const float before[4] = {xm1, x.x, x.y, x.z};
  static_for<4>([&](auto c1) {
    constexpr int c = CV(c1);
    y[c] = __fadd_rn(__fadd_rn(0.f, __fmul_rn(tap0, cur[c])),
                     __fmul_rn(tap1, before[c]));
  });
}
// ... or, for any n_taps, every sample (0 from S on) and tap from the
// read-only cache
template <class In>
__device__ __forceinline__ void fir_loads(const In* __restrict__ src,
                                          int t0, int S, const float* taps,
                                          int n_taps, float (&y)[4]) {
  static_for<4>([&](auto c1) {
    constexpr int c = CV(c1);
    const int t = t0 + c;
    float acc = 0.f;
    for (int i = 0; i < n_taps; ++i) {
      const float xv = t - i >= 0 && t < S ? ld1(src + t - i) : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(taps + i), xv));
    }
    y[c] = acc;
  });
}

// |X[k]|^2 and |X[m - k]|^2 from a = Z[k], b = Z[m - k] and the untangle
// factors u = e^{-2 pi i k/N}, w = e^{-2 pi i (m - k)/N}:
// X[k] = (Z[k] + conj Z[-k])/2 - i/2 u (Z[k] - conj Z[-k]), and X[m - k]
// the same with a and b swapped (E' = conj E, O' = -conj O)
__device__ __forceinline__ void untangle_pair(float ar, float ai, float br,
                                              float bi, float ur, float ui,
                                              float wr, float wi, float& pk,
                                              float& pc) {
  const float er = (ar + br) * 0.5f, ei = (ai - bi) * 0.5f;
  const float o_r = (ar - br) * 0.5f, o_i = (ai + bi) * 0.5f;
  const float xr = er + (ur * o_i + ui * o_r);
  const float xi = ei - (ur * o_r - ui * o_i);
  const float yr = er + (wr * o_i - wi * o_r);
  const float yi = -ei - (-wr * o_r - wi * o_i);
  pk = xr * xr + xi * xi;
  pc = yr * yr + yi * yi;
}

// One block: frame_slots(LG, block_frames) frames at a time, T threads each
// (frame slot g on threads [g T, (g + 1) T)), over the block's
// block_frames frames; then, when it fits, the span table. Each step
// issues its global loads together before it uses one, so a frame waits
// for memory about once a step.
template <int LG, class In>
__global__ void __launch_bounds__(kMaxThreads)
asr_graph_kernel(const Params p) {
  constexpr int M = 1 << LG;      // packed points
  constexpr int N = 2 * M;        // fft_size
  constexpr int E = points_per_thread(LG);
  constexpr int U = E / 2;        // FIR vectors, untangle pairs a thread
  constexpr int B = U < kInBatch ? U : kInBatch;
  constexpr int LT = log_threads_per_frame(LG);
  constexpr int T = 1 << LT;
  constexpr int SH = pad_shift(LG);
  constexpr int P = plane_words(LG);
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int G = blockDim.x >> LT;
  const int i = tid & (T - 1);
  float* const sr = smem + (tid >> LT) * frame_words(LG);  // re plane
  float* const si = sr + P;                                  // im plane
  auto pad = [](int q) { return q + (q >> SH); };
  // the frame's lanes in its warp, for frames of up to 32 threads
  const unsigned fmask = (T >= 32 ? 0xffffffffu : (1u << (T & 31)) - 1)
                         << ((tid & 31) & ~(T - 1) & 31);
  auto sync = [&]() {
    if constexpr (T > 32) {
      __syncthreads();
    } else {
      __syncwarp(fmask);
    }
  };

  const int S = p.window;
  const int n_taps = p.n_taps;
  const int n_mels = p.n_mels;
  const bool want_f = (p.flags & kOutFiltered) != 0;
  const bool want_mel = (p.flags & kOutLogmel) != 0;
  const bool vec_hann = (reinterpret_cast<uintptr_t>(p.hann) & 15) == 0;
  const float tap0 = __ldg(p.taps), tap1 = n_taps > 1 ? __ldg(p.taps + 1) : 0.f;
  // the span table: copied to shared memory where it fits (after the
  // frames' exchange buffers), else read where it lies
  const bool staged = want_mel && stage_words(n_mels, p.n_packed) > 0;
  int* const so = reinterpret_cast<int*>(smem + G * frame_words(LG));
  int* const sf = so + n_mels + 1;
  float* const sw = reinterpret_cast<float*>(sf + n_mels);
  if (staged) {
    for (int t = tid; t <= n_mels; t += blockDim.x)
      so[t] = __ldg(p.mel_offset + t);
    for (int t = tid; t < n_mels; t += blockDim.x)
      sf[t] = __ldg(p.mel_first + t);
    for (int t = tid; t < p.n_packed; t += blockDim.x)
      sw[t] = __ldg(p.mel_packed + t);
  }
  __syncthreads();
  const int f_begin = blockIdx.x * p.block_frames;
  const int f_end = min(p.n_frames, f_begin + p.block_frames);
  const In* const slot =
      static_cast<const In*>(p.x) + (long long)blockIdx.y * p.slot_stride;
  const long long slot_row = (long long)blockIdx.y * p.n_frames;
  const int rounds = (f_end - f_begin + G - 1) / G;   // uniform in the block

  for (int round = 0; round < rounds; ++round) {
    const int f = f_begin + round * G + (tid >> LT);
    const bool live = f < f_end;
    if constexpr (T <= 32) {
      if (!live) break;      // a frame's threads leave together
    }
    const long long row = slot_row + f;

    // ---- FIR (zero history) on the frame's samples, 4 at a time; Hann on
    // the first fft_size, packed into the exchange buffer: z[q] = w[2q] +
    // i w[2q + 1]. Thread i takes vectors v = i + T j.
    if (live) {
      const In* const src = slot + (long long)f * p.frame_stride;
      In* const dst =
          want_f ? static_cast<In*>(p.out_filtered) + row * S : nullptr;
      constexpr uintptr_t kVec = 4 * sizeof(In) - 1;   // 4 samples' bytes
      const bool vec_in = (reinterpret_cast<uintptr_t>(src) & kVec) == 0;
      const bool vec_out = (reinterpret_cast<uintptr_t>(dst) & kVec) == 0;
      // the common case, a pre-emphasis (2 taps) with the frame and
      // `filtered` row on 4 samples' bytes and Hann on 16 bytes: the FFT
      // segment, B vectors' loads at once, no bounds to check (the
      // segment lies inside the window).
      // x[4v - 1] is vector v - 1's last sample: lane i - 1's, or for lane
      // 0 lane T - 1's vector before, by warp shuffle (a load where a frame
      // spans warps)
      const bool fast = n_taps == 2 && vec_in && vec_hann &&
                        (vec_out || !want_f);
      if (fast) {
        const float4* const h4 = reinterpret_cast<const float4*>(p.hann);
        float carry = 0.f;   // the last sample of this lane's vector before
        static_for<U / B>([&](auto b1) {
          constexpr int j0 = CV(b1) * B;
          float4 cur[B], hv[B];
          float xm1[B];
          static_for<B>([&](auto j1) {
            constexpr int j = CV(j1);
            const int v = i + T * (j0 + j);
            cur[j] = ld4(src + 4 * v);
            if (want_mel) hv[j] = __ldg(h4 + v);
            if constexpr (T > 32) xm1[j] = v > 0 ? ld1(src + 4 * v - 1) : 0.f;
          });
          static_for<B>([&](auto j1) {
            constexpr int j = CV(j1);
            const int v = i + T * (j0 + j);
            if constexpr (T <= 32) {
              const float own = j == 0 ? carry : cur[j == 0 ? 0 : j - 1].w;
              xm1[j] = j0 + j > 0 ? own : 0.f;     // T = 1: vector v - 1
              if constexpr (T > 1) {
                const float up = __shfl_up_sync(fmask, cur[j].w, 1, T);
                const float wrap = __shfl_sync(fmask, own, T - 1, T);
                xm1[j] = i > 0 ? up : (j0 + j > 0 ? wrap : 0.f);
              }
            }
            float y[4];
            fir2(cur[j], xm1[j], tap0, tap1, y);
            if (want_f) st4(dst + 4 * v, y);
            if (want_mel) {
              sr[pad(2 * v)] = __fmul_rn(y[0], hv[j].x);
              si[pad(2 * v)] = __fmul_rn(y[1], hv[j].y);
              sr[pad(2 * v + 1)] = __fmul_rn(y[2], hv[j].z);
              si[pad(2 * v + 1)] = __fmul_rn(y[3], hv[j].w);
            }
          });
          carry = cur[B - 1].w;
        });
      }
      // the rest, bounds checked: every vector where the fast path does not
      // apply (an unaligned frame or row, other filters), and the window
      // past the FFT segment for `filtered`
      const int n_vec = want_f ? (S + 3) / 4 : N / 4;
      for (int v = (fast ? N / 4 : 0) + i; v < n_vec; v += T) {
        const int t0 = 4 * v;
        float y[4];
        fir_loads(src, t0, S, p.taps, n_taps, y);
        if (want_f) {
          if (vec_out && t0 + 4 <= S) {
            st4(dst + t0, y);
          } else {
            static_for<4>([&](auto c1) {
              constexpr int c = CV(c1);
              if (t0 + c < S) st1(dst + t0 + c, y[c]);
            });
          }
        }
        if (want_mel && t0 < N) {
          sr[pad(2 * v)] = __fmul_rn(y[0], __ldg(p.hann + t0));
          si[pad(2 * v)] = __fmul_rn(y[1], __ldg(p.hann + t0 + 1));
          sr[pad(2 * v + 1)] = __fmul_rn(y[2], __ldg(p.hann + t0 + 2));
          si[pad(2 * v + 1)] = __fmul_rn(y[3], __ldg(p.hann + t0 + 3));
        }
      }
    }
    if (!want_mel) continue;   // uniform across the block
    sync();

    // ---- the passes: read points i + T mm, twiddle, DFT, write in
    // Stockham order (natural order after the last pass)
    float2 z[E];
    static_for<n_passes(LG)>([&](auto pp) {
      constexpr int LR = log_radix(LG, CV(pp));
      constexpr int RAD = 1 << LR;
      constexpr int NS = 1 << log_span(LG, CV(pp));
      constexpr int OFF = twiddle_offset(LG, CV(pp));
      static_for<E>([&](auto mm) {
        const int q = pad(i + T * CV(mm));
        z[CV(mm)] = make_float2(sr[q], si[q]);
      });
      sync();
      static_for<E / RAD>([&](auto u) {
        const int b = i + T * CV(u);   // this DFT's index in the pass
        const int k = b & (NS - 1);
        float2 y[RAD];
        static_for<RAD>([&](auto j) { y[CV(j)] = z[CV(u) + CV(j) * (E / RAD)]; });
        if constexpr (NS > 1) {
          static_for<RAD - 1>([&](auto j1) {
            constexpr int j = CV(j1) + 1;
            y[j] = cmul(y[j], __ldg(p.twiddles + OFF + j * NS + k));
          });
        }
        dft<RAD>(y);
        const int first = ((b - k) << LR) + k;
        static_for<RAD>([&](auto r) {
          const int q = pad(first + CV(r) * NS);
          sr[q] = y[CV(r)].x;
          si[q] = y[CV(r)].y;
        });
      });
      sync();
    });

    // ---- untangle, |X|^2: thread i takes bins k = i + T q (q < U) and
    // m - k, which need the same Z[k] and Z[m - k]; for k = 0, the Nyquist
    // bin Re Z[0] - Im Z[0] in place of bin m - 0; thread 0 also the middle
    // bin m/2. Once every Z is read, the powers go to sr[0 .. m], unpadded.
    {
      float pk[U], pc[U], pmid = 0.f;
      static_for<U>([&](auto q1) {
        constexpr int q = CV(q1);
        const int k = i + T * q, kc = (M - k) & (M - 1);
        const float ar = sr[pad(k)], ai = si[pad(k)];
        untangle_pair(ar, ai, sr[pad(kc)], si[pad(kc)],
                      __ldg(p.untangle + k), __ldg(p.untangle + M + k),
                      __ldg(p.untangle + kc), __ldg(p.untangle + M + kc),
                      pk[q], pc[q]);
        if (k == 0) pc[q] = (ar - ai) * (ar - ai);
      });
      if (i == 0) {
        constexpr int k = M / 2;
        const float ar = sr[pad(k)], ai = si[pad(k)];
        float unused;
        untangle_pair(ar, ai, ar, ai, __ldg(p.untangle + k),
                      __ldg(p.untangle + M + k), 0.f, 0.f, pmid, unused);
      }
      sync();
      static_for<U>([&](auto q1) {
        constexpr int q = CV(q1);
        const int k = i + T * q;
        sr[k] = pk[q];
        sr[M - k] = pc[q];
      });
      if (i == 0) sr[M / 2] = pmid;
    }
    sync();

    // ---- mel product over each column's nonzero span, log1p: thread i
    // takes columns i + T c
    auto mel = [&](const int* offset, const int* first, const float* w) {
      for (int j = i; j < n_mels; j += T) {
        const int o0 = offset[j], n = offset[j + 1] - o0;
        const float* const pw = sr + first[j];
        const float* const ww = w + o0;
        float acc = 0.f;
#pragma unroll 4
        for (int s = 0; s < n; ++s) acc = fmaf(pw[s], ww[s], acc);
        if (live) p.out_logmel[row * n_mels + j] = log1pf(acc);
      }
    };
    if (staged) {
      mel(so, sf, sw);
    } else {
      mel(p.mel_offset, p.mel_first, p.mel_packed);
    }
    sync();                 // the next round reuses the exchange buffer
  }

  // ---- retire: count this block's valid frames once they are written
  __syncthreads();
  if (p.retired != nullptr && tid == 0) {
    int done = 0;
    for (int f = f_begin; f < f_end; ++f) done += slot_row + f < p.valid_rows;
    if (done) atomicAdd(p.retired, done);
  }
}

template <int LG, class In>
cudaError_t launch_lg(const Params& p, int n_slots, cudaStream_t stream) {
  const size_t smem = smem_bytes(LG, p.block_frames, p.n_mels, p.n_packed);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        asr_graph_kernel<LG, In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.n_frames + p.block_frames - 1) / p.block_frames, n_slots);
  const int threads = frame_slots(LG, p.block_frames)
                      << log_threads_per_frame(LG);
  asr_graph_kernel<LG, In><<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class In, int LG = 1>
cudaError_t dispatch(int lg, const Params& p, int n_slots,
                     cudaStream_t stream) {
  if constexpr (LG > kMaxLog) {
    return cudaErrorInvalidValue;
  } else {
    if (lg == LG) return launch_lg<LG, In>(p, n_slots, stream);
    return dispatch<In, LG + 1>(lg, p, n_slots, stream);
  }
}

int log2_of(int n) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  return lg;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block of block_frames frames of an
// fft_size-point spectrum, with the span table of n_packed weights over
// n_mels columns.
size_t asr_graph_smem_bytes(int fft_size, int block_frames, int n_mels,
                            int n_packed) {
  return smem_bytes(log2_of(fft_size / 2), block_frames, n_mels, n_packed);
}

const char* asr_graph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the graph over n_slots x n_frames frames on `stream`, on the
// calling thread's current device; returns cudaGetLastError() after the
// launch (0 on success). Allocates nothing and does not synchronise.
// `twiddles` is kernels/fft/kernel.py's stockham_table(fft_size / 2) and
// (mel_first, mel_offset, mel_packed) asr.py's span table of mel_w. When
// `retired` is not null the kernel adds to it the frames it wrote among the
// first `valid_rows`. `dtype` is the element type of x and out_filtered:
// kFloat32, kBFloat16, kFloat16, kInt16, kInt32, kInt8 or kUInt8.
int asr_graph_launch(const void* x, int dtype, long long slot_stride,
                     long long frame_stride, int n_slots, int n_frames,
                     int window, int block_frames, const float* taps,
                     int n_taps, const float* hann, const float* twiddles,
                     const float* untangle, int fft_size,
                     const int* mel_first, const int* mel_offset,
                     const float* mel_packed, int n_packed, int n_mels,
                     void* out_filtered, float* out_logmel, int* retired,
                     int valid_rows, int flags, void* stream) {
  const int m = fft_size / 2;
  if (n_taps < 1 || n_taps > kMaxTaps || n_mels < 1 || n_mels > kMaxMels ||
      n_packed < 0 || n_slots < 1 || n_slots > 65535 || n_frames < 1 ||
      block_frames < 1 ||
      fft_size < 4 || (m & (m - 1)) != 0 || m > (1 << kMaxLog) ||
      fft_size > window || (flags & (kOutFiltered | kOutLogmel)) == 0 ||
      dtype < kFloat32 || dtype > kUInt8)
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
  p.hann = hann;
  p.twiddles = reinterpret_cast<const float2*>(twiddles);
  p.untangle = untangle;
  p.mel_first = mel_first;
  p.mel_offset = mel_offset;
  p.mel_packed = mel_packed;
  p.n_packed = n_packed;
  p.n_mels = n_mels;
  p.out_filtered = out_filtered;
  p.out_logmel = out_logmel;
  p.retired = retired;
  p.valid_rows = valid_rows;
  p.flags = flags;
  const int lg = log2_of(m);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kFloat32    ? dispatch<float>(lg, p, n_slots, st)
      : dtype == kBFloat16 ? dispatch<__nv_bfloat16>(lg, p, n_slots, st)
      : dtype == kFloat16  ? dispatch<__half>(lg, p, n_slots, st)
      : dtype == kInt16    ? dispatch<int16_t>(lg, p, n_slots, st)
      : dtype == kInt32    ? dispatch<int32_t>(lg, p, n_slots, st)
      : dtype == kInt8     ? dispatch<int8_t>(lg, p, n_slots, st)
                           : dispatch<uint8_t>(lg, p, n_slots, st));
}

}  // extern "C"
