// Batched complex FFT of (R, N) float32, bfloat16 or float16 re/im planes,
// N a power of two from 2 to 2^26, for Hopper (sm_90a), bound to PyTorch
// through a plain C interface (kernels/fft/kernel.py): N <= 8192 as one
// kernel that holds whole rows in shared memory, larger N as a four-step
// transform in two launches (below). Computed in float32, returned in the
// input's type, in natural order.
//
// Replaces fft_pallas of src/repro/kernels/fft/kernel.py:74 (body
// fft_kernel :45, pallas_call :86), which stages a block of rows in VMEM
// and runs all log2 N radix-2 stages on it in one residency.
//
// What bounds it on this card. Each point is read and written once (16
// bytes a point in float32, 8 in bfloat16 and float16) for ~5 log2 N
// float operations: under 3 operations a byte at N = 256, far below the
// fp32 ridge (67 TFLOP/s over 3.35 TB/s), so the kernel is byte-bound and
// has to keep HBM busy:
// wide loads, enough of them in flight, and little else between them.
//
// What the design does about it.
// - Radix-16 Stockham passes in registers. A row of N > 16 points is owned
//   by N/16 threads, each holding 16 complex points; N <= 16 gives a row to
//   one thread. N = 16^q * 2^r runs q radix-16 passes and, for r > 0, one
//   radix-2^r pass (each thread then runs 16 / 2^r small DFTs), so 256 takes
//   two passes, 4096 three, 8192 four. Each pass reads a thread's points i,
//   i + T, ..., i + 15 T of the row (T threads a row), multiplies them by
//   the pass's twiddles, runs the DFT in registers (radix-16 as 4 x 4
//   radix-4 butterflies with constant twiddles, no multiply by 1 or -i)
//   and writes them back in self-sorting Stockham order, so the output
//   comes out in natural order.
// - Between passes the points cross threads once through shared memory,
//   padded by one word every 2^pad_shift words so that no access pattern of
//   N = 256 (and none but the 2-way pass writes of N >= 512) conflicts on
//   a bank. A row never leaves its threads: rows of up to 32 threads (N
//   <= 512) sync with __syncwarp over the row's lanes; wider rows take
//   one __syncthreads per exchange, not one per radix-2 stage.
// - Global memory is read and written once, in 16-byte vectors (8 or 4
//   bytes where the row is shorter), streamed past L1 (ld/st .cs): each
//   thread puts its row's vectors into shared memory, the first pass reads
//   them from there, and the last pass's output leaves the same way.
// - Templated on log2 N: every index is a shift or a mask, no division.
//   One instantiation per N from 2 to 8192 and per input type (39).
// - Twiddles come from a host-side table (float64 cos/sin cast to float32,
//   kernel.py:stockham_table) read through the read-only cache: pass p's
//   block holds w^(j k) = exp(-2 pi i j k / (Ns R)) at j * Ns + k, Ns the
//   product of the earlier radices. The inverse transform swaps re and im
//   on the way in and out (ifft(x) = swap(fft(swap(x))) / N) and scales by
//   1/N, exact for a power of two. FMAs contract freely: the kernel agrees
//   with the plain radix-2 chain to float32 rounding, not bitwise.
//
// N > 8192: the four-step transform. A row no longer fits a block's shared
// memory, so N = N1 N2 (N1 = 2^ceil(lg/2), N2 = 2^floor(lg/2), both <=
// 8192) runs in two launches through a float32 scratch of R x N points:
//   1. for each n2 < N2, the column x[N2 n1 + n2] (n1 < N1) transformed
//      by the same radix-16 passes, its point k1 multiplied by
//      W_N^(n2 k1) and stored at scratch[k1 N2 + n2];
//   2. for each k1 < N1, the row scratch[k1 N2 + n2] (n2 < N2)
//      transformed, its point k2 stored at out[k1 + N1 k2]: natural order.
// A block holds 8192 points: 8192 / L lines of L points, consecutive
// columns (pass 1) or consecutive k1 (pass 2), so that each strided
// access moves 8192 / L consecutive elements (32 bytes of float32 at N =
// 2^20) while the other side is contiguous. The inter-pass twiddle comes
// from two host tables cast once from float64 (W_N^j for j < N1 and
// W_N^(j N1) for j < N2) as one float32 product, W_N^e = coarse[e >> lg1]
// fine[e & (N1 - 1)], e = n2 k1 < N: no angle is ever a float32 number,
// which at N = 2^24 would lose 7 bits. The inverse swaps re and im as
// above (pass 1 reads swapped, pass 2 writes swapped and scales). The
// scratch costs bytes: a point is read and written twice (16 + 16 bytes of
// scratch beside the input and output's), so the pair is byte-bound at
// about 3x the one-launch kernel's traffic in float32. One instantiation
// per line length 2^7 to 2^13, pass and type (42).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxLog = 13;          // one launch up to 8192 points a row
constexpr int kMaxFourStepLog = 26;  // two launches up to 2^26
constexpr int kFourStepPoints = 8192;  // points a four-step block holds

// element types (kernel.py keeps the same codes)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

// ---- the plan of one N = 2^lg, shared by the kernel and the host
__host__ __device__ constexpr int points_per_thread(int lg) {
  return lg < 4 ? (1 << lg) : 16;
}
__host__ __device__ constexpr int log_threads_per_row(int lg) {
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
// shared layout: element p of a row at p + (p >> pad_shift), rows
// row_stride words apart (found by enumerating every access pattern's
// banks per N; N = 256 is conflict-free throughout)
__host__ __device__ constexpr int pad_shift(int lg) {
  return lg <= 3 || lg == 6 ? 3 : (lg <= 8 ? 4 : 5);
}
__host__ __device__ constexpr int row_stride(int lg) {
  return (1 << lg) + ((1 << lg) >> pad_shift(lg)) +
         (lg <= 2 ? 1 : (lg == 6 ? 4 : 0));
}
__host__ __device__ constexpr size_t smem_bytes(int lg, int rows) {
  return sizeof(float) * 2 * size_t(row_stride(lg)) * rows;
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

// ---- complex arithmetic in registers
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

// ---- global vectors: VE elements of T in one load or store
template <int BYTES> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<4> { using type = unsigned int; };

template <typename T, int VE>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VE]) {
  using V = typename VecOf<VE * sizeof(T)>::type;
  const V raw = __ldcs(reinterpret_cast<const V*>(p));
  uint32_t w[sizeof(V) / 4];
  memcpy(w, &raw, sizeof(V));
  if constexpr (sizeof(T) == 4) {
    static_for<VE>([&](auto c) { v[CV(c)] = __uint_as_float(w[CV(c)]); });
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_for<VE / 2>([&](auto c) {
      v[2 * CV(c)] = __uint_as_float(w[CV(c)] << 16);
      v[2 * CV(c) + 1] = __uint_as_float(w[CV(c)] & 0xffff0000u);
    });
  } else {
    static_for<VE / 2>([&](auto c) {
      v[2 * CV(c)] = __half2float(__ushort_as_half(w[CV(c)] & 0xffffu));
      v[2 * CV(c) + 1] = __half2float(__ushort_as_half(w[CV(c)] >> 16));
    });
  }
}

template <typename T, int VE>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VE]) {
  using V = typename VecOf<VE * sizeof(T)>::type;
  uint32_t w[sizeof(V) / 4];
  if constexpr (sizeof(T) == 4) {
    static_for<VE>([&](auto c) { w[CV(c)] = __float_as_uint(v[CV(c)]); });
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    static_for<VE / 2>([&](auto c) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(v[2 * CV(c)], v[2 * CV(c) + 1]);
      memcpy(&w[CV(c)], &h, 4);
    });
  } else {
    static_for<VE / 2>([&](auto c) {
      const __half2 h = __floats2half2_rn(v[2 * CV(c)], v[2 * CV(c) + 1]);
      memcpy(&w[CV(c)], &h, 4);
    });
  }
  V raw;
  memcpy(&raw, w, sizeof(V));
  __stcs(reinterpret_cast<V*>(p), raw);
}

// The passes over one row of N = 2^LG points in shared memory (element p
// at p + (p >> pad_shift)): thread i < T of the row reads points i + T m,
// twiddles, runs the DFTs in registers and writes them back in Stockham
// order; `sync` orders the row's threads between the reads and the writes.
template <int LG, class Sync>
__device__ __forceinline__ void stockham_passes(float* sr, float* si,
                                                const float2* __restrict__ tw,
                                                int i, Sync&& sync) {
  constexpr int E = points_per_thread(LG);
  constexpr int TPR = 1 << log_threads_per_row(LG);
  constexpr int SH = pad_shift(LG);
  auto pad = [](int p) { return p + (p >> SH); };
  float2 x[E];
  static_for<n_passes(LG)>([&](auto p) {
    constexpr int LR = log_radix(LG, CV(p));
    constexpr int RAD = 1 << LR;
    constexpr int NS = 1 << log_span(LG, CV(p));
    constexpr int OFF = twiddle_offset(LG, CV(p));
    static_for<E>([&](auto m) {
      const int q = pad(i + TPR * CV(m));
      x[CV(m)] = make_float2(sr[q], si[q]);
    });
    sync();
    static_for<E / RAD>([&](auto u) {
      const int b = i + TPR * CV(u);      // this DFT's index in the pass
      const int k = b & (NS - 1);
      float2 y[RAD];
      static_for<RAD>([&](auto j) { y[CV(j)] = x[CV(u) + CV(j) * (E / RAD)]; });
      if constexpr (NS > 1) {
        static_for<RAD - 1>([&](auto j1) {
          constexpr int j = CV(j1) + 1;
          y[j] = cmul(y[j], __ldg(tw + OFF + j * NS + k));
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
}

// One block: `rows` rows of N = 2^LG points, T = N / E threads each (row r
// on threads [r T, (r + 1) T)). Shared memory: the rows' re planes, then
// their im planes, row_stride(LG) words a row.
template <int LG, typename T>
__global__ void __launch_bounds__(kMaxThreads)
fft_kernel(const T* __restrict__ re, const T* __restrict__ im,
           const float2* __restrict__ tw, T* __restrict__ out_re,
           T* __restrict__ out_im, long long R, int rows, float scale) {
  constexpr int N = 1 << LG;
  constexpr int E = points_per_thread(LG);
  constexpr int LT = log_threads_per_row(LG);
  constexpr int TPR = 1 << LT;
  constexpr int S = row_stride(LG);
  constexpr int SH = pad_shift(LG);
  constexpr int VE = N < int(16 / sizeof(T)) ? N : int(16 / sizeof(T));
  constexpr int NV = E / VE;  // vectors a thread moves per plane
  extern __shared__ __align__(16) float smem[];

  const int t = threadIdx.x;
  const int lrow = t >> LT;
  const int i = t & (TPR - 1);
  const long long row = (long long)blockIdx.x * rows + lrow;
  const bool live = row < R;
  float* sr = smem + lrow * S;
  float* si = smem + (rows + lrow) * S;
  auto pad = [](int p) { return p + (p >> SH); };
  auto sync = [&]() {
    if constexpr (TPR > 32) {
      __syncthreads();
    } else {
      constexpr unsigned kRow = TPR == 32 ? 0xffffffffu : (1u << TPR) - 1;
      __syncwarp(kRow << ((t & 31) & ~(TPR - 1)));
    }
  };

  // in: each thread moves vectors i, i + T, ... of its row to shared
  if (live) {
    const long long base = row * N;
    static_for<NV>([&](auto j) {
      const int g = i + TPR * CV(j);
      float vr[VE], vi[VE];
      load_vec<T, VE>(re + base + VE * g, vr);
      load_vec<T, VE>(im + base + VE * g, vi);
      static_for<VE>([&](auto c) {
        const int q = pad(VE * g + CV(c));
        sr[q] = vr[CV(c)];
        si[q] = vi[CV(c)];
      });
    });
  }
  sync();

  stockham_passes<LG>(sr, si, tw, i, sync);

  // out: the same vectors back to global memory, scaled
  if (live) {
    const long long base = row * N;
    static_for<NV>([&](auto j) {
      const int g = i + TPR * CV(j);
      float vr[VE], vi[VE];
      static_for<VE>([&](auto c) {
        const int q = pad(VE * g + CV(c));
        vr[CV(c)] = sr[q] * scale;
        vi[CV(c)] = si[q] * scale;
      });
      store_vec<T, VE>(out_re + base + VE * g, vr);
      store_vec<T, VE>(out_im + base + VE * g, vi);
    });
  }
}

template <int LG, typename T>
cudaError_t launch_n(const void* re, const void* im, const float2* tw,
                     void* out_re, void* out_im, long long R, int rows,
                     float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(LG, rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_kernel<LG, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (R + rows - 1) / rows;
  const int threads = rows << log_threads_per_row(LG);
  fft_kernel<LG, T><<<static_cast<unsigned>(blocks), threads, smem,
                      stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im), tw,
      static_cast<T*>(out_re), static_cast<T*>(out_im), R, rows, scale);
  return cudaGetLastError();
}

template <typename T, int LG = 1>
cudaError_t dispatch(int lg, const void* re, const void* im,
                     const float2* tw, void* out_re, void* out_im,
                     long long R, int rows, float scale,
                     cudaStream_t stream) {
  if constexpr (LG > kMaxLog) {
    return cudaErrorInvalidValue;
  } else {
    if (lg == LG)
      return launch_n<LG, T>(re, im, tw, out_re, out_im, R, rows, scale,
                             stream);
    return dispatch<T, LG + 1>(lg, re, im, tw, out_re, out_im, R, rows,
                               scale, stream);
  }
}

// ---- the four-step transform: pass 1 (columns, twiddled) and pass 2
// (rows, stored transposed), each over lines of L = 2^LG points, a block
// holding kFourStepPoints / L consecutive lines of one row of the input.

// Words between two lines in shared memory: row_stride(lg) raised until
// the block's lines spread a warp's strided accesses over the banks. A
// warp then holds m = min(lines, 32) lines times 32 / m consecutive
// points, which take distinct banks where the stride is 32 / m times an
// odd number.
__host__ __device__ constexpr int four_step_stride(int lg) {
  const int lines = kFourStepPoints >> lg;
  const int c = lines >= 32 ? 1 : 32 / lines;
  int s = row_stride(lg);
  while (lines > 1 && s % (2 * c) != c) ++s;
  return s;
}
__host__ __device__ constexpr size_t four_step_smem_bytes(int lg) {
  return sizeof(float) * 2 * size_t(four_step_stride(lg)) *
         (kFourStepPoints >> lg);
}
// log2 N1 (the columns' length) and log2 N2 of N = 2^lg
__host__ __device__ constexpr int log_n1(int lg) { return (lg + 1) / 2; }
__host__ __device__ constexpr int log_n2(int lg) { return lg / 2; }

template <typename T>
__device__ __forceinline__ float widen(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(v);
  } else {
    return __half2float(v);
  }
}
template <typename T>
__device__ __forceinline__ T narrow(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else {
    return __float2half_rn(v);
  }
}

// Lines of 2^LG points; the row's other factor is 2^lg_lines (its lines).
// SECOND = false, pass 1: line n2 holds a[N2 n1 + n2] (n1 < N1 = 2^LG),
// its transform's point k1 leaves times W_N^(n2 k1) for oa[k1 N2 + n2].
// SECOND = true, pass 2: line k1 holds a[k1 N2 + n2] (n2 < N2 = 2^LG),
// its point k2 leaves times `scale` for oa[k1 + N1 k2]. The same for b
// and ob (the imaginary planes). tw is the line transform's table (as
// stockham_table(2^LG)); fine and coarse the inter-pass factors (pass 1).
template <int LG, typename TI, typename TO, bool SECOND>
__global__ void __launch_bounds__(kMaxThreads)
four_step_kernel(const TI* __restrict__ a, const TI* __restrict__ b,
                 const float2* __restrict__ tw,
                 const float2* __restrict__ fine,
                 const float2* __restrict__ coarse, TO* __restrict__ oa,
                 TO* __restrict__ ob, int lg_lines, float scale) {
  constexpr int L = 1 << LG;
  constexpr int LT = log_threads_per_row(LG);
  constexpr int TPR = 1 << LT;
  constexpr int LG_LINES = 13 - LG;           // log2 of the block's lines
  constexpr int LINES = 1 << LG_LINES;
  constexpr int POINTS = kFourStepPoints;     // LINES * L
  constexpr int THREADS = LINES * TPR;        // kMaxThreads
  constexpr int S = four_step_stride(LG);
  constexpr int SH = pad_shift(LG);
  extern __shared__ __align__(16) float smem[];

  const int t = threadIdx.x;
  const long long line0 = (long long)blockIdx.x * LINES;
  const long long base = (line0 >> lg_lines) << (LG + lg_lines);  // row r
  const int c0 = static_cast<int>(line0 & ((1LL << lg_lines) - 1));
  auto at = [](int l, int p) { return l * S + p + (p >> SH); };
  float* const sr = smem;
  float* const si = smem + LINES * S;

  // in: pass 1 reads the block's LINES columns a point at a time (LINES
  // consecutive elements); pass 2 reads its lines, one contiguous span
  for (int q = t; q < POINTS; q += THREADS) {
    int l, p;
    long long g;
    if constexpr (SECOND) {
      l = q >> LG;
      p = q & (L - 1);
      g = base + ((long long)c0 << LG) + q;
    } else {
      l = q & (LINES - 1);
      p = q >> LG_LINES;
      g = base + ((long long)p << lg_lines) + c0 + l;
    }
    sr[at(l, p)] = widen(a[g]);
    si[at(l, p)] = widen(b[g]);
  }
  __syncthreads();

  const int lrow = t >> LT;
  auto sync = [&]() {
    if constexpr (TPR > 32) {
      __syncthreads();
    } else {
      constexpr unsigned kRow = TPR == 32 ? 0xffffffffu : (1u << TPR) - 1;
      __syncwarp(kRow << ((t & 31) & ~(TPR - 1)));
    }
  };
  stockham_passes<LG>(sr + lrow * S, si + lrow * S, tw, t & (TPR - 1), sync);
  __syncthreads();

  // out: a point of each of the block's lines at a time, LINES consecutive
  // elements: pass 1 at k1 N2 + n2, pass 2 at k1 + N1 k2
  for (int q = t; q < POINTS; q += THREADS) {
    const int l = q & (LINES - 1);
    const int p = q >> LG_LINES;
    float2 v = make_float2(sr[at(l, p)], si[at(l, p)]);
    if constexpr (SECOND) {
      const long long g = base + c0 + l + ((long long)p << lg_lines);
      oa[g] = narrow<TO>(v.x * scale);
      ob[g] = narrow<TO>(v.y * scale);
    } else {
      const int e = (c0 + l) * p;             // n2 k1 < N
      v = cmul(v, cmul(__ldg(coarse + (e >> LG)), __ldg(fine + (e & (L - 1)))));
      const long long g = base + ((long long)p << lg_lines) + c0 + l;
      oa[g] = narrow<TO>(v.x);
      ob[g] = narrow<TO>(v.y);
    }
  }
}

template <int LG, typename TI, typename TO, bool SECOND>
cudaError_t launch_four_step(const void* a, const void* b, const float2* tw,
                             const float2* fine, const float2* coarse,
                             void* oa, void* ob, long long R, int lg_lines,
                             float scale, cudaStream_t stream) {
  constexpr size_t smem = four_step_smem_bytes(LG);
  const cudaError_t err = cudaFuncSetAttribute(
      four_step_kernel<LG, TI, TO, SECOND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // R << (LG + lg_lines) points, kFourStepPoints a block
  const long long blocks = R << (LG + lg_lines - 13);
  four_step_kernel<LG, TI, TO, SECOND>
      <<<static_cast<unsigned>(blocks), kMaxThreads, smem, stream>>>(
          static_cast<const TI*>(a), static_cast<const TI*>(b), tw, fine,
          coarse, static_cast<TO*>(oa), static_cast<TO*>(ob), lg_lines,
          scale);
  return cudaGetLastError();
}

// pass 1 on lines of 2^lg1 (LG from 7) and pass 2 on lines of 2^lg2
template <typename T, bool SECOND, int LG = 7>
cudaError_t dispatch_four_step(int lg, const void* a, const void* b,
                               const float2* tw, const float2* fine,
                               const float2* coarse, void* oa, void* ob,
                               long long R, int lg_lines, float scale,
                               cudaStream_t stream) {
  if constexpr (LG > kMaxLog) {
    return cudaErrorInvalidValue;
  } else {
    using TI = typename std::conditional<SECOND, float, T>::type;
    using TO = typename std::conditional<SECOND, T, float>::type;
    if (lg == LG)
      return launch_four_step<LG, TI, TO, SECOND>(
          a, b, tw, fine, coarse, oa, ob, R, lg_lines, scale, stream);
    return dispatch_four_step<T, SECOND, LG + 1>(
        lg, a, b, tw, fine, coarse, oa, ob, R, lg_lines, scale, stream);
  }
}

template <typename T>
cudaError_t four_step_pass(int lg, int pass, const void* a, const void* b,
                           const float2* tables, void* sa, void* sb,
                           void* oa, void* ob, long long R, float scale,
                           cudaStream_t stream) {
  const int lg1 = log_n1(lg), lg2 = log_n2(lg);
  const float2* tw1 = tables;
  const float2* tw2 = tw1 + twiddle_offset(lg1, n_passes(lg1));
  const float2* fine = tw2 + twiddle_offset(lg2, n_passes(lg2));
  const float2* coarse = fine + (1 << lg1);
  return pass == 0
             ? dispatch_four_step<T, false>(lg1, a, b, tw1, fine, coarse, sa,
                                            sb, R, lg2, 1.0f, stream)
             : dispatch_four_step<T, true>(lg2, sa, sb, tw2, fine, coarse,
                                           oa, ob, R, lg1, scale, stream);
}

int log2_of(int n) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  return lg;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block of rows_per_block rows of N points.
size_t fft_smem_bytes(int n, int rows_per_block) {
  return smem_bytes(log2_of(n), rows_per_block);
}

// Threads of one row of N points (the block has rows x this many).
int fft_threads_per_row(int n) { return 1 << log_threads_per_row(log2_of(n)); }

// Complex entries of the twiddle table for N points (kernel.py builds it).
int fft_table_size(int n) {
  const int lg = log2_of(n);
  return twiddle_offset(lg, n_passes(lg));
}

const char* fft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// (out_re, out_im) = FFT(re + i im) over the rows of (R, N) row-major planes
// of `dtype` (kFloat32, kBFloat16 or kFloat16), N <= 8192, each base aligned to min(16, N x
// element size) bytes, with the twiddle table `tw` of kernel.py's
// stockham_table(N) (fft_table_size(N) float2); `inverse` != 0 gives the
// inverse transform divided by N. Runs on `stream`, on the calling thread's
// current device; returns cudaGetLastError() after the launch (0 on
// success). Allocates nothing and does not synchronise.
int fft_launch(const void* re, const void* im, const float* tw,
               void* out_re, void* out_im, long long R, int N,
               int rows_per_block, int inverse, int dtype, void* stream) {
  const int lg = log2_of(N);
  if (R < 1 || N < 2 || N > (1 << kMaxLog) || (N & (N - 1)) != 0 ||
      rows_per_block < 1 ||
      (rows_per_block << log_threads_per_row(lg)) > kMaxThreads ||
      dtype < kFloat32 || dtype > kFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* w = reinterpret_cast<const float2*>(tw);
  // the inverse is the forward transform with re and im swapped on the way
  // in and out: ifft(x) = swap(fft(swap(x))) / N
  const void* a = inverse ? im : re;
  const void* b = inverse ? re : im;
  void* oa = inverse ? out_im : out_re;
  void* ob = inverse ? out_re : out_im;
  const float scale = inverse ? 1.0f / static_cast<float>(N) : 1.0f;
  const cudaError_t err =
      dtype == kFloat32
          ? dispatch<float>(lg, a, b, w, oa, ob, R, rows_per_block, scale, st)
      : dtype == kBFloat16
          ? dispatch<__nv_bfloat16>(lg, a, b, w, oa, ob, R, rows_per_block,
                                    scale, st)
          : dispatch<__half>(lg, a, b, w, oa, ob, R, rows_per_block, scale,
                             st);
  return static_cast<int>(err);
}

// Shared-memory bytes of one block of the four-step pass `pass` (0: the
// columns, 1: the rows) for N points.
size_t fft_four_step_smem_bytes(int n, int pass) {
  const int lg = log2_of(n);
  return four_step_smem_bytes(pass == 0 ? log_n1(lg) : log_n2(lg));
}

// Complex entries of the four-step table for N points (kernel.py's
// four_step_table: the line transforms' tables of N1 and N2 points, then
// W_N^j for j < N1 and W_N^(j N1) for j < N2).
int fft_four_step_table_size(int n) {
  const int lg = log2_of(n), lg1 = log_n1(lg), lg2 = log_n2(lg);
  return twiddle_offset(lg1, n_passes(lg1)) +
         twiddle_offset(lg2, n_passes(lg2)) + (1 << lg1) + (1 << lg2);
}

// Pass `pass` of the four-step FFT over the rows of (R, N) row-major planes
// of `dtype`, 8192 < N <= 2^26: pass 0 reads (re, im) and writes the
// float32 (R, N) planes (scratch_re, scratch_im); pass 1 reads those and
// writes (out_re, out_im) in `dtype`. `tables` is kernel.py's
// four_step_table(N) (fft_four_step_table_size(N) float2). Run pass 0, then
// pass 1 on the same stream, with the same `inverse`; the pair gives what
// fft_launch gives. Returns cudaGetLastError() after the launch (0 on
// success). Allocates nothing and does not synchronise.
int fft_four_step_launch(const void* re, const void* im, const float* tables,
                         void* scratch_re, void* scratch_im, void* out_re,
                         void* out_im, long long R, int N, int pass,
                         int inverse, int dtype, void* stream) {
  const int lg = log2_of(N);
  if (R < 1 || N <= (1 << kMaxLog) || N > (1 << kMaxFourStepLog) ||
      (N & (N - 1)) != 0 || (pass != 0 && pass != 1) || dtype < kFloat32 ||
      dtype > kFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* w = reinterpret_cast<const float2*>(tables);
  // ifft(x) = swap(fft(swap(x))) / N, as in fft_launch: the columns read
  // swapped planes and the rows write swapped planes, scaled
  const void* a = inverse ? im : re;
  const void* b = inverse ? re : im;
  void* oa = inverse ? out_im : out_re;
  void* ob = inverse ? out_re : out_im;
  const float scale = inverse ? 1.0f / static_cast<float>(N) : 1.0f;
  const cudaError_t err =
      dtype == kFloat32
          ? four_step_pass<float>(lg, pass, a, b, w, scratch_re, scratch_im,
                                  oa, ob, R, scale, st)
      : dtype == kBFloat16
          ? four_step_pass<__nv_bfloat16>(lg, pass, a, b, w, scratch_re,
                                          scratch_im, oa, ob, R, scale, st)
          : four_step_pass<__half>(lg, pass, a, b, w, scratch_re,
                                   scratch_im, oa, ob, R, scale, st);
  return static_cast<int>(err);
}

}  // extern "C"
