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
//   1. for each n2 < N2, the column x[N2 n1 + n2] (n1 < N1) transformed,
//      its point k1 multiplied by W_N^(n2 k1) and stored in the scratch
//      at ((n2 >> 4) N1 + k1) 16 + (n2 & 15): tiles of 16 columns by 16
//      points, so that a tile of pass 1 stores whole 64-byte rows of one
//      tile column and pass 2 reads whole 1 KB tiles;
//   2. for each k1 < N1, the row of the scratch's points (k1, n2) (n2 <
//      N2) transformed, its point k2 stored at out[k1 + N1 k2]: natural
//      order.
// Each pass is byte-bound: the scratch doubles the bytes (a point read
// and written twice), so the pair's floor is twice the one-launch bound.
// What the design does about it:
// - A tile is kFourStepLines = 16 lines (consecutive columns in pass 1,
//   consecutive k1 in pass 2), so the strided global accesses -- pass 1's
//   read and pass 2's transposed write -- move 16 consecutive elements of
//   a plane (64 bytes of float32, 32 of a 16-bit type); pass 1's scratch
//   rows are 64 bytes apart within a tile column, and pass 2 reads 1 KB
//   tiles of the scratch.
// - A tile of long lines is shared by a thread-block cluster of up to
//   kMaxCluster blocks of at least kFourStepBlockPoints points. The line
//   transform's first step is radix-K decimation in frequency (M = L / K):
//     y_j[n] = W_L^(n j) sum_m x[n + m M] W_K^(m j),  X[K k' + j] =
//     DFT_M(y_j)[k'].
//   Block h loads the points n + m M (m < K) of the n it owns (h M / K ..
//   (h + 1) M / K - 1), runs that step in registers and stores each
//   y_j[n] into block j's shared memory (distributed shared memory): each
//   point crosses the cluster once. After a cluster barrier block j runs
//   the M-point transforms of y_j. So one 2^20 row is 256 blocks of 4096
//   points a pass (about two for each of 132 SMs), a block takes 34-135
//   KB of shared memory, and no tile's lines pass through device memory
//   a second time. (Reading all K shares in every block instead moved
//   each point K times and ran 2.7x slower than the older four-step at 64
//   rows of 2^20.) Pass 1 may go through its own shared memory first,
//   so that its stores into the cluster are as contiguous as pass 2's
//   (`staged`), and each pass lets the next one launch while it stores
//   (programmatic dependent launch).
// - The inter-pass twiddle comes from two host tables cast once from
//   float64 (W_N^j for j < N1 and W_N^(j N1) for j < N2) as one float32
//   product, W_N^e = coarse[e >> lg1] fine[e & (N1 - 1)], e = n2 k1 < N,
//   for the first of a vector's 4 columns, times W_N^k1 = fine[k1] for
//   each next one (3 products at most: ~1e-7 of error, under FFT_TOL);
//   the radix-K step's from W_L^j (j < L), cast once as well: no angle is
//   ever a float32 number, which at N = 2^24 would lose 7 bits. The
//   inverse swaps re and im as above (pass 1 reads swapped, pass 2 writes
//   swapped and scales).
// One instantiation per line length L = 2^7 to 2^13, pass and type (42).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>
#include <utility>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;
constexpr int kMaxLog = 13;          // one launch up to 8192 points a row
constexpr int kMaxFourStepLog = 26;  // two launches up to 2^26
constexpr int kFourStepLines = 16;        // lines of a four-step tile
constexpr int kFourStepBlockPoints = 4096;  // the least points of a block
constexpr int kMaxCluster = 8;            // blocks sharing a tile's lines

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
// at p + (p >> SH)): thread i < T of the row reads points i + T m,
// twiddles, runs the DFTs in registers and writes them back in Stockham
// order; `sync` orders the row's threads between the reads and the writes.
template <int LG, int SH, class Sync>
__device__ __forceinline__ void stockham_passes_padded(
    float* sr, float* si, const float2* __restrict__ tw, int i, Sync&& sync) {
  constexpr int E = points_per_thread(LG);
  constexpr int TPR = 1 << log_threads_per_row(LG);
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
template <int LG, class Sync>
__device__ __forceinline__ void stockham_passes(float* sr, float* si,
                                                const float2* __restrict__ tw,
                                                int i, Sync&& sync) {
  stockham_passes_padded<LG, pad_shift(LG)>(sr, si, tw, i, sync);
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
// (rows, stored transposed). A tile is kFourStepLines lines of one row of
// the input, consecutive columns (pass 1) or consecutive k1 (pass 2), so
// that every strided global access moves kFourStepLines consecutive
// elements. A line of L points is shared by a cluster of K blocks
// (log_cluster): block h of the cluster loads the points h M .. (h + 1) M
// - 1 (M = L / K) of the tile's lines, and after a cluster barrier runs
// the first, radix-K step of each line's transform in decimation in
// frequency over the cluster's shared memory,
//   y_h[n] = W_L^(n h) sum_j x[n + j M] W_K^(j h),   n < M,
// then the M-point transform of y_h in its own shared memory, which gives
// the line's points X[K k' + h]. K = 1 where a tile fits one block.

__host__ __device__ constexpr int ilog2(int v) {
  return v <= 1 ? 0 : 1 + ilog2(v >> 1);
}
// log2 of the cluster of a pass over lines of 2^lg_l points: the tile
// over kFourStepBlockPoints, at most kMaxCluster
__host__ __device__ constexpr int log_cluster(int lg_l) {
  const int e = lg_l + ilog2(kFourStepLines) - ilog2(kFourStepBlockPoints);
  return e < 0 ? 0 : (e > ilog2(kMaxCluster) ? ilog2(kMaxCluster) : e);
}
// log2 of M, the points of a line each block of the cluster transforms
__host__ __device__ constexpr int log_sub(int lg_l) {
  return lg_l - log_cluster(lg_l);
}
// threads of a block over kFourStepLines sub-lines of 2^lm points: 16
// points a thread, at most kMaxThreads (then two sweeps of the lines)
__host__ __device__ constexpr int four_step_threads(int lm) {
  return (kFourStepLines << lm) / 16 < kMaxThreads
             ? (kFourStepLines << lm) / 16
             : kMaxThreads;
}
// Shared layout of a four-step block: point p of line l at
//   l S + 8 (l >> 2) + p + (p >> kFourStepPadShift),
// S = four_step_stride(LM): one pad word every 32 points, so that a
// warp's 32 consecutive points of a line fall on 32 banks; S = M / 16 mod
// 32 where a warp's stockham passes span 32 / (M / 16) lines (M < 512),
// so that those lines fall on distinct banks; and the skew of 8 words
// every 4 lines, so that the global sides' 8 (16) points of 4 (8)
// consecutive lines a 16-byte vector of 4 (2) vectors a point do too.
constexpr int kFourStepPadShift = 5;
__host__ __device__ constexpr int four_step_stride(int lm) {
  int s = (1 << lm) + ((1 << lm) >> kFourStepPadShift);
  while (s % 32 != ((1 << lm) / 16) % 32) ++s;
  return s;
}
__host__ __device__ constexpr int four_step_line(int lm, int l) {
  return l * four_step_stride(lm) + 8 * (l >> 2);
}
// words of one plane: the last line's base and its padded points
__host__ __device__ constexpr int four_step_plane(int lm) {
  return four_step_line(lm, kFourStepLines - 1) + (1 << lm) +
         ((1 << lm) >> kFourStepPadShift);
}
__host__ __device__ constexpr size_t four_step_smem_bytes(int lm) {
  return sizeof(float) * 2 * size_t(four_step_plane(lm));
}
// The cluster's barrier in halves (PTX barrier.cluster): a relaxed arrive
// orders no memory access, so a block's loads stay in flight across it.
__device__ __forceinline__ void cluster_arrive_relaxed() {
#if defined(__CUDA_ARCH__)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
#endif
}
__device__ __forceinline__ void cluster_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
#endif
}
// Programmatic dependent launch (PTX griddepcontrol): a pass lets the
// next kernel on its stream be scheduled once every block of it has
// reached its stores, and waits for the kernels before it to finish (and
// their writes to be visible) before it touches device memory, so that a
// pass's launch and set-up overlap the tail of the one before.
__device__ __forceinline__ void launch_dependents() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.launch_dependents;\n" : : : "memory");
#endif
}
__device__ __forceinline__ void wait_for_prerequisites() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.wait;\n" : : : "memory");
#endif
}
// log2 N1 (the columns' length) and log2 N2 of N = 2^lg
__host__ __device__ constexpr int log_n1(int lg) { return (lg + 1) / 2; }
__host__ __device__ constexpr int log_n2(int lg) { return lg / 2; }

// One block of a four-step pass over lines of L = 2^LGL points of rows of
// L 2^lg_o points: a cluster of K = 2^log_cluster(LGL) blocks
// (blockIdx.x >> log K, the tile) shares the tile's lines; block h =
// blockIdx.x mod K of it transforms the sub-lines y_h of M = L / K points.
// SECOND = false, pass 1 (L = N1, 2^lg_o = N2): line c holds column n2 =
// c0 + c, a[N2 n1 + n2] (n1 < N1); its point k1 leaves times W_N^(n2 k1)
// for oa[k1 N2 + n2] (float32 scratch).
// SECOND = true, pass 2 (L = N2, 2^lg_o = N1): line c holds k1 = c0 + c,
// a[k1 N2 + n2] (n2 < N2) of the scratch; its point k2 leaves times
// `scale` for oa[k1 + N1 k2].
// The same for b and ob (the imaginary planes). tw is the M-point
// transform's table (stockham_table(M)); split holds W_L^j (j < L);
// fine and coarse the inter-pass factors (pass 1).
template <int LGL, typename TI, typename TO, bool SECOND>
__global__ void __launch_bounds__(kMaxThreads)
four_step_kernel(const TI* __restrict__ a, const TI* __restrict__ b,
                 const float2* __restrict__ tw,
                 const float2* __restrict__ split,
                 const float2* __restrict__ fine,
                 const float2* __restrict__ coarse, TO* __restrict__ oa,
                 TO* __restrict__ ob, int lg_o, float scale, int staged) {
  constexpr int LK = log_cluster(LGL);
  constexpr int K = 1 << LK;
  constexpr int LM = LGL - LK;
  constexpr int M = 1 << LM;
  constexpr int C = kFourStepLines;
  constexpr int LC = ilog2(C);
  constexpr int THREADS = four_step_threads(LM);
  constexpr int LT = log_threads_per_row(LM);
  constexpr int TPR = 1 << LT;
  constexpr int GROUP = THREADS / TPR;        // lines a sweep of threads
  constexpr int NB = M / K;                   // the points n a block owns
  constexpr int VU = K >= 8 ? 2 : 4;          // (line, n) pairs a unit
  constexpr int UNITS = C * NB / VU / THREADS;
  constexpr int SH = kFourStepPadShift;
  static_assert(UNITS >= 1 && NB % VU == 0, "a thread's units");
  extern __shared__ __align__(16) float smem[];
  float* const sr = smem;
  float* const si = smem + four_step_plane(LM);
  auto at = [](int l, int p) { return four_step_line(LM, l) + p + (p >> SH); };

  const int t = threadIdx.x;
  const int h = blockIdx.x & (K - 1);
  const long long tile = (long long)blockIdx.x >> LK;
  const int lg_tiles = lg_o - LC;             // tiles of a row, log2
  const long long r = tile >> lg_tiles;
  const int c0 = static_cast<int>(tile & ((1LL << lg_tiles) - 1)) << LC;
  const long long base = r << (LGL + lg_o);

  // in: block h loads, for the points n = h NB .. (h + 1) NB - 1 it owns,
  // the line points n + j M (j < K) of VU consecutive lines a unit, runs
  // the radix-K step on them in registers and stores y_j[n] = W_L^(n j)
  // sum_m x[n + m M] W_K^(m j) into block j's shared memory: every point
  // crosses the cluster once, a warp's stores on consecutive words (pass
  // 2) or on 32 banks of 4 or 8 lines (pass 1). Pass 1 reads VU of C
  // consecutive columns at a point (runs of C elements), pass 2 one float
  // a line at 32 consecutive points (128-byte runs).
  // the block's units, VU lines c .. c + VU - 1 at a point n: pass 1
  // loads VU of C consecutive columns at a point (lanes along the lines,
  // runs of C elements); the radix-K step and its stores into the
  // cluster take 32 consecutive points of a line across a warp (pass 2
  // also loads so), so that a warp's stores into another block are 128
  // contiguous bytes
  auto along_lines = [&](int u, int& c, int& n) {
    const int q = t + THREADS * u;
    constexpr int LV = ilog2(C / VU);
    c = (q & ((1 << LV) - 1)) * VU;
    n = h * NB + (q >> LV);
  };
  auto along_points = [&](int u, int& c, int& n) {
    const int q = t + THREADS * u;
    c = (q >> ilog2(NB)) * VU;
    n = h * NB + (q & (NB - 1));
  };
  // pass 1 with a cluster may go from one to the other through the
  // block's own shared memory (its share x[n + m M] of line c at position
  // m NB + n - h NB; the barrier then waits for it before any block writes
  // there): `staged`, which the host sets for clusters of 8 and for
  // grids of at most a few waves (contiguous stores into the cluster
  // against one more round trip through shared memory)
  const bool stage = !SECOND && K > 1 && staged;
  // the exchange's units: along the points, but unstaged pass 1's
  auto exchange_unit = [&](int u, int& c, int& n) {
    if (SECOND || stage) {
      along_points(u, c, n);
    } else {
      along_lines(u, c, n);
    }
  };
  // every load of the block in flight before the cluster's barrier (its
  // arrive relaxed: it orders nothing, it only waits for the cluster's
  // blocks to run before any writes into their shared memory)
  if (K > 1 && !stage) cluster_arrive_relaxed();
  wait_for_prerequisites();
  float2 x[UNITS][VU][K];
  static_for<UNITS>([&](auto u) {
    int c, n;
    if constexpr (SECOND) {
      along_points(CV(u), c, n);
    } else {
      along_lines(CV(u), c, n);
    }
    static_for<K>([&](auto m) {
      const int p = n + CV(m) * M;
      if constexpr (!SECOND) {
        float vr[VU], vi[VU];
        const long long g = base + ((long long)p << lg_o) + c0 + c;
        load_vec<TI, VU>(a + g, vr);
        load_vec<TI, VU>(b + g, vi);
        static_for<VU>([&](auto e) {
          x[CV(u)][CV(e)][CV(m)] = make_float2(vr[CV(e)], vi[CV(e)]);
        });
      } else {
        static_for<VU>([&](auto e) {
          // the scratch's (16-point, 16-line) tiles: (k1, n2) at
          // ((n2 >> 4) N1 + k1) 16 + (n2 & 15)
          const long long g =
              base + ((((long long)(p >> LC) << lg_o) + c0 + c + CV(e))
                      << LC) + (p & (C - 1));
          x[CV(u)][CV(e)][CV(m)] =
              make_float2(__ldcs(a + g), __ldcs(b + g));
        });
      }
    });
  });
  // the radix-K step's twiddles W_L^(n j), read while the loads fly
  float2 wn[UNITS][K];
  static_for<UNITS>([&](auto u) {
    constexpr int uu = CV(u);
    int c, n;
    exchange_unit(uu, c, n);
    wn[uu][0] = make_float2(1.f, 0.f);
    static_for<K - 1>([&](auto j) {
      wn[uu][CV(j) + 1] = __ldg(split + n * (CV(j) + 1));
    });
  });
  if (stage) {
    static_for<UNITS>([&](auto u) {
      int c, n;
      along_lines(CV(u), c, n);
      static_for<VU>([&](auto e) {
        static_for<K>([&](auto m) {
          const int o = at(c + CV(e), CV(m) * NB + n - h * NB);
          sr[o] = x[CV(u)][CV(e)][CV(m)].x;
          si[o] = x[CV(u)][CV(e)][CV(m)].y;
        });
      });
    });
    __syncthreads();
    static_for<UNITS>([&](auto u) {
      int c, n;
      along_points(CV(u), c, n);
      static_for<VU>([&](auto e) {
        static_for<K>([&](auto m) {
          const int o = at(c + CV(e), CV(m) * NB + n - h * NB);
          x[CV(u)][CV(e)][CV(m)] = make_float2(sr[o], si[o]);
        });
      });
    });
    cg::this_cluster().sync();   // every block's staged share read
  } else if (K > 1) {
    cluster_wait();
  }
  static_for<UNITS>([&](auto u) {
    constexpr int uu = CV(u);
    int c, n;
    exchange_unit(uu, c, n);
    static_for<VU>([&](auto e) {
      constexpr int ee = CV(e);
      const int ce = c + ee;
      const int ne = n;
      dft<K>(x[uu][ee]);
      static_for<K>([&](auto j) {
        constexpr int jj = CV(j);
        float2 y = x[uu][ee][jj];
        if constexpr (jj > 0) y = cmul(y, wn[uu][jj]);
        // y_j's point n lives at position n of block j's sub-line
        float* yr = sr + at(ce, ne);
        float* yi = si + at(ce, ne);
        if constexpr (K > 1) {
          yr = cg::this_cluster().map_shared_rank(yr, jj);
          yi = cg::this_cluster().map_shared_rank(yi, jj);
        }
        *yr = y.x;
        *yi = y.y;
      });
    });
  });
  if constexpr (K > 1) {
    cg::this_cluster().sync();                // every share delivered
  } else {
    __syncthreads();
  }

  // the M-point transforms, GROUP lines a sweep
  const int lrow = t >> LT;
  auto sync = [&]() {
    if constexpr (TPR > 32) {
      __syncthreads();
    } else {
      constexpr unsigned kRow = TPR == 32 ? 0xffffffffu : (1u << TPR) - 1;
      __syncwarp(kRow << ((t & 31) & ~(TPR - 1)));
    }
  };
  static_for<C / GROUP>([&](auto sweep) {
    const int o = four_step_line(LM, CV(sweep) * GROUP + lrow);
    stockham_passes_padded<LM, SH>(sr + o, si + o, tw, t & (TPR - 1), sync);
  });
  __syncthreads();

  // the next kernel's blocks may be scheduled from here: they wait for
  // this one's stores before touching memory (earlier, they took slots
  // this pass's blocks still needed: one 2^20 row 0.0316 ms against 0.0252)
  launch_dependents();
  // out: point k' of every line is X[K k' + h] of the line; a point of
  // C consecutive lines at a time, VE a 16-byte vector
  constexpr int VE = 16 / int(sizeof(TO));
  constexpr int LV = ilog2(C / VE);
  constexpr int NV = C * M / VE / THREADS;
  static_for<NV>([&](auto v) {
    const int q = t + THREADS * CV(v);
    const int kp = q >> LV;
    const int c = (q & ((1 << LV) - 1)) * VE;
    const int k = (kp << LK) + h;             // k1 (pass 1) or k2 (pass 2)
    float vr[VE], vi[VE];
    if constexpr (!SECOND) {
      // times W_N^(n2 k1): for the vector's first column coarse[e >> lg
      // N1] fine[e mod N1] (e = n2 k1), for the next ones times W_N^k1 =
      // fine[k1] each: two scattered table reads a vector, not two a
      // point (read here, not before the transforms: held through them,
      // they cost registers and 13% at 64 rows of 2^20)
      const int ex = (c0 + c) * k;
      float2 w = cmul(__ldg(coarse + (ex >> LGL)),
                      __ldg(fine + (ex & ((1 << LGL) - 1))));
      const float2 step = __ldg(fine + k);
      static_for<VE>([&](auto e) {
        constexpr int ee = CV(e);
        if constexpr (ee > 0) w = cmul(w, step);
        const float2 z = cmul(
            make_float2(sr[at(c + CV(e), kp)], si[at(c + CV(e), kp)]), w);
        vr[CV(e)] = z.x;
        vi[CV(e)] = z.y;
      });
    } else {
      static_for<VE>([&](auto e) {
        vr[CV(e)] = sr[at(c + CV(e), kp)] * scale;
        vi[CV(e)] = si[at(c + CV(e), kp)] * scale;
      });
    }
    const long long g =
        SECOND ? base + c0 + c + ((long long)k << lg_o)
               : base + ((((long long)(c0 >> LC) << LGL) + k) << LC) + c;
    store_vec<TO, VE>(oa + g, vr);
    store_vec<TO, VE>(ob + g, vi);
  });
}

template <int LGL, typename TI, typename TO, bool SECOND>
cudaError_t launch_four_step(const void* a, const void* b, const float2* tw,
                             const float2* split, const float2* fine,
                             const float2* coarse, void* oa, void* ob,
                             long long R, int lg_o, float scale,
                             cudaStream_t stream) {
  constexpr int LM = log_sub(LGL);
  constexpr size_t smem = four_step_smem_bytes(LM);
  auto kernel = four_step_kernel<LGL, TI, TO, SECOND>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // R rows of 2^(LGL + lg_o) points, kFourStepLines sub-lines of 2^LM a
  // block, clusters of 2^log_cluster(LGL) blocks
  const long long blocks =
      R << (LGL - LM + lg_o - ilog2(kFourStepLines));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(four_step_threads(LM));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_cluster(LGL);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  // pass 1 stages its cluster's exchange through shared memory with
  // clusters of 8 and where the grid is at most four blocks an SM
  // (tools/fft_variants.py: staged 0.0235 ms against 0.0252 at one 2^20
  // row, 0.933 against 0.900 at 64 rows)
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int staged = log_cluster(LGL) == ilog2(kMaxCluster) ||
                     blocks <= 4LL * sms;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TI*>(a),
                           static_cast<const TI*>(b), tw, split, fine,
                           coarse, static_cast<TO*>(oa),
                           static_cast<TO*>(ob), lg_o, scale, staged);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// one instantiation per line log (7 to 13), pass and type
template <typename T, bool SECOND, int LGL = kMaxFourStepLog / 2>
cudaError_t dispatch_four_step(int lg_l, const void* a, const void* b,
                               const float2* tw, const float2* split,
                               const float2* fine, const float2* coarse,
                               void* oa, void* ob, long long R, int lg_o,
                               float scale, cudaStream_t stream) {
  if constexpr (LGL < (kMaxLog + 2) / 2) {
    return cudaErrorInvalidValue;
  } else {
    using TI = typename std::conditional<SECOND, float, T>::type;
    using TO = typename std::conditional<SECOND, T, float>::type;
    if (lg_l == LGL)
      return launch_four_step<LGL, TI, TO, SECOND>(
          a, b, tw, split, fine, coarse, oa, ob, R, lg_o, scale, stream);
    return dispatch_four_step<T, SECOND, LGL - 1>(
        lg_l, a, b, tw, split, fine, coarse, oa, ob, R, lg_o, scale,
        stream);
  }
}

// Offsets into the four-step table of N = 2^lg (float2 entries): the
// sub-line transforms' tables of both passes, W_N1^j (j < N1), W_N2^j
// (j < N2), then W_N^j (j < N1) and W_N^(j N1) (j < N2), as kernel.py's
// four_step_table lays it out.
struct FourStepTable {
  int tw2, split1, split2, fine, coarse, size;
};
__host__ __device__ inline FourStepTable four_step_table(int lg) {
  const int n1 = 1 << log_n1(lg), n2 = 1 << log_n2(lg);
  const int lm1 = log_sub(log_n1(lg)), lm2 = log_sub(log_n2(lg));
  FourStepTable t;
  t.tw2 = twiddle_offset(lm1, n_passes(lm1));
  t.split1 = t.tw2 + twiddle_offset(lm2, n_passes(lm2));
  t.split2 = t.split1 + n1;
  t.fine = t.split2 + n2;
  t.coarse = t.fine + n1;
  t.size = t.coarse + n2;
  return t;
}

template <typename T>
cudaError_t four_step_pass(int lg, int pass, const void* a, const void* b,
                           const float2* tables, void* sa, void* sb,
                           void* oa, void* ob, long long R, float scale,
                           cudaStream_t stream) {
  const int lg1 = log_n1(lg), lg2 = log_n2(lg);
  const FourStepTable o = four_step_table(lg);
  const float2* w = tables;
  return pass == 0
             ? dispatch_four_step<T, false>(lg1, a, b, w, w + o.split1,
                                            w + o.fine, w + o.coarse, sa, sb,
                                            R, lg2, 1.0f, stream)
             : dispatch_four_step<T, true>(lg2, sa, sb, w + o.tw2,
                                           w + o.split2, w + o.fine,
                                           w + o.coarse, oa, ob, R, lg1,
                                           scale, stream);
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
  return four_step_smem_bytes(log_sub(pass == 0 ? log_n1(lg) : log_n2(lg)));
}

// Blocks of a cluster (K) and threads of a block of that pass for N.
int fft_four_step_cluster(int n, int pass) {
  const int lg = log2_of(n);
  return 1 << log_cluster(pass == 0 ? log_n1(lg) : log_n2(lg));
}
int fft_four_step_threads(int n, int pass) {
  const int lg = log2_of(n);
  return four_step_threads(log_sub(pass == 0 ? log_n1(lg) : log_n2(lg)));
}

// Complex entries of the four-step table for N points (kernel.py's
// four_step_table: the sub-line transforms' tables of both passes, the
// radix-K steps' W_N1^j and W_N2^j, then W_N^j for j < N1 and W_N^(j N1)
// for j < N2).
int fft_four_step_table_size(int n) {
  return four_step_table(log2_of(n)).size;
}

// Pass `pass` of the four-step FFT over the rows of (R, N) row-major planes
// of `dtype`, 8192 < N <= 2^26: pass 0 reads (re, im) and writes the
// float32 (R, N) planes (scratch_re, scratch_im), each row in 16 x 16
// tiles; pass 1 reads those and writes (out_re, out_im) in `dtype`; each
// pass is a cluster launch that lets the next kernel launch early and
// waits for the last one's writes. `tables` is kernel.py's
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
