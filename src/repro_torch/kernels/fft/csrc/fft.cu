// Batched complex radix-2 FFT of (R, N) float32 or bfloat16 re/im planes
// as one CUDA kernel for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (kernels/fft/kernel.py). Self-sorting Stockham stages from the
// packed (log2 N, N/2) twiddle table, computed in float32; the inverse
// transform takes the inverse table and divides by N at the end.
//
// Replaces fft_pallas of src/repro/kernels/fft/kernel.py:74 (body
// fft_kernel :45, pallas_call :86), which stages a block of rows in VMEM
// and runs all log2 N stages on it in one residency.
//
// What bounds it on this card. Each point is read and written once (16
// bytes in float32) for ~5 log2 N float operations: ~2.5 operations per
// byte at N = 256, far under the fp32 ridge (67 TFLOP/s over 3.35 TB/s), so
// it is byte-bound. The stages depend on each other, one barrier apart.
//
// What the design does about it. A block of 256 threads takes max(1, 2048
// / N) rows (or the caller's block_rows) into shared memory in one
// coalesced read, runs every stage there between two ping-pong planes, with
// ~1024 butterflies per barrier whatever N, and writes each point once:
// one pass over device memory, as the TPU kernel's one VMEM residency.
// Butterflies use round-to-nearest intrinsics in the plain PyTorch
// version's order, so a float32 result matches it bitwise. Four float32
// planes of N per row bound N at 8192 (128 KB with the opt-in above 48 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

__host__ __device__ inline size_t smem_bytes(int n, int rows_per_block) {
  return sizeof(float) * 4 * size_t(n) * rows_per_block;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fft_kernel(const T* __restrict__ re, const T* __restrict__ im,
           const float* __restrict__ tw_re, const float* __restrict__ tw_im,
           T* __restrict__ out_re, T* __restrict__ out_im, int R, int N,
           int rows_per_block, int inverse) {
  extern __shared__ __align__(16) float s[];
  const int tid = threadIdx.x;
  const int rpb = rows_per_block;
  const long long r0 = (long long)blockIdx.x * rpb;
  const int nr = (int)min((long long)rpb, (long long)R - r0);
  const long long base = r0 * N;
  float* cr = s;
  float* ci = s + rpb * N;
  float* xr = s + 2 * rpb * N;
  float* xi = s + 3 * rpb * N;
  for (int i = tid; i < nr * N; i += kThreads) {
    cr[i] = to_f(re[base + i]);
    ci[i] = to_f(im[base + i]);
  }
  __syncthreads();
  const int h = N / 2;
  int stage = 0;
  for (int n = N, g = 1; n > 1; n >>= 1, g <<= 1, ++stage) {
    const int half = n >> 1;
    const float* wr = tw_re + (long long)stage * h;
    const float* wi = tw_im + (long long)stage * h;
    for (int b = tid; b < nr * h; b += kThreads) {
      const int row = b / h, bf = b - row * h;
      const int q = bf / half, j = bf - q * half;
      const float* ar_ = cr + row * N;
      const float* ai_ = ci + row * N;
      const float ar = ar_[q * n + j], ai = ai_[q * n + j];
      const float br = ar_[q * n + j + half], bi = ai_[q * n + j + half];
      const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
      const float w_r = wr[j], w_i = wi[j];
      xr[row * N + q * half + j] = __fadd_rn(ar, br);
      xi[row * N + q * half + j] = __fadd_rn(ai, bi);
      xr[row * N + (g + q) * half + j] =
          __fsub_rn(__fmul_rn(dr, w_r), __fmul_rn(di, w_i));
      xi[row * N + (g + q) * half + j] =
          __fadd_rn(__fmul_rn(dr, w_i), __fmul_rn(di, w_r));
    }
    __syncthreads();
    float* t0 = cr; cr = xr; xr = t0;
    float* t1 = ci; ci = xi; xi = t1;
  }
  const float fn = (float)N;
  for (int i = tid; i < nr * N; i += kThreads) {
    float a = cr[i], b = ci[i];
    if (inverse) {
      a = __fdiv_rn(a, fn);
      b = __fdiv_rn(b, fn);
    }
    out_re[base + i] = from_f<T>(a);
    out_im[base + i] = from_f<T>(b);
  }
}

template <typename T>
cudaError_t launch(const void* re, const void* im, const float* tw_re,
                   const float* tw_im, void* out_re, void* out_im, int R,
                   int N, int rpb, int inverse, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, rpb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fft_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((R + rpb - 1) / rpb);
  fft_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(re), static_cast<const T*>(im), tw_re, tw_im,
      static_cast<T*>(out_re), static_cast<T*>(out_im), R, N, rpb, inverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for rows_per_block rows of N points.
size_t fft_smem_bytes(int n, int rows_per_block) {
  return smem_bytes(n, rows_per_block);
}

const char* fft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// (out_re, out_im) = FFT(re + i im) over the rows of (R, N) row-major planes
// of `dtype` (0: float32, 1: bfloat16) with the (log2 N, N/2) twiddle table
// (tw_re, tw_im); `inverse` != 0 divides by N at the end. Runs on `stream`,
// on the calling thread's current device; returns cudaGetLastError() after
// the launch (0 on success). Allocates nothing and does not synchronise.
int fft_launch(const void* re, const void* im, const float* tw_re,
               const float* tw_im, void* out_re, void* out_im, int R, int N,
               int rows_per_block, int inverse, int dtype, void* stream) {
  if (R < 1 || N < 2 || (N & (N - 1)) != 0 || rows_per_block < 1 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(re, im, tw_re, tw_im, out_re, out_im, R, N,
                                 rows_per_block, inverse, st)
                 : launch<__nv_bfloat16>(re, im, tw_re, tw_im, out_re, out_im,
                                         R, N, rows_per_block, inverse, st);
  return static_cast<int>(err);
}

}  // extern "C"
