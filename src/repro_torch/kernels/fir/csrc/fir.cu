// Causal k-tap FIR along the rows of an (R, S) float32 or bfloat16 array
// as one CUDA kernel for Hopper (sm_90a), bound to PyTorch through a plain C
// interface (kernels/fir/kernel.py):
//
//     y[r, t] = sum_i taps[i] * x[r, t - i],   x[r, t < 0] = 0,
//
// accumulated in float32 and written in the input's type.
//
// Replaces fir_pallas of src/repro/kernels/fir/kernel.py:34 (body
// fir_kernel :21, pallas_call :56). The TPU kernel walks (row-block,
// seq-block) tiles in order and hands each seq block a (k-1)-word halo, the
// last words of the previous block, so the filter runs over the whole row
// with zero history only before sample 0.
//
// What bounds it on this card. Each sample is read once and written once
// for 2k float operations: at k = 2 or 11 and 4-8 bytes per sample that is
// well under the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20
// operations per byte), so it is byte-bound.
//
// What the design does about it. Blocks run in parallel with nothing
// carried between them, so a block that filters one tile of a row reads
// the k-1 samples before its tile from device memory itself (zeros before
// sample 0) into shared memory beside the tile: one coalesced read of the
// tile plus a k-1 halo, one coalesced write. A block covers block_rows rows
// of one tile, to keep blocks long enough on short rows. The taps run in
// the plain PyTorch version's order with round-to-nearest intrinsics (no
// FMA contraction), so a float32 result matches it bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
fir_kernel(const T* __restrict__ x, const float* __restrict__ taps,
           T* __restrict__ y, int R, int S, int k, int tile, int block_rows) {
  extern __shared__ __align__(16) float s[];     // k - 1 halo, then tile
  __shared__ float taps_s[kMaxTaps];
  const int tid = threadIdx.x;
  for (int i = tid; i < k; i += kThreads) taps_s[i] = taps[i];
  const long long t0 = (long long)blockIdx.y * tile;
  const int len = (int)min((long long)tile, (long long)S - t0);
  for (int rr = 0; rr < block_rows; ++rr) {
    const long long r = (long long)blockIdx.x * block_rows + rr;
    if (r >= R) break;                          // uniform across the block
    const T* xr = x + r * S;
    __syncthreads();                            // the last row's reads done
    for (int i = tid; i < len + k - 1; i += kThreads) {
      const long long src = t0 - (k - 1) + i;
      s[i] = src >= 0 ? to_f(xr[src]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < len; i += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < k; ++j)
        acc = __fadd_rn(acc, __fmul_rn(taps_s[j], s[i + k - 1 - j]));
      y[r * S + t0 + i] = from_f<T>(acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* taps, void* y, int R, int S,
                   int k, int tile, int block_rows, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t(tile) + k - 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fir_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((R + block_rows - 1) / block_rows, (S + tile - 1) / tile);
  fir_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), taps, static_cast<T*>(y), R, S, k, tile,
      block_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for a tile of `tile` samples.
size_t fir_smem_bytes(int tile, int n_taps) {
  return sizeof(float) * (size_t(tile) + n_taps - 1);
}

const char* fir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y = FIR(x) for an (R, S) row-major x of `dtype` (0: float32, 1: bfloat16)
// on `stream`, on the calling thread's current device; returns
// cudaGetLastError() after the launch (0 on success). Allocates nothing and
// does not synchronise.
int fir_launch(const void* x, const float* taps, void* y, int R, int S,
               int n_taps, int tile, int block_rows, int dtype,
               void* stream) {
  if (R < 1 || S < 1 || n_taps < 1 || n_taps > kMaxTaps || tile < 1 ||
      block_rows < 1 || (S + tile - 1) / tile > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(x, taps, y, R, S, n_taps, tile, block_rows, st)
                 : launch<__nv_bfloat16>(x, taps, y, R, S, n_taps, tile,
                                         block_rows, st);
  return static_cast<int>(err);
}

}  // extern "C"
