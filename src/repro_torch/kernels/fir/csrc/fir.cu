// Causal k-tap FIR along the rows of an (R, S) array of float32, bfloat16,
// float16, int8, uint8, int16 or int32 as one CUDA kernel for Hopper
// (sm_90a), bound to PyTorch through a plain C interface
// (kernels/fir/kernel.py):
//
//     y[r, t] = sum_i taps[i] * x[r, t - i],   x[r, t < 0] = 0,
//
// each sample widened to float32 at its load, accumulated in float32 and
// stored in the input's type: rounded to nearest even for a 16-bit float,
// truncated toward zero and saturated at the type's range (NaN to 0) for
// an integer, as the reference's astype stores it (`saturate`,
// kernels/csrc/saturate.cuh, which both graph kernels share).
//
// Replaces fir_pallas of src/repro/kernels/fir/kernel.py:34 (body
// fir_kernel :21, pallas_call :56). The TPU kernel walks (row-block,
// seq-block) tiles in order and hands each seq block a (k-1)-word halo, the
// last words of the previous block, so the filter runs over the whole row
// with zero history only before sample 0. It takes any k up to its tile
// and any dtype.
//
// What bounds it on this card. Each sample is read once and written once
// for 2k float operations: at k = 2 or 11 and 1-8 bytes per sample that is
// under the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 operations
// per byte), so it is byte-bound; from k ~ 40 (float32) or ~ 10 (int8) the
// multiply-adds bound it.
//
// What the design does about it. Blocks run in parallel with nothing
// carried between them, so a block that filters one tile of a row reads
// the k-1 samples before its tile from device memory itself (zeros before
// sample 0) into shared memory beside the tile: one coalesced read of the
// tile plus a k-1 halo, one coalesced write. A block covers block_rows rows
// of one tile, to keep blocks long enough on short rows. The taps run in
// the plain PyTorch version's order with round-to-nearest intrinsics (no
// FMA contraction), so a result matches it bitwise. Up to kTapChunk taps
// sit in shared memory for the whole block; more taps are staged a chunk
// at a time, each thread carrying its outputs' partial sums in shared
// memory from one chunk to the next (the same additions in the same
// order), so the taps take one chunk of shared memory whatever k is. The
// two are separate instantiations (CHUNKED), so up to kTapChunk taps the
// kernel is the one-chunk loop alone.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/saturate.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTapChunk = 64;

// element types (kernel.py keeps the same codes)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;
constexpr int kInt8 = 3;
constexpr int kUInt8 = 4;
constexpr int kInt16 = 5;
constexpr int kInt32 = 6;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T>
__device__ __forceinline__ float to_f(T v) {   // integers: round to nearest
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(v);
  } else {
    return saturate<T>(v);
  }
}

// CHUNKED: more than kTapChunk taps, staged a chunk at a time
template <typename T, bool CHUNKED>
__global__ void __launch_bounds__(kThreads)
fir_kernel(const T* __restrict__ x, const float* __restrict__ taps,
           T* __restrict__ y, int R, int S, int k, int tile, int block_rows) {
  // k - 1 halo, then the tile; CHUNKED also the tile's partial sums
  extern __shared__ __align__(16) float s[];
  __shared__ float taps_s[kTapChunk];
  float* const partial = s + tile + k - 1;
  const int tid = threadIdx.x;
  if constexpr (!CHUNKED)
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
    if constexpr (!CHUNKED) {
      for (int i = tid; i < len; i += kThreads) {
        float acc = 0.f;
        for (int j = 0; j < k; ++j)
          acc = __fadd_rn(acc, __fmul_rn(taps_s[j], s[i + k - 1 - j]));
        y[r * S + t0 + i] = from_f<T>(acc);
      }
      continue;
    }
    // taps c0 .. c0 + kc - 1 a chunk; thread tid keeps the partial sums of
    // its own outputs i = tid + m kThreads, so only the taps need a barrier
    for (int c0 = 0; c0 < k; c0 += kTapChunk) {
      const int kc = min(kTapChunk, k - c0);
      __syncthreads();                          // the last chunk's taps read
      for (int j = tid; j < kc; j += kThreads) taps_s[j] = taps[c0 + j];
      __syncthreads();
      const bool last = c0 + kc == k;
      for (int i = tid; i < len; i += kThreads) {
        float acc = c0 == 0 ? 0.f : partial[i];
        const float* const xs = s + i + k - 1 - c0;
        for (int j = 0; j < kc; ++j)
          acc = __fadd_rn(acc, __fmul_rn(taps_s[j], xs[-j]));
        if (last)
          y[r * S + t0 + i] = from_f<T>(acc);
        else
          partial[i] = acc;
      }
    }
  }
}

size_t smem_bytes(int tile, int k) {
  return sizeof(float) *
         (size_t(tile) + k - 1 + (k > kTapChunk ? size_t(tile) : 0));
}

template <typename T, bool CHUNKED>
cudaError_t launch_k(const void* x, const float* taps, void* y, int R,
                     int S, int k, int tile, int block_rows,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes(tile, k);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fir_kernel<T, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((R + block_rows - 1) / block_rows, (S + tile - 1) / tile);
  fir_kernel<T, CHUNKED><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), taps, static_cast<T*>(y), R, S, k, tile,
      block_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* taps, void* y, int R, int S,
                   int k, int tile, int block_rows, cudaStream_t stream) {
  return k > kTapChunk
             ? launch_k<T, true>(x, taps, y, R, S, k, tile, block_rows,
                                 stream)
             : launch_k<T, false>(x, taps, y, R, S, k, tile, block_rows,
                                  stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for a tile of `tile` samples and
// `n_taps` taps (the static chunk of taps not counted).
size_t fir_smem_bytes(int tile, int n_taps) {
  return smem_bytes(tile, n_taps);
}

const char* fir_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y = FIR(x) for an (R, S) row-major x of `dtype` (kFloat32, kBFloat16,
// kFloat16, kInt8, kUInt8, kInt16 or kInt32) on `stream`, on the calling
// thread's current device; returns cudaGetLastError() after the launch (0
// on success). Allocates nothing and does not synchronise.
int fir_launch(const void* x, const float* taps, void* y, int R, int S,
               int n_taps, int tile, int block_rows, int dtype,
               void* stream) {
  if (R < 1 || S < 1 || n_taps < 1 || tile < 1 || block_rows < 1 ||
      (S + tile - 1) / tile > 65535 || dtype < kFloat32 || dtype > kInt32)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kFloat32:
      err = launch<float>(x, taps, y, R, S, n_taps, tile, block_rows, st);
      break;
    case kBFloat16:
      err = launch<__nv_bfloat16>(x, taps, y, R, S, n_taps, tile,
                                  block_rows, st);
      break;
    case kFloat16:
      err = launch<__half>(x, taps, y, R, S, n_taps, tile, block_rows, st);
      break;
    case kInt8:
      err = launch<int8_t>(x, taps, y, R, S, n_taps, tile, block_rows, st);
      break;
    case kUInt8:
      err = launch<uint8_t>(x, taps, y, R, S, n_taps, tile, block_rows, st);
      break;
    case kInt16:
      err = launch<int16_t>(x, taps, y, R, S, n_taps, tile, block_rows, st);
      break;
    default:
      err = launch<int32_t>(x, taps, y, R, S, n_taps, tile, block_rows, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
