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
// multiply-adds bound it. The taps run in the plain PyTorch version's
// order with round-to-nearest intrinsics (no FMA contraction), so a result
// matches it bitwise: a multiply-add is two FP32 instructions, and the
// ceiling past ~40 taps is twice the operations bound.
//
// What the design does about it. Blocks run in parallel with nothing
// carried between them, so a block that filters one tile of a row reads
// the k-1 samples before its tile from device memory itself (zeros before
// sample 0) into shared memory beside the tile: one coalesced read of the
// tile plus a k-1 halo, one coalesced write. A block covers block_rows
// rows of one tile, to keep blocks long enough on short rows.
// - Up to kTapChunk taps (fir_kernel): every thread computes its outputs
//   one at a time, the taps in static shared memory.
// - Past kTapChunk taps (fir_register_kernel), where the multiply-adds
//   bound it: each thread owns kOutputs consecutive outputs and keeps
//   their sums in registers for the whole tap loop. A step of kStep taps
//   reads a window of kStep + kOutputs - 1 samples into registers, each
//   once, and the step's taps as four 16-byte broadcasts, for kStep x
//   kOutputs multiply-adds: under 0.1 shared loads a multiply-add, where
//   the one-output loop takes two. The tile sits in shared memory
//   interleaved by kOutputs (sample s at row s % kOutputs, column s /
//   kOutputs), so a warp's window loads fall on consecutive words. The
//   taps take as much dynamic shared memory as is left (all of them up
//   to 27,872 at a 2048-sample tile), staged a chunk at a time past that,
//   the sums staying in registers. The outputs go back through shared
//   memory to one coalesced store.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/saturate.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTapChunk = 64;
constexpr int kLogOutputs = 4;
constexpr int kOutputs = 1 << kLogOutputs;  // outputs a thread owns past 64
constexpr int kStep = kOutputs;             // taps a step of that loop
constexpr int kMaxSmemBytes = 232448;       // a block's, opt-in dynamic

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

// Up to kTapChunk taps: one output at a time, the taps in static shared
// memory (the tile and its k - 1 halo in dynamic shared memory).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fir_kernel(const T* __restrict__ x, const float* __restrict__ taps,
           T* __restrict__ y, int R, int S, int k, int tile, int block_rows) {
  extern __shared__ __align__(16) float s[];   // k - 1 halo, then the tile
  __shared__ float taps_s[kTapChunk];
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

// ---- past kTapChunk taps: kOutputs outputs a thread, sums in registers
//
// Shared layout: the tile's samples from k - 1 before it, sample s (0 the
// first of the halo) at "sigma" = s + lead(k), stored at row sigma %
// kOutputs, column sigma / kOutputs of a (kOutputs, pitch) array; then the
// taps, 16-byte aligned. lead(k) >= kStep - 1 makes (k + lead) a multiple
// of kOutputs, so that every step's window starts on a row boundary and
// its loads are a column offset plus constants. Thread g owns outputs i =
// g kOutputs + v (v < kOutputs); at taps j0 .. j0 + kStep - 1 (j0 a
// multiple of kStep) output v at tap j0 + u reads window entry m = v - u +
// kStep - 1 of the window that starts at column g + a - j0 / kOutputs, a
// = (k + lead) / kOutputs - 1.
__host__ __device__ inline int fir_lead(int k) {
  return kStep + (kOutputs - k % kOutputs) % kOutputs;
}
// the most samples a register-path tile takes: one output group a thread
__host__ __device__ constexpr int fir_register_tile() {
  return kThreads * kOutputs;
}
// columns of the interleaved tile for `tile` outputs and k taps, raised to
// 2 mod 32 so that a warp's 32 consecutive samples, 16 rows by 2 columns,
// fall on 32 banks when they are staged
__host__ __device__ inline int fir_pitch(int tile, int k) {
  const int p = (tile + kOutputs - 1) / kOutputs + (k + fir_lead(k)) / kOutputs;
  return p + ((2 - p) % 32 + 32) % 32;
}
__host__ __device__ inline size_t fir_window_bytes(int tile, int k) {
  return sizeof(float) * size_t(kOutputs) * fir_pitch(tile, k);
}
// taps the register path keeps in shared memory at once: all of them
// (rounded up to a whole step) where they fit beside the tile, else as
// many whole steps as do; 0 where not one step fits
__host__ __device__ inline int fir_tap_capacity(int tile, int k) {
  const long long room =
      ((long long)kMaxSmemBytes - (long long)fir_window_bytes(tile, k)) /
      (long long)sizeof(float) / kStep * kStep;
  const long long want = (k + kStep - 1) / kStep * kStep;
  return room < kStep ? 0 : (int)(want < room ? want : room);
}

// The sums of one thread's outputs over taps c0 .. c0 + kt - 1 (the
// staged chunk taps_s), added onto acc; `col` is the window's column at
// tap c0, `p` the pitch.
__device__ __forceinline__ void register_taps(float (&acc)[kOutputs],
                                              const float* __restrict__ s,
                                              int col, int p,
                                              const float* __restrict__ taps_s,
                                              int kt) {
  int jj = 0;
  for (; jj + kStep <= kt; jj += kStep) {
    const float* xs = s + col - jj / kOutputs;
    float w[kStep + kOutputs - 1];
#pragma unroll
    for (int m = 0; m < kStep + kOutputs - 1; ++m)
      w[m] = xs[(m % kOutputs) * p + m / kOutputs];
    float t[kStep];
#pragma unroll
    for (int u = 0; u < kStep; u += 4) {
      const float4 q = *reinterpret_cast<const float4*>(taps_s + jj + u);
      t[u] = q.x;
      t[u + 1] = q.y;
      t[u + 2] = q.z;
      t[u + 3] = q.w;
    }
#pragma unroll
    for (int u = 0; u < kStep; ++u)
#pragma unroll
      for (int v = 0; v < kOutputs; ++v)
        acc[v] = __fadd_rn(acc[v], __fmul_rn(t[u], w[v - u + kStep - 1]));
  }
  if (jj < kt) {                  // the last taps of the chunk, guarded
    const int rem = kt - jj;
    const float* xs = s + col - jj / kOutputs;
    float w[kStep + kOutputs - 1];
#pragma unroll
    for (int m = 0; m < kStep + kOutputs - 1; ++m)
      w[m] = xs[(m % kOutputs) * p + m / kOutputs];
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      if (u < rem) {
        const float tu = taps_s[jj + u];
#pragma unroll
        for (int v = 0; v < kOutputs; ++v)
          acc[v] = __fadd_rn(acc[v], __fmul_rn(tu, w[v - u + kStep - 1]));
      }
    }
  }
}

// Past kTapChunk taps: a block of ceil(tile / kOutputs) threads (rounded
// to a warp) covers block_rows rows of one tile of at most
// fir_register_tile() samples, thread g outputs g kOutputs .. + kOutputs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fir_register_kernel(const T* __restrict__ x, const float* __restrict__ taps,
                    T* __restrict__ y, int R, int S, int k, int tile,
                    int block_rows, int pitch, int tap_capacity) {
  extern __shared__ __align__(16) float s[];
  float* const taps_s = s + kOutputs * pitch;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lead = fir_lead(k);
  const int a = (k + lead) / kOutputs - 1;
  const long long t0 = (long long)blockIdx.y * tile;
  const int len = (int)min((long long)tile, (long long)S - t0);
  const int groups = (len + kOutputs - 1) / kOutputs;   // <= nt
  const bool all_taps = k <= tap_capacity;
  if (all_taps)
    for (int j = tid; j < k; j += nt) taps_s[j] = taps[j];
  for (int rr = 0; rr < block_rows; ++rr) {
    const long long r = (long long)blockIdx.x * block_rows + rr;
    if (r >= R) break;                          // uniform across the block
    const T* xr = x + r * S;
    __syncthreads();                  // the last row's outputs stored
    for (int i = tid; i < len + k - 1; i += nt) {
      const long long src = t0 - (k - 1) + i;
      const int sigma = i + lead;
      s[(sigma & (kOutputs - 1)) * pitch + (sigma >> kLogOutputs)] =
          src >= 0 ? to_f(xr[src]) : 0.f;
    }
    __syncthreads();
    float acc[kOutputs];
#pragma unroll
    for (int v = 0; v < kOutputs; ++v) acc[v] = 0.f;
    for (int c0 = 0; c0 < k; c0 += tap_capacity) {
      const int kt = min(tap_capacity, k - c0);
      if (!all_taps) {
        __syncthreads();              // the last chunk's taps read
        for (int j = tid; j < kt; j += nt) taps_s[j] = taps[c0 + j];
        __syncthreads();
      }
      if (tid < groups)
        register_taps(acc, s, tid + a - c0 / kOutputs, pitch, taps_s, kt);
    }
    // the outputs through shared memory (row v, column g: output g
    // kOutputs + v at its interleaved place) to one coalesced store
    __syncthreads();                  // every window read
    if (tid < groups)
#pragma unroll
      for (int v = 0; v < kOutputs; ++v) s[v * pitch + tid] = acc[v];
    __syncthreads();
    for (int i = tid; i < len; i += nt)
      y[r * S + t0 + i] =
          from_f<T>(s[(i & (kOutputs - 1)) * pitch + (i >> kLogOutputs)]);
  }
}

// the tile the kernel takes: the caller's up to kTapChunk taps, at most
// fir_register_tile() past them
int effective_tile(int tile, int k) {
  return k > kTapChunk ? min(tile, fir_register_tile()) : tile;
}

size_t smem_bytes(int tile, int k) {
  if (k <= kTapChunk) return sizeof(float) * (size_t(tile) + k - 1);
  const int t = effective_tile(tile, k);
  const int cap = fir_tap_capacity(t, k);
  // not one step of taps beside the tile: more than a block holds
  return fir_window_bytes(t, k) + sizeof(float) * size_t(cap ? cap : kStep) +
         (cap ? 0 : size_t(kMaxSmemBytes));
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t launch(const void* x, const float* taps, void* y, int R, int S,
                   int k, int tile, int block_rows, cudaStream_t stream) {
  const size_t smem = smem_bytes(tile, k);
  if (smem > size_t(kMaxSmemBytes)) return cudaErrorInvalidValue;
  const int t = effective_tile(tile, k);
  const dim3 grid((R + block_rows - 1) / block_rows, (S + t - 1) / t);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (k <= kTapChunk) {
    cudaError_t err = allow_smem(fir_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    fir_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), taps, static_cast<T*>(y), R, S, k, t,
        block_rows);
    return cudaGetLastError();
  }
  cudaError_t err = allow_smem(fir_register_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int groups = (t + kOutputs - 1) / kOutputs;
  const int threads = (groups + 31) / 32 * 32;
  fir_register_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), taps, static_cast<T*>(y), R, S, k, t,
      block_rows, fir_pitch(t, k), fir_tap_capacity(t, k));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for a tile of `tile` samples and
// `n_taps` taps (up to kTapChunk taps the static taps not counted; past
// them the tile is at most fir_register_tile() samples). More than a
// block can take where not one step of taps fits beside the tile.
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
      dtype < kFloat32 || dtype > kInt32)
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
