// Rotary position embedding over the rows of an (R, dh) float32 or bfloat16
// array as one CUDA kernel for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (kernels/rope/kernel.py). For pair i < dh/2 of row r at
// position pos[r / heads] (the heads of one sequence slot share a
// position, read once per row from a float32, int32 or int64 array):
//
//     inv = expf((i * (2/dh)) * -ln(theta)),  ang = pos * inv,
//     (x1, x2) -> (x1 cos ang - x2 sin ang, x1 sin ang + x2 cos ang),
//
// with the pair (x[2i], x[2i+1]) in the interleaved (GPT-J) layout and
// (x[i], x[i + dh/2]) in the neox (rotate-half) layout; computed in
// float32, written in the input's type.
//
// Replaces rope_pallas of src/repro/kernels/rope/kernel.py:46 (body
// rope_kernel :24, pallas_call :55), which computes the inverse
// frequencies and the angles in the kernel from a staged block of
// positions, with no rotary table in device memory.
//
// What bounds it on this card. Each element is read once and written once
// (4 or 2 bytes each way), each slot's position once, for ~8 float
// operations a pair plus one expf, one sinf and one cosf: well under the
// fp32 ridge (~20 operations per byte), so it is byte-bound.
//
// What the design does about it. One thread per rotated pair, consecutive
// threads on consecutive pairs of a row, so a warp's reads and writes are
// contiguous runs of the row. The inverse frequency and the angle are
// computed here in the JAX kernel's order, with the two constants rounded
// to float32 on the host as the reference does; the trigonometry is the
// IEEE sinf/cosf with full range reduction (the build uses no fast-math):
// at positions of a few thousand the angle reaches thousands of radians,
// where __sinf/__cosf would be visibly wrong. Products and sums use round-
// to-nearest intrinsics in the plain PyTorch version's order (no FMA
// contraction).

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

// position p of a float32 (0), int32 (1) or int64 (2) array, rounded to
// the nearest float32 as a conversion to float32 does
__device__ __forceinline__ float position(const void* pos, int pos_dtype,
                                          long long p) {
  if (pos_dtype == 0) return static_cast<const float*>(pos)[p];
  if (pos_dtype == 1) return __int2float_rn(static_cast<const int*>(pos)[p]);
  return __ll2float_rn(static_cast<const long long*>(pos)[p]);
}

// I, the unsigned type of the pair index: 32 bits where the pairs fit
// (the two divisions per thread are then 32-bit ones), else 64
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const void* __restrict__ pos,
            T* __restrict__ out, I pairs, int dh, I heads,
            float two_over_dh, float neg_log_theta, int neox,
            int pos_dtype) {
  const I t = (I)blockIdx.x * kThreads + threadIdx.x;
  if (t >= pairs) return;
  const int h = dh >> 1;
  const I r = t / (I)h;
  const int i = (int)(t - r * (I)h);
  const float inv = expf(__fmul_rn(__fmul_rn((float)i, two_over_dh),
                                   neg_log_theta));
  const float ang = __fmul_rn(
      position(pos, pos_dtype, (long long)(r / heads)), inv);
  const float c = cosf(ang), s = sinf(ang);
  const long long i1 = (long long)r * dh + (neox ? i : 2 * i);
  const long long i2 = i1 + (neox ? h : 1);
  const float x1 = to_f(x[i1]), x2 = to_f(x[i2]);
  out[i1] = from_f<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  out[i2] = from_f<T>(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
}

template <typename T>
cudaError_t launch(const void* x, const void* pos, void* out, long long R,
                   int dh, int heads, float two_over_dh, float neg_log_theta,
                   int neox, int pos_dtype, cudaStream_t stream) {
  const long long pairs = R * (dh >> 1);
  const long long blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks * kThreads <= 0xffffffffLL)
    rope_kernel<T, unsigned><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), pos, static_cast<T*>(out),
        (unsigned)pairs, dh, (unsigned)heads, two_over_dh, neg_log_theta,
        neox, pos_dtype);
  else
    rope_kernel<T, unsigned long long>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(
            static_cast<const T*>(x), pos, static_cast<T*>(out),
            (unsigned long long)pairs, dh, (unsigned long long)heads,
            two_over_dh, neg_log_theta, neox, pos_dtype);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rope_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out = rope(x) for a row-major (R, dh) x of `dtype` (0: float32, 1:
// bfloat16), dh even, and positions (R / heads,) of `pos_dtype` (0:
// float32, 1: int32, 2: int64), row r at position pos[r / heads], on
// `stream`, on the calling thread's current device; `two_over_dh` and
// `neg_log_theta` are float32(2 / dh) and float32(-ln theta); `neox` 0 for
// the interleaved layout, 1 for rotate-half. Returns cudaGetLastError()
// after the launch (0 on success). Allocates nothing and does not
// synchronise.
int rope_launch(const void* x, const void* pos, void* out, long long R,
                int dh, int heads, float two_over_dh, float neg_log_theta,
                int neox, int dtype, int pos_dtype, void* stream) {
  if (R < 1 || dh < 2 || (dh & 1) || heads < 1 || R % heads ||
      (neox != 0 && neox != 1) || (dtype != 0 && dtype != 1) ||
      pos_dtype < 0 || pos_dtype > 2 ||
      (R * (dh >> 1) + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(x, pos, out, R, dh, heads, two_over_dh,
                                 neg_log_theta, neox, pos_dtype, st)
                 : launch<__nv_bfloat16>(x, pos, out, R, dh, heads,
                                         two_over_dh, neg_log_theta, neox,
                                         pos_dtype, st);
  return static_cast<int>(err);
}

}  // extern "C"
