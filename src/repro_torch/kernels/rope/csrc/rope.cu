// Rotary position embedding over the rows of an (R, dh) float32 or bfloat16
// array as one CUDA kernel for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (kernels/rope/kernel.py). For pair i < dh/2 of row r at
// position pos[r / heads] (the heads of one sequence slot share a
// position, read once per slot from a float32, int32 or int64 array):
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
// (4 or 2 bytes each way) and each slot's position once; the angles cost
// one expf, sinf and cosf per (slot, frequency), not per element. So it
// is byte-bound (3.35 TB/s), provided the trigonometry is not repeated
// for every head and the accesses are wide.
//
// What the design does about it. A block owns `block_slots` whole slots,
// the heads x dh elements of each one contiguous span. It first computes
// the slots' dh/2 (cos, sin) pairs once into two shared-memory planes (one
// table per slot, shared by its heads), then streams the span: each
// thread takes a unit of G pairs, one 16- or 8-byte vector in the
// interleaved layout (whole pairs) or one vector from each half in neox,
// and reads its G cosines and sines as one vector from each plane. The
// host picks the vector width the row allows (`vec_bytes`: 16 or 8 where
// the base pointers are aligned to it and the interleaved row, or neox
// half row, is a whole number of vectors; else 0, the scalar path of one
// pair a unit in the same kernel). A thread's unit and row come from one
// division at its start and advance by constant steps, so no division by
// dh/2 or by heads is made per pair. A thread loads kDepth units before it
// rotates the first, and its first units are loaded before the table is
// computed, so the table's latency hides behind theirs.
//
// The arithmetic is that of the kernel it replaced, operation for
// operation: the inverse frequency and the angle in the JAX kernel's
// order with the two constants rounded to float32 on the host as the
// reference does; the IEEE sinf/cosf with full range reduction (the build
// uses no fast-math: at positions of a few thousand the angle reaches
// thousands of radians, where __sinf/__cosf would be visibly wrong);
// products and sums with round-to-nearest intrinsics in the plain PyTorch
// version's order (no FMA contraction). So the output is bitwise what one
// thread per pair computing its own angle gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // most threads a block
constexpr int kDepth = 2;              // units a thread loads before it rotates
constexpr int kTableBytes = 48 * 1024; // most shared memory for the planes

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

// NE elements of type T at p into floats: one VB-byte vector (16 or 8),
// or NE scalars when VB is 0
template <typename T, int VB, int NE>
__device__ __forceinline__ void load(const T* p, float (&f)[NE]) {
  if constexpr (VB == 0) {
#pragma unroll
    for (int j = 0; j < NE; ++j) f[j] = to_f(p[j]);
  } else {
    unsigned w[VB / 4];
    if constexpr (VB == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    }
#pragma unroll
    for (int j = 0; j < VB / 4; ++j) {
      if constexpr (sizeof(T) == 4) {
        f[j] = __uint_as_float(w[j]);
      } else {                         // bfloat16: exact, by the bits
        f[2 * j] = __uint_as_float(w[j] << 16);
        f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
}

template <typename T, int VB, int NE>
__device__ __forceinline__ void store(T* p, const float (&f)[NE]) {
  if constexpr (VB == 0) {
#pragma unroll
    for (int j = 0; j < NE; ++j) p[j] = from_f<T>(f[j]);
  } else {
    unsigned w[VB / 4];
#pragma unroll
    for (int j = 0; j < VB / 4; ++j) {
      if constexpr (sizeof(T) == 4) {
        w[j] = __float_as_uint(f[j]);
      } else {
        w[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * j]))
               | ((unsigned)__bfloat16_as_ushort(
                      __float2bfloat16_rn(f[2 * j + 1])) << 16);
      }
    }
    if constexpr (VB == 16)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// G consecutive floats of a shared-memory plane, as wide as they are
// aligned (a unit's first pair index is a multiple of G)
template <int G>
__device__ __forceinline__ void read_plane(const float* p, float (&f)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int j = 0; j < G; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      f[j] = v.x; f[j + 1] = v.y; f[j + 2] = v.z; f[j + 3] = v.w;
    }
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  } else {
    f[0] = p[0];
  }
}

__device__ __forceinline__ void rotate(float& x1, float& x2, float c,
                                       float s) {
  const float o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  const float o2 = __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
  x1 = o1;
  x2 = o2;
}

// VB: vector bytes (16, 8; 0 for scalar accesses). A unit is G pairs: NE
// consecutive elements holding G = NE/2 pairs (interleaved), or NE
// elements from each half (neox, G = NE).
template <typename T, int VB, bool kNeox>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const void* __restrict__ pos,
            T* __restrict__ out, long long slots, int heads, int dh,
            int block_slots, float two_over_dh, float neg_log_theta,
            int pos_dtype) {
  constexpr int NE = VB ? VB / (int)sizeof(T) : (kNeox ? 1 : 2);
  constexpr int G = kNeox ? NE : NE / 2;
  constexpr int kStride = kNeox ? G : 2 * G;  // elements between units
  extern __shared__ float4 smem[];
  const int h = dh >> 1;
  const long long slot0 = (long long)blockIdx.x * block_slots;
  const int nslots = (int)min((long long)block_slots, slots - slot0);
  const int plane = (block_slots * h + 3) & ~3;
  float* const tc = reinterpret_cast<float*>(smem);
  float* const ts = tc + plane;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // The rotation's walk. The block's rows are k = 0 .. nslots * heads - 1
  // (slot s = k / heads), each `units` units wide; thread t starts at unit
  // t % units of row t / units and steps by nthreads units: dk rows and
  // du units, with one carry.
  const int units = h / G;
  const int nrows = nslots * heads;
  int k = tid / units, u = tid - k * units;
  int s = k / heads, r = k - s * heads;
  const int dk = nthreads / units, du = nthreads - dk * units;
  const int ds = dk / heads, dr = dk - ds * heads;
  const long long base = slot0 * heads * (long long)dh;
  float a[kDepth][NE], b[kDepth][kNeox ? NE : 1];
  long long off[kDepth];
  int t[kDepth];
  bool ok[kDepth];
  // load the thread's next kDepth units and their table offsets
  auto fetch = [&]() {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      ok[d] = k < nrows;
      off[d] = base + (long long)k * dh + u * kStride;
      t[d] = s * h + u * G;
      if (ok[d]) {
        load<T, VB>(x + off[d], a[d]);
        if constexpr (kNeox) load<T, VB>(x + off[d] + h, b[d]);
      }
      u += du;
      k += dk;
      s += ds;
      r += dr;
      if (r >= heads) { r -= heads; ++s; }
      if (u >= units) {
        u -= units;
        ++k;
        if (++r == heads) { r = 0; ++s; }
      }
    }
  };
  // the first units are in flight while the table is computed
  fetch();

  // 1. the (cos, sin) of each slot's dh/2 angles: thread t takes pair
  //    t % hh of slots t / hh, t / hh + nthreads / hh, ...
  {
    const int hh = min(h, nthreads);
    const int sstep = nthreads / hh;
    const int s0 = tid / hh, i0 = tid - s0 * hh;
    if (s0 < sstep) {
      for (int sl = s0; sl < nslots; sl += sstep) {
        const float p = position(pos, pos_dtype, slot0 + sl);
        for (int i = i0; i < h; i += hh) {
          const float inv = expf(__fmul_rn(__fmul_rn((float)i, two_over_dh),
                                           neg_log_theta));
          const float ang = __fmul_rn(p, inv);
          tc[sl * h + i] = cosf(ang);
          ts[sl * h + i] = sinf(ang);
        }
      }
    }
  }
  __syncthreads();

  // 2. the rotation, kDepth units at a time
  while (ok[0]) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (!ok[d]) continue;
      float c[G], sn[G];
      read_plane<G>(tc + t[d], c);
      read_plane<G>(ts + t[d], sn);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if constexpr (kNeox)
          rotate(a[d][j], b[d][j], c[j], sn[j]);
        else
          rotate(a[d][2 * j], a[d][2 * j + 1], c[j], sn[j]);
      }
      store<T, VB>(out + off[d], a[d]);
      if constexpr (kNeox) store<T, VB>(out + off[d] + h, b[d]);
    }
    fetch();
  }
}

template <typename T, int VB, bool kNeox>
cudaError_t launch(const void* x, const void* pos, void* out,
                   long long slots, int heads, int dh, int block_slots,
                   int threads, float two_over_dh, float neg_log_theta,
                   int pos_dtype, cudaStream_t stream) {
  const long long blocks = (slots + block_slots - 1) / block_slots;
  const size_t smem =
      2 * sizeof(float) * (size_t)((block_slots * (dh >> 1) + 3) & ~3);
  rope_kernel<T, VB, kNeox><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), pos, static_cast<T*>(out), slots, heads, dh,
      block_slots, two_over_dh, neg_log_theta, pos_dtype);
  return cudaGetLastError();
}

template <typename T, bool kNeox>
cudaError_t launch_vec(int vec_bytes, const void* x, const void* pos,
                       void* out, long long slots, int heads, int dh,
                       int block_slots, int threads, float two_over_dh,
                       float neg_log_theta, int pos_dtype,
                       cudaStream_t stream) {
  if (vec_bytes == 16)
    return launch<T, 16, kNeox>(x, pos, out, slots, heads, dh, block_slots,
                                threads, two_over_dh, neg_log_theta,
                                pos_dtype, stream);
  if (vec_bytes == 8)
    return launch<T, 8, kNeox>(x, pos, out, slots, heads, dh, block_slots,
                               threads, two_over_dh, neg_log_theta,
                               pos_dtype, stream);
  return launch<T, 0, kNeox>(x, pos, out, slots, heads, dh, block_slots,
                             threads, two_over_dh, neg_log_theta, pos_dtype,
                             stream);
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
// the interleaved layout, 1 for rotate-half. The launch geometry comes
// from the host (kernel.py:rope_geometry): `vec_bytes` 16, 8 or 0
// (scalar), `misalign` = (x | out) % 16 of the two base addresses, which
// a vector width must divide, `block_slots` slots a block and `threads`
// a block. Returns cudaGetLastError() after the launch (0 on success).
// Allocates nothing and does not synchronise.
int rope_launch(const void* x, const void* pos, void* out, long long R,
                int dh, int heads, float two_over_dh, float neg_log_theta,
                int neox, int dtype, int pos_dtype, int vec_bytes,
                int misalign, int block_slots, int threads, void* stream) {
  if (R < 1 || dh < 2 || (dh & 1) || heads < 1 || R % heads ||
      (neox != 0 && neox != 1) || (dtype != 0 && dtype != 1) ||
      pos_dtype < 0 || pos_dtype > 2 || threads < 1 || threads > kThreads ||
      block_slots < 1 || (long long)block_slots * heads > 0x7fffffffLL ||
      2LL * 4 * (((long long)block_slots * (dh >> 1) + 3) & ~3LL) >
          kTableBytes ||
      (R / heads + block_slots - 1) / block_slots > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = dtype == 0 ? 4 : 2;
  // a vector must hold whole pairs (interleaved) or tile the half row
  // (neox), and both base addresses must be aligned to it
  const long long tiled = (long long)(neox ? dh >> 1 : dh) * elem;
  if ((vec_bytes != 0 && vec_bytes != 8 && vec_bytes != 16) ||
      misalign < 0 || misalign > 15 ||
      (vec_bytes && (misalign % vec_bytes || tiled % vec_bytes)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long slots = R / heads;
  cudaError_t err;
  if (dtype == 0)
    err = neox ? launch_vec<float, true>(vec_bytes, x, pos, out, slots,
                                         heads, dh, block_slots, threads,
                                         two_over_dh, neg_log_theta,
                                         pos_dtype, st)
               : launch_vec<float, false>(vec_bytes, x, pos, out, slots,
                                          heads, dh, block_slots, threads,
                                          two_over_dh, neg_log_theta,
                                          pos_dtype, st);
  else
    err = neox ? launch_vec<__nv_bfloat16, true>(
                     vec_bytes, x, pos, out, slots, heads, dh, block_slots,
                     threads, two_over_dh, neg_log_theta, pos_dtype, st)
               : launch_vec<__nv_bfloat16, false>(
                     vec_bytes, x, pos, out, slots, heads, dh, block_slots,
                     threads, two_over_dh, neg_log_theta, pos_dtype, st);
  return static_cast<int>(err);
}

}  // extern "C"
