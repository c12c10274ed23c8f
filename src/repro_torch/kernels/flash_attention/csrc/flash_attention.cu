// Flash attention (online softmax) with grouped-query heads, a causal mask
// aligned top-left and an optional sliding window, as one CUDA kernel for
// Hopper (sm_90a), bound to PyTorch through a plain C interface
// (kernels/flash_attention/kernel.py). q is (B, Sq, H, dh), k and v are
// (B, Skv, KV, dh), read in that public layout through their strides;
// query head h reads kv head h / (H / KV). For query position i and key
// position j (both counted from 0) a score is live when
//
//     (!causal || i >= j) && (!window || i - j < window);
//
// the output is softmax(q k^T / sqrt(dh)) v over the live keys, accumulated
// in float32 and written in q's type (float32 or bfloat16).
//
// Replaces flash_attention_pallas of
// src/repro/kernels/flash_attention/kernel.py:82 (body _kernel :28,
// pallas_call :102), which walks a (batch x heads, q-chunk, kv-chunk) grid
// with the running max, sum and accumulator in VMEM scratch across the kv
// axis and skips the chunks outside the causal or window band.
//
// What bounds it on this card. 4 dh operations per live (query, key) pair
// (the two products) against 2 dh elements of q and out per query and of k
// and v per key: at S in the thousands that is hundreds of operations per
// byte, so it is operation-bound. This kernel runs the products as float32
// FMAs on the CUDA cores (67 TFLOP/s at best); bfloat16 I/O could use the
// tensor cores (989 TFLOP/s dense), which this first version does not.
//
// What the design does about it. One block of 256 threads (16 x 16) per
// (batch x head, 64-query tile). The block scales its q tile by 1/sqrt(dh)
// into shared memory once (as float32, dh zero-padded to a multiple of
// 64), then walks the 64-key tiles of the matching kv head inside the
// causal/window band only, one after another through one shared buffer: K,
// the 64 x 64 score tile (4 x 4 per thread, 128-bit shared loads), the
// row max and sum across the 16 threads of a row by warp shuffles, the
// probabilities into shared memory, then V and the product into a 4 x 4
// NCG accumulator per thread (rows ty + 16 i, columns 64 g + 4 tx). The
// running max, sum and accumulator stay in registers for the whole walk.
// Masked scores get -1e30, as the reference's fill, and the running max
// starts at -1e30: a row whose keys in one live tile are all masked gets p
// = 1 there for a moment, and the next tile with a live key cancels it
// exactly through exp(-1e30 - m) = 0; keys past Skv (the last tile's tail)
// get -inf and weigh 0. The output divides by max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 16 x 16
constexpr int kBQ = 64;             // queries per block
constexpr int kBK = 64;             // keys per tile
constexpr int kPS = kBQ + 4;        // row stride of the probability tile
constexpr float kNegInf = -1e30f;   // the reference's mask fill

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

struct Args {
  const void* q; const void* k; const void* v; void* out;
  int B, H, KV, Sq, Skv, dh;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale;
  int causal, has_window;
  long long window;
};

// rows [0, kBK) of one (S, dh) head slice starting at row `lo` into a
// row-major shared tile of stride dhp + 4, scaled, zero past the ends
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int lo,
                                          int S, int dh, int dhp,
                                          float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < kBK; c += kThreads / 32) {
    const bool in = lo + c < S;
    const T* row = src + (long long)(lo + c) * row_stride;
    for (int d = lane; d < dhp; d += 32)
      dst[c * (dhp + 4) + d] =
          in && d < dh ? __fmul_rn(to_f(row[d]), scale) : 0.f;
  }
}

template <typename T, int NCG>
__global__ void __launch_bounds__(kThreads, NCG <= 2 ? 2 : 1)
flash_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int dhp = NCG * 64, st = dhp + 4;
  float* qs = smem;                       // kBQ x st
  float* kv = qs + kBQ * st;              // kBK x st: K, then V
  float* ps = kv + kBK * st;              // kBK x kPS: p transposed
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q_lo = blockIdx.y * kBQ;
  const T* qp = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  load_tile<T>(qs, qp, a.qss, q_lo, a.Sq, a.dh, dhp, a.scale);

  // the live key tiles: [j0, j1)
  const int q_hi = min(q_lo + kBQ, a.Sq) - 1;
  int j0 = 0, j1 = (a.Skv + kBK - 1) / kBK;
  if (a.causal) j1 = min(j1, q_hi / kBK + 1);
  if (a.has_window) {
    const long long first = (long long)q_lo - a.window + 1;  // least key
    if (first > 0) j0 = (int)min(first / kBK, (long long)j1);
  }
  const int dq = (a.dh + 3) & ~3;         // the product's depth

  float m[4], l[4], acc[4][NCG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NCG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  for (int jt = j0; jt < j1; ++jt) {
    const int k_lo = jt * kBK;
    __syncthreads();                      // last tile's V and p are read
    load_tile<T>(kv, kp, a.kss, k_lo, a.Skv, a.dh, dhp, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dq; d += 4) {
      float4 q4[4], k4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q4[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * st +
                                                 d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k4[j] = *reinterpret_cast<const float4*>(kv + (tx + 16 * j) * st +
                                                 d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(q4[i].x, k4[j].x, s[i][j]);
          s[i][j] = fmaf(q4[i].y, k4[j].y, s[i][j]);
          s[i][j] = fmaf(q4[i].z, k4[j].z, s[i][j]);
          s[i][j] = fmaf(q4[i].w, k4[j].w, s[i][j]);
        }
    }
    // mask, online softmax, probabilities into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q_lo + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k_lo + tx + 16 * j;
        if (kpos >= a.Skv) {
          s[i][j] = -INFINITY;
        } else if ((a.causal && qpos < kpos) ||
                   (a.has_window && qpos - kpos >= a.window)) {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(tx + 16 * j) * kPS + ty * 4 + i] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NCG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= corr;
    }
    __syncthreads();                      // K is read; p is written
    load_tile<T>(kv, vp, a.vss, k_lo, a.Skv, a.dh, dhp, 1.f);
    __syncthreads();
    const int kn = min(kBK, a.Skv - k_lo);
    for (int c = 0; c < kn; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + c * kPS +
                                                         ty * 4);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < NCG; ++g) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            kv + c * st + 64 * g + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g][0] = fmaf(pr[i], v4.x, acc[i][g][0]);
          acc[i][g][1] = fmaf(pr[i], v4.y, acc[i][g][1]);
          acc[i][g][2] = fmaf(pr[i], v4.z, acc[i][g][2]);
          acc[i][g][3] = fmaf(pr[i], v4.w, acc[i][g][3]);
        }
      }
    }
  }

  // publish: out is a contiguous (B, Sq, H, dh)
  T* op = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_lo + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* row = op + (((long long)b * a.Sq + qpos) * a.H + h) * a.dh;
#pragma unroll
    for (int g = 0; g < NCG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * g + 4 * tx + e;
        if (d < a.dh) row[d] = from_f<T>(acc[i][g][e] / li);
      }
  }
}

size_t smem_bytes(int dh) {
  const int dhp = (dh + 63) / 64 * 64;
  return sizeof(float) * (size_t(kBQ + kBK) * (dhp + 4) + size_t(kBK) * kPS);
}

template <typename T, int NCG>
cudaError_t launch_ncg(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.dh);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, NCG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.B * a.H, (a.Sq + kBQ - 1) / kBQ);
  flash_kernel<T, NCG><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  switch ((a.dh + 63) / 64) {
    case 1: return launch_ncg<T, 1>(a, stream);
    case 2: return launch_ncg<T, 2>(a, stream);
    case 3: return launch_ncg<T, 3>(a, stream);
    case 4: return launch_ncg<T, 4>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at head dimension `dh`.
size_t flash_attention_smem_bytes(int dh) { return smem_bytes(dh); }

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out = attention(q, k, v) for q (B, Sq, H, dh) and k, v (B, Skv, KV, dh)
// of `dtype` (0: float32, 1: bfloat16) given by their batch, sequence and
// head strides in elements (the head dimension contiguous), into a
// contiguous (B, Sq, H, dh) out, on `stream`, on the calling thread's
// current device. dh <= 256, H % KV == 0; `scale` is float32(1/sqrt(dh));
// `window` is read when `has_window` is 1. Returns cudaGetLastError()
// after the launch (0 on success). Allocates nothing and does not
// synchronise.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int KV, int Sq, int Skv,
                           int dh, long long qsb, long long qss,
                           long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss,
                           long long vsh, float scale, int causal,
                           int has_window, long long window, int dtype,
                           void* stream) {
  if (B < 1 || H < 1 || KV < 1 || H % KV || Sq < 1 || Skv < 1 || dh < 1 ||
      dh > 256 || (long long)B * H > 0x7fffffffLL ||
      (Sq + kBQ - 1) / kBQ > 65535 || (causal != 0 && causal != 1) ||
      (has_window != 0 && has_window != 1) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, B, H, KV, Sq, Skv, dh, qsb, qss, qsh, ksb,
               kss, ksh, vsb, vss, vsh, scale, causal, has_window, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(a, st)
                                     : launch<__nv_bfloat16>(a, st);
  return static_cast<int>(err);
}

}  // extern "C"
