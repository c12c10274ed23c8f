// The fused MBioTracker stage graph (FIR -> delineation -> interval time
// features + packed-rFFT band powers -> linear SVM) as one CUDA kernel for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (cuda.py).
//
// Replaces the TPU kernel bodies graph_kernel and graph_stream_kernel of
// src/repro/kernels/pipeline/graph.py:382/395, at their three pallas_call
// sites graph_frames_call (:479), graph_stream_call (:526) and
// graph_ring_call (:575). One kernel serves all three: frame f of slot r
// starts at x + r*slot_stride + f*frame_stride (frame_stride = window for
// pre-framed rows, hop for a raw signal; slot_stride = a ring's row stride).
//
// What bounds it on this card. Per frame of 2048 samples the graph reads
// 8 KB and does on the order of 1e5 float operations (11-tap FIR, three
// reductions, the +-15-sample dilation, two scans, a 256-point FFT). Over
// a whole recording that is operation-bound at the card's fp32 rate when
// only features/margin/class are written, and byte-bound when the
// (frames x window) filtered output is written too. The default dispatch
// of the stream runtime is 8 frames, i.e. 8 blocks on 132 SMs: there
// launch latency, not either bound, sets the time.
//
// What the design does about it. The TPU schedule filtered a VMEM chunk
// once and patched each frame's first taps-1 columns, to share the overlap
// inside one VMEM residency. Blocks here run in parallel with nothing
// carried between them, so each block stages its own frame in shared
// memory and filters it with zero history before the first sample: the
// overlap is re-read from L2 instead of shared, and every entry runs the
// same per-frame code, so stream == framed == ring is bitwise by
// construction. Everything after the load stays in shared memory; only
// the requested outputs are written. The interval median is an exact rank
// selection over a shared-memory histogram of the gaps (the reference's
// sorting networks return the same integer on both branches). Products and
// sums that the plain PyTorch version also computes elementwise use
// explicit round-to-nearest intrinsics, so the FIR output and the SVM
// order match it without FMA contraction. No fast-math: sqrtf, division
// and log1pf stay IEEE.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFeatures = 12;
constexpr int kMaxTaps = 64;
constexpr int kMaxClasses = 32;
constexpr unsigned kFull = 0xffffffffu;

// output selection bits (cuda.py keeps the same values)
constexpr int kOutFiltered = 1;
constexpr int kOutFeatures = 2;
constexpr int kOutMargin = 4;
constexpr int kOutClass = 8;

struct Params {
  const float* x;
  long long slot_stride;
  long long frame_stride;
  int n_frames;
  int window;
  int block_frames;
  const float* taps;
  int n_taps;
  const float* tw_re;     // (log2 m, m/2) Stockham twiddles, m = fft/2
  const float* tw_im;
  const float* untangle;  // (2, m) cos/sin(-2 pi k / fft)
  int fft_size;
  const float* svm_w;     // (12, C)
  const float* svm_b;     // (C,)
  int n_classes;
  int bands[7];           // band edges over the fft/2+1 power bins
  float prominence;
  int min_distance;
  float* out_filtered;    // (rows, window) or null
  float* out_features;    // (rows, 12) or null
  float* out_margin;      // (rows, C) or null
  int* out_class;         // (rows,) or null
  int* retired;           // frame counter (ring sweeps) or null
  int valid_rows;         // only rows below this count as retired
  int flags;
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// dynamic shared memory: raw, filt (S floats each), the two gap
// histograms (S+1 ints each), the FFT ping-pong planes (4m floats), the
// power spectrum (m+1 floats) and the extrema flags (S bytes)
__host__ __device__ inline size_t smem_bytes(int S, int fft_size) {
  const size_t m = size_t(fft_size) / 2;
  return align16(4 * size_t(S)) * 2 + align16(4 * 2 * (size_t(S) + 1)) +
         align16(4 * 4 * m) + align16(4 * (m + 1)) + align16(size_t(S));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_isum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// block-wide sum / max / min of one value per thread, in a fixed order
__device__ void block_sum_max_min(float& s, float& mx, float& mn,
                                  float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  s = warp_sum(s);
  mx = warp_max(mx);
  mn = warp_min(mn);
  if (lane == 0) {
    red[w] = s;
    red[kWarps + w] = mx;
    red[2 * kWarps + w] = mn;
  }
  __syncthreads();
  if (w == 0) {
    float a = lane < kWarps ? red[lane] : 0.f;
    float b = lane < kWarps ? red[kWarps + lane] : -INFINITY;
    float c = lane < kWarps ? red[2 * kWarps + lane] : INFINITY;
    a = warp_sum(a);
    b = warp_max(b);
    c = warp_min(c);
    if (lane == 0) {
      red[0] = a;
      red[kWarps] = b;
      red[2 * kWarps] = c;
    }
  }
  __syncthreads();
  s = red[0];
  mx = red[kWarps];
  mn = red[2 * kWarps];
  __syncthreads();
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    float a = lane < kWarps ? red[lane] : 0.f;
    a = warp_sum(a);
    if (lane == 0) red[0] = a;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// block-wide sum of N ints per thread
template <int N>
__device__ void block_isum(int (&v)[N], int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = warp_isum(v[i]);
    if (lane == 0) red[i * kWarps + w] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int acc = 0;
    for (int j = 0; j < kWarps; ++j) acc += red[i * kWarps + j];
    v[i] = acc;
  }
  __syncthreads();
}

// block-wide EXCLUSIVE scan of two ints per thread (thread order), with
// operator max (identity -1) when kMax, else sum (identity 0)
template <bool kMax>
__device__ void block_exclusive_scan2(int& a, int& b, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int ident = kMax ? -1 : 0;
  int ia = a, ib = b;
  for (int o = 1; o < 32; o <<= 1) {
    const int ta = __shfl_up_sync(kFull, ia, o);
    const int tb = __shfl_up_sync(kFull, ib, o);
    if (lane >= o) {
      ia = kMax ? max(ia, ta) : ia + ta;
      ib = kMax ? max(ib, tb) : ib + tb;
    }
  }
  if (lane == 31) {
    red[w] = ia;
    red[kWarps + w] = ib;
  }
  int ea = __shfl_up_sync(kFull, ia, 1);
  int eb = __shfl_up_sync(kFull, ib, 1);
  if (lane == 0) {
    ea = ident;
    eb = ident;
  }
  __syncthreads();
  int pa = ident, pb = ident;
  for (int j = 0; j < w; ++j) {
    pa = kMax ? max(pa, red[j]) : pa + red[j];
    pb = kMax ? max(pb, red[kWarps + j]) : pb + red[kWarps + j];
  }
  a = kMax ? max(pa, ea) : pa + ea;
  b = kMax ? max(pb, eb) : pb + eb;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
biosignal_graph_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_f[3 * kWarps];
  __shared__ int red_i[6 * kWarps];
  __shared__ float taps_s[kMaxTaps];
  __shared__ float feats[kFeatures];
  __shared__ float margin_s[kMaxClasses];
  __shared__ int med_s[2];

  const int S = p.window;
  const int m = p.fft_size / 2;
  const int tid = threadIdx.x;
  float* raw = reinterpret_cast<float*>(smem);
  float* filt = reinterpret_cast<float*>(smem + align16(4 * size_t(S)));
  int* hist = reinterpret_cast<int*>(smem + 2 * align16(4 * size_t(S)));
  float* fbuf = reinterpret_cast<float*>(
      smem + 2 * align16(4 * size_t(S)) + align16(4 * 2 * (size_t(S) + 1)));
  float* power = fbuf + 4 * m;
  unsigned char* flag = reinterpret_cast<unsigned char*>(
      reinterpret_cast<unsigned char*>(fbuf) + align16(4 * 4 * size_t(m)) +
      align16(4 * (size_t(m) + 1)));

  for (int i = tid; i < p.n_taps; i += kThreads) taps_s[i] = p.taps[i];

  const bool need_features =
      (p.flags & (kOutFeatures | kOutMargin | kOutClass)) != 0;
  const bool need_svm = (p.flags & (kOutMargin | kOutClass)) != 0;
  const int C = p.n_classes;

  for (int fi = 0; fi < p.block_frames; ++fi) {
    const int f = blockIdx.x * p.block_frames + fi;
    if (f >= p.n_frames) break;  // uniform across the block
    const long long row = (long long)blockIdx.y * p.n_frames + f;
    const float* src =
        p.x + (long long)blockIdx.y * p.slot_stride + (long long)f * p.frame_stride;

    // ---- stage the frame; clear the gap histograms
    for (int t = tid; t < S; t += kThreads) raw[t] = src[t];
    if (need_features)
      for (int i = tid; i < 2 * (S + 1); i += kThreads) hist[i] = 0;
    if (tid < 2) med_s[tid] = 0;
    __syncthreads();

    // ---- stage 1: causal FIR, zero history before the frame
    for (int t = tid; t < S; t += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < p.n_taps; ++i) {
        const float xv = t - i >= 0 ? raw[t - i] : 0.f;
        acc = __fadd_rn(acc, __fmul_rn(taps_s[i], xv));
      }
      filt[t] = acc;
      if (p.flags & kOutFiltered) p.out_filtered[row * S + t] = acc;
    }
    __syncthreads();
    if (!need_features) continue;

    // ---- stage 2: delineation
    float s = 0.f, hi = -INFINITY, lo = INFINITY;
    for (int t = tid; t < S; t += kThreads) {
      const float v = filt[t];
      s += v;
      hi = fmaxf(hi, v);
      lo = fminf(lo, v);
    }
    block_sum_max_min(s, hi, lo, red_f);
    const float mu = __fdiv_rn(s, (float)S);
    const float thr_hi = __fadd_rn(mu, __fmul_rn(p.prominence, __fsub_rn(hi, mu)));
    const float thr_lo = __fsub_rn(mu, __fmul_rn(p.prominence, __fsub_rn(mu, lo)));
    const int d = p.min_distance;
    for (int t = tid; t < S; t += kThreads) {
      const float v = filt[t];
      const float prev = filt[t == 0 ? S - 1 : t - 1];   // wrap-around roll
      const float nxt = filt[t == S - 1 ? 0 : t + 1];
      bool is_max = v > prev && v >= nxt && v > thr_hi;
      bool is_min = v < prev && v <= nxt && v < thr_lo;
      if (d > 0 && (is_max || is_min)) {
        // edge-replicated dilation == reduce over the clamped window
        const int a = max(0, t - d), b = min(S - 1, t + d);
        float dmax = filt[a], dmin = filt[a];
        for (int j = a + 1; j <= b; ++j) {
          dmax = fmaxf(dmax, filt[j]);
          dmin = fminf(dmin, filt[j]);
        }
        is_max = is_max && v >= dmax;
        is_min = is_min && v <= dmin;
      }
      if (t == 0 || t == S - 1) is_max = is_min = false;
      flag[t] = (unsigned char)((is_max ? 1 : 0) | (is_min ? 2 : 0));
    }
    __syncthreads();

    // ---- stage 3a: interval gaps by a block prefix-max scan over
    // contiguous per-thread chunks, then exact sums and histograms
    const int chunk = (S + kThreads - 1) / kThreads;
    const int c0 = min(S, tid * chunk), c1 = min(S, c0 + chunk);
    int last_max = -1, last_min = -1;
    for (int t = c0; t < c1; ++t) {
      if (flag[t] & 1) last_max = t;
      if (flag[t] & 2) last_min = t;
    }
    block_exclusive_scan2<true>(last_max, last_min, red_i);
    int acc6[6] = {0, 0, 0, 0, 0, 0};  // n, sum, sum of squares; max then min
    for (int t = c0; t < c1; ++t) {
      const unsigned char fl = flag[t];
      if (fl & 1) {
        if (last_max >= 0) {
          const int g = t - last_max;
          acc6[0] += 1; acc6[1] += g; acc6[2] += g * g;
          atomicAdd(&hist[g], 1);
        }
        last_max = t;
      }
      if (fl & 2) {
        if (last_min >= 0) {
          const int g = t - last_min;
          acc6[3] += 1; acc6[4] += g; acc6[5] += g * g;
          atomicAdd(&hist[S + 1 + g], 1);
        }
        last_min = t;
      }
    }
    block_isum<6>(acc6, red_i);   // its first barrier orders the atomics

    // lower median: the smallest gap whose running count passes k
    const int nbins = S + 1;
    const int bchunk = (nbins + kThreads - 1) / kThreads;
    const int b0 = min(nbins, tid * bchunk), b1 = min(nbins, b0 + bchunk);
    int cnt_max = 0, cnt_min = 0;
    for (int b = b0; b < b1; ++b) {
      cnt_max += hist[b];
      cnt_min += hist[nbins + b];
    }
    int before_max = cnt_max, before_min = cnt_min;
    block_exclusive_scan2<false>(before_max, before_min, red_i);
    for (int which = 0; which < 2; ++which) {
      const int nv = acc6[3 * which];
      const int k = (max(nv, 1) - 1) / 2;
      const int before = which ? before_min : before_max;
      const int cnt = which ? cnt_min : cnt_max;
      if (nv > 0 && before <= k && k < before + cnt) {
        int run = before;
        for (int b = b0; b < b1; ++b) {
          run += hist[which * nbins + b];
          if (run > k) {
            med_s[which] = b;
            break;
          }
        }
      }
    }

    // ---- stage 3b: packed rFFT of the mean-subtracted first fft_size
    // samples -> 6 log-band powers
    float ss = 0.f;
    for (int t = tid; t < p.fft_size; t += kThreads) ss += filt[t];
    ss = block_sum(ss, red_f);  // its first barrier also publishes med_s
    const float seg_mean = __fdiv_rn(ss, (float)p.fft_size);
    if (tid == 0) {
      for (int which = 0; which < 2; ++which) {
        const float n = (float)max(acc6[3 * which], 1);
        feats[3 * which + 0] = __fdiv_rn((float)acc6[3 * which + 1], n);
        feats[3 * which + 1] = (float)med_s[which];
        feats[3 * which + 2] = sqrtf(__fdiv_rn((float)acc6[3 * which + 2], n));
      }
    }
    float* are = fbuf;
    float* aim = fbuf + m;
    float* bre = fbuf + 2 * m;
    float* bim = fbuf + 3 * m;
    for (int j = tid; j < m; j += kThreads) {
      are[j] = __fsub_rn(filt[2 * j], seg_mean);
      aim[j] = __fsub_rn(filt[2 * j + 1], seg_mean);
    }
    __syncthreads();
    int stage = 0;
    for (int n = m, g = 1; n > 1; n >>= 1, g <<= 1, ++stage) {
      const int half = n >> 1;
      const float* wr = p.tw_re + (long long)stage * (m / 2);
      const float* wi = p.tw_im + (long long)stage * (m / 2);
      for (int bf = tid; bf < m / 2; bf += kThreads) {
        const int q = bf / half, j = bf - q * half;
        const float ar = are[q * n + j], ai = aim[q * n + j];
        const float br = are[q * n + j + half], bi = aim[q * n + j + half];
        const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
        const float w_r = wr[j], w_i = wi[j];
        bre[q * half + j] = __fadd_rn(ar, br);
        bim[q * half + j] = __fadd_rn(ai, bi);
        bre[(g + q) * half + j] =
            __fsub_rn(__fmul_rn(dr, w_r), __fmul_rn(di, w_i));
        bim[(g + q) * half + j] =
            __fadd_rn(__fmul_rn(dr, w_i), __fmul_rn(di, w_r));
      }
      __syncthreads();
      float* t0 = are; are = bre; bre = t0;
      float* t1 = aim; aim = bim; bim = t1;
    }
    // untangle: X[k] = (Z[k] + conj Z[-k])/2 - i/2 e^{-2 pi i k/N} (Z[k] - conj Z[-k])
    for (int k = tid; k <= m; k += kThreads) {
      float xr, xi;
      if (k == m) {
        xr = __fsub_rn(are[0], aim[0]);
        xi = 0.f;
      } else {
        const int idx = k == 0 ? 0 : m - k;
        const float zr = are[k], zi = aim[k];
        const float zcr = are[idx], zci = -aim[idx];
        const float er = __fmul_rn(__fadd_rn(zr, zcr), 0.5f);
        const float ei = __fmul_rn(__fadd_rn(zi, zci), 0.5f);
        const float o_r = __fmul_rn(__fsub_rn(zr, zcr), 0.5f);
        const float o_i = __fmul_rn(__fsub_rn(zi, zci), 0.5f);
        const float ur = p.untangle[k], ui = p.untangle[m + k];
        const float pr = __fsub_rn(__fmul_rn(ur, o_r), __fmul_rn(ui, o_i));
        const float pi = __fadd_rn(__fmul_rn(ur, o_i), __fmul_rn(ui, o_r));
        xr = __fadd_rn(er, pi);
        xi = __fsub_rn(ei, pr);
      }
      power[k] = __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
    }
    __syncthreads();
    {
      const int lane = tid & 31, w = tid >> 5;
      if (w < 6) {
        float acc = 0.f;
        for (int i = p.bands[w] + lane; i < p.bands[w + 1]; i += 32)
          acc += power[i];
        acc = warp_sum(acc);
        if (lane == 0) feats[6 + w] = log1pf(acc);
      }
    }
    __syncthreads();
    if ((p.flags & kOutFeatures) && tid < kFeatures)
      p.out_features[row * kFeatures + tid] = feats[tid];

    // ---- stage 4: linear SVM margin (features in index order) + class
    if (need_svm) {
      if (tid < C) {
        float acc = __fmul_rn(feats[0], p.svm_w[tid]);
        for (int i = 1; i < kFeatures; ++i)
          acc = __fadd_rn(acc, __fmul_rn(feats[i], p.svm_w[i * C + tid]));
        acc = __fadd_rn(acc, p.svm_b[tid]);
        margin_s[tid] = acc;
        if (p.flags & kOutMargin) p.out_margin[row * C + tid] = acc;
      }
      __syncthreads();
      if (tid == 0 && (p.flags & kOutClass)) {
        // first index of the largest margin; NaN counts as largest
        int best = 0;
        for (int c = 1; c < C; ++c) {
          const float v = margin_s[c], bv = margin_s[best];
          if (!isnan(bv) && (v > bv || isnan(v))) best = c;
        }
        p.out_class[row] = best;
      }
    }
    __syncthreads();
  }

  // ---- retire: count this block's valid frames once they are written
  if (p.retired != nullptr && tid == 0) {
    int done = 0;
    for (int fi = 0; fi < p.block_frames; ++fi) {
      const int f = blockIdx.x * p.block_frames + fi;
      if (f >= p.n_frames) break;
      done += (long long)blockIdx.y * p.n_frames + f < p.valid_rows;
    }
    if (done) atomicAdd(p.retired, done);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for a (window, fft_size) frame.
size_t biosignal_graph_smem_bytes(int window, int fft_size) {
  return smem_bytes(window, fft_size);
}

const char* biosignal_graph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the graph over n_slots x n_frames frames on `stream`, on the
// calling thread's current device; returns cudaGetLastError() after the
// launch (0 on success). Allocates nothing and does not synchronise.
// `bands` is a host array of 7 band edges. When `retired` is not null the
// kernel adds to it the frames it wrote among the first `valid_rows`.
int biosignal_graph_launch(
    const float* x, long long slot_stride, long long frame_stride,
    int n_slots, int n_frames, int window, int block_frames,
    const float* taps, int n_taps, const float* tw_re, const float* tw_im,
    const float* untangle, int fft_size, const float* svm_w,
    const float* svm_b, int n_features, int n_classes, const int* bands,
    float prominence, int min_distance, float* out_filtered,
    float* out_features, float* out_margin, int* out_class, int* retired,
    int valid_rows, int flags, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || n_classes < 1 ||
      n_classes > kMaxClasses || n_features != kFeatures || n_slots < 1 ||
      n_slots > 65535 || n_frames < 1 || block_frames < 1 || window < 2 ||
      fft_size < 4 || fft_size > window)
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
  p.tw_re = tw_re;
  p.tw_im = tw_im;
  p.untangle = untangle;
  p.fft_size = fft_size;
  p.svm_w = svm_w;
  p.svm_b = svm_b;
  p.n_classes = n_classes;
  for (int i = 0; i < 7; ++i) p.bands[i] = bands[i];
  p.prominence = prominence;
  p.min_distance = min_distance;
  p.out_filtered = out_filtered;
  p.out_features = out_features;
  p.out_margin = out_margin;
  p.out_class = out_class;
  p.retired = retired;
  p.valid_rows = valid_rows;
  p.flags = flags;
  const size_t smem = smem_bytes(window, fft_size);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(biosignal_graph_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_frames + block_frames - 1) / block_frames, n_slots);
  biosignal_graph_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
