// The streaming ASR feature front-end (pre-emphasis FIR -> periodic Hann ->
// |packed rFFT|^2 -> log1p(power @ mel_w)) as one CUDA kernel for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (cuda.py).
//
// Replaces the ASR stage bodies of src/repro/kernels/pipeline/asr.py
// (_hann_body :115, _power_body :127, _logmel_body :140) as compiled into
// graph_kernel / graph_stream_kernel of src/repro/kernels/pipeline/graph.py
// at its three pallas_call sites graph_frames_call (:479),
// graph_stream_call (:526) and graph_ring_call (:575). One kernel serves
// all three, with the strided frame addressing of biosignal_graph.cu: frame
// f of slot r starts at x + r*slot_stride + f*frame_stride.
//
// What bounds it on this card. Per frame of the whisper-style configuration
// (window 512, 2 taps, 512-point rFFT, 64 mels) the graph reads ~640 new
// input bytes at hop 160 and writes 256 bytes of logmel, but does ~50k
// float operations, two thirds of them the dense (257 x 64) mel product:
// ~80 operations per byte, four times the card's fp32 ridge (67 TFLOP/s
// over 3.35 TB/s), so it is operation-bound unless the (frames x 512)
// filtered output is written as well.
//
// What the design does about it. A block of 256 threads runs its frames in
// tiles of kTile = 8 at once, so every stage has work for all threads: the
// FIR and Hann write the packed halves straight into shared memory, the
// 8 Stockham stages run 8 x 128 butterflies per barrier, and the mel
// product splits the 257 bins into kThreads / n_mels ranges, each thread
// keeping kTile accumulators so that one read of mel_w (65,792 bytes,
// through the read-only path from L1/L2) serves the whole tile. Only the
// requested outputs are written. Each frame is filtered with zero history
// before its first sample, so stream == framed == ring slot bitwise by
// construction. The FIR, Hann, FFT, untangle and power use explicit
// round-to-nearest intrinsics in the plain PyTorch version's order, so the
// power spectrum matches it bitwise; the mel sums run in another order than
// cuBLAS. mel_w is ~97% zeros; this kernel computes the dense product.
// No fast-math: log1pf stays IEEE.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;           // frames per tile, processed together
constexpr int kMaxTaps = 64;

// output selection bits (cuda.py keeps the same values)
constexpr int kOutFiltered = 1;
constexpr int kOutLogmel = 2;

struct Params {
  const float* x;
  long long slot_stride;
  long long frame_stride;
  int n_frames;
  int window;
  int block_frames;
  const float* taps;
  int n_taps;
  const float* hann;      // (fft_size,) periodic Hann
  const float* tw_re;     // (log2 m, m/2) Stockham twiddles, m = fft/2
  const float* tw_im;
  const float* untangle;  // (2, m) cos/sin(-2 pi k / fft)
  int fft_size;
  const float* mel_w;     // (m + 1, n_mels)
  int n_mels;
  float* out_filtered;    // (rows, window) or null
  float* out_logmel;      // (rows, n_mels) or null
  int* retired;           // frame counter (ring sweeps) or null
  int valid_rows;         // only rows below this count as retired
  int flags;
};

// dynamic shared memory: two ping-pong buffers of (re | im) planes of
// kTile x m floats each, then the mel partial sums (at most kThreads
// accumulators of kTile frames)
__host__ __device__ inline size_t smem_bytes(int fft_size) {
  const size_t m = size_t(fft_size) / 2;
  return 4 * (4 * kTile * m + size_t(kThreads) * kTile);
}

__global__ void __launch_bounds__(kThreads)
asr_graph_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float taps_s[kMaxTaps];

  const int S = p.window;
  const int N = p.fft_size;
  const int m = N / 2;
  const int tid = threadIdx.x;
  const int n_mels = p.n_mels;
  const int nq = kThreads / n_mels;               // bin ranges (>= 1)
  const int q = tid / n_mels, j = tid - q * n_mels;
  const int kchunk = (m + 1 + nq - 1) / nq;
  float* const buf0 = smem;
  float* const buf1 = smem + 2 * kTile * m;
  float* const partial = smem + 4 * kTile * m;     // (nq, kTile, n_mels)

  for (int i = tid; i < p.n_taps; i += kThreads) taps_s[i] = p.taps[i];
  __syncthreads();

  const bool need_mel = (p.flags & kOutLogmel) != 0;
  const int f_begin = blockIdx.x * p.block_frames;
  const int f_end = min(p.n_frames, f_begin + p.block_frames);
  const float* const slot = p.x + (long long)blockIdx.y * p.slot_stride;
  const long long slot_row = (long long)blockIdx.y * p.n_frames;

  for (int f0 = f_begin; f0 < f_end; f0 += kTile) {
    const int nv = min(kTile, f_end - f0);
    float* cr = buf0;
    float* ci = buf0 + kTile * m;

    // ---- FIR with zero history before each frame; Hann on the first
    // fft_size samples, packed: even samples -> re plane, odd -> im plane
    for (int idx = tid; idx < nv * S; idx += kThreads) {
      const int g = idx / S, t = idx - g * S;
      const float* src = slot + (long long)(f0 + g) * p.frame_stride;
      float acc = 0.f;
      for (int i = 0; i < p.n_taps; ++i) {
        const float xv = t - i >= 0 ? __ldg(src + t - i) : 0.f;
        acc = __fadd_rn(acc, __fmul_rn(taps_s[i], xv));
      }
      if (p.flags & kOutFiltered)
        p.out_filtered[(slot_row + f0 + g) * S + t] = acc;
      if (need_mel && t < N)
        ((t & 1) ? ci : cr)[g * m + (t >> 1)] =
            __fmul_rn(acc, __ldg(p.hann + t));
    }
    if (!need_mel) continue;      // uniform across the block
    __syncthreads();

    // ---- Stockham stages of the nv packed m-point transforms
    float* nr = buf1;
    float* ni = buf1 + kTile * m;
    const int h = m / 2;
    int stage = 0;
    for (int n = m, g = 1; n > 1; n >>= 1, g <<= 1, ++stage) {
      const int half = n >> 1;
      const float* wr = p.tw_re + (long long)stage * h;
      const float* wi = p.tw_im + (long long)stage * h;
      for (int b = tid; b < nv * h; b += kThreads) {
        const int fr = b / h, bf = b - fr * h;
        const int qq = bf / half, jj = bf - qq * half;
        const float* ar_ = cr + fr * m;
        const float* ai_ = ci + fr * m;
        const float ar = ar_[qq * n + jj], ai = ai_[qq * n + jj];
        const float br = ar_[qq * n + jj + half], bi = ai_[qq * n + jj + half];
        const float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
        const float w_r = __ldg(wr + jj), w_i = __ldg(wi + jj);
        nr[fr * m + qq * half + jj] = __fadd_rn(ar, br);
        ni[fr * m + qq * half + jj] = __fadd_rn(ai, bi);
        nr[fr * m + (g + qq) * half + jj] =
            __fsub_rn(__fmul_rn(dr, w_r), __fmul_rn(di, w_i));
        ni[fr * m + (g + qq) * half + jj] =
            __fadd_rn(__fmul_rn(dr, w_i), __fmul_rn(di, w_r));
      }
      __syncthreads();
      float* t0 = cr; cr = nr; nr = t0;
      float* t1 = ci; ci = ni; ni = t1;
    }

    // ---- untangle to m + 1 bins and |X|^2, into the free buffer
    // X[k] = (Z[k] + conj Z[-k])/2 - i/2 e^{-2 pi i k/N} (Z[k] - conj Z[-k])
    float* power = nr;                               // (kTile, m + 1)
    for (int idx = tid; idx < nv * (m + 1); idx += kThreads) {
      const int fr = idx / (m + 1), k = idx - fr * (m + 1);
      const float* zr_ = cr + fr * m;
      const float* zi_ = ci + fr * m;
      float xr, xi;
      if (k == m) {
        xr = __fsub_rn(zr_[0], zi_[0]);
        xi = 0.f;
      } else {
        const int ik = k == 0 ? 0 : m - k;
        const float zr = zr_[k], zi = zi_[k];
        const float zcr = zr_[ik], zci = -zi_[ik];
        const float er = __fmul_rn(__fadd_rn(zr, zcr), 0.5f);
        const float ei = __fmul_rn(__fadd_rn(zi, zci), 0.5f);
        const float o_r = __fmul_rn(__fsub_rn(zr, zcr), 0.5f);
        const float o_i = __fmul_rn(__fsub_rn(zi, zci), 0.5f);
        const float ur = __ldg(p.untangle + k), ui = __ldg(p.untangle + m + k);
        const float pr = __fsub_rn(__fmul_rn(ur, o_r), __fmul_rn(ui, o_i));
        const float pi = __fadd_rn(__fmul_rn(ur, o_i), __fmul_rn(ui, o_r));
        xr = __fadd_rn(er, pi);
        xi = __fsub_rn(ei, pr);
      }
      power[fr * (m + 1) + k] = __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
    }
    __syncthreads();

    // ---- mel product: thread (q, j) sums bins [q*kchunk, (q+1)*kchunk)
    // of column j for every frame of the tile, one mel_w read per bin
    if (q < nq) {
      float acc[kTile];
#pragma unroll
      for (int g = 0; g < kTile; ++g) acc[g] = 0.f;
      const int k0 = q * kchunk, k1 = min(m + 1, k0 + kchunk);
      for (int k = k0; k < k1; ++k) {
        const float w = __ldg(p.mel_w + (long long)k * n_mels + j);
#pragma unroll
        for (int g = 0; g < kTile; ++g)
          if (g < nv) acc[g] = fmaf(power[g * (m + 1) + k], w, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < kTile; ++g)
        partial[(q * kTile + g) * n_mels + j] = acc[g];
    }
    __syncthreads();
    for (int o = tid; o < nv * n_mels; o += kThreads) {
      const int g = o / n_mels, jj = o - g * n_mels;
      float s = partial[g * n_mels + jj];
      for (int qq = 1; qq < nq; ++qq)
        s = __fadd_rn(s, partial[(qq * kTile + g) * n_mels + jj]);
      p.out_logmel[(slot_row + f0 + g) * n_mels + jj] = log1pf(s);
    }
    __syncthreads();              // the next tile reuses every buffer
  }

  // ---- retire: count this block's valid frames once they are written
  if (p.retired != nullptr && tid == 0) {
    int done = 0;
    for (int f = f_begin; f < f_end; ++f) done += slot_row + f < p.valid_rows;
    if (done) atomicAdd(p.retired, done);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs for an fft_size-point spectrum.
size_t asr_graph_smem_bytes(int fft_size) { return smem_bytes(fft_size); }

const char* asr_graph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches the graph over n_slots x n_frames frames on `stream`, on the
// calling thread's current device; returns cudaGetLastError() after the
// launch (0 on success). Allocates nothing and does not synchronise. When
// `retired` is not null the kernel adds to it the frames it wrote among the
// first `valid_rows`.
int asr_graph_launch(const float* x, long long slot_stride,
                     long long frame_stride, int n_slots, int n_frames,
                     int window, int block_frames, const float* taps,
                     int n_taps, const float* hann, const float* tw_re,
                     const float* tw_im, const float* untangle, int fft_size,
                     const float* mel_w, int n_mels, float* out_filtered,
                     float* out_logmel, int* retired, int valid_rows,
                     int flags, void* stream) {
  const int m = fft_size / 2;
  if (n_taps < 1 || n_taps > kMaxTaps || n_mels < 1 || n_mels > kThreads ||
      n_slots < 1 || n_slots > 65535 || n_frames < 1 || block_frames < 1 ||
      fft_size < 4 || (m & (m - 1)) != 0 || fft_size > window ||
      (flags & (kOutFiltered | kOutLogmel)) == 0)
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
  p.hann = hann;
  p.tw_re = tw_re;
  p.tw_im = tw_im;
  p.untangle = untangle;
  p.fft_size = fft_size;
  p.mel_w = mel_w;
  p.n_mels = n_mels;
  p.out_filtered = out_filtered;
  p.out_logmel = out_logmel;
  p.retired = retired;
  p.valid_rows = valid_rows;
  p.flags = flags;
  const size_t smem = smem_bytes(fft_size);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        asr_graph_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_frames + block_frames - 1) / block_frames, n_slots);
  asr_graph_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
