// The VWR2A shuffle unit over the rows of (R, N) arrays A and B as one CUDA
// kernel for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (kernels/shuffle/kernel.py). Each output word of a row takes one word of
// concat(A[r], B[r]) at a source index computed arithmetically:
//
//     interleave      j = (p & 1) * N + (p >> 1)
//     prune           j = 2 i + comp  (comp 1 keeps odd words), over A then B
//     bit_reverse     j = brev(p) >> (32 - log2 2N)
//     circular_shift  j = p - amount, plus 2N where that is negative
//
// with p = i, or i + N for the upper half. A pure permutation: the kernel
// copies 2- or 4-byte words and never converts them, so the result is
// bitwise the plain PyTorch version's (core/shuffle.py) for every dtype of
// those sizes (float32, bfloat16, int32).
//
// Replaces shuffle_pallas of src/repro/kernels/shuffle/kernel.py:74 (body
// shuffle_kernel :49, pallas_call :86), which stages a block of rows of A
// and B in VMEM and permutes them with lane reshapes, gather-free.
//
// What bounds it on this card. No arithmetic on the data: each word of A
// and B that an output takes is read once and each output word written
// once, so it is byte-bound (3.35 TB/s).
//
// What the design does about it. A block owns `rows` whole rows. The words
// of each row of A and B that its output takes (all of them, or for the
// interleave and the shift of one half, the one run of each that the half
// takes: half the bytes) are copied into shared memory with 16-byte
// cp.async copies; then each thread writes 16-byte vectors of the block's output
// rows (one contiguous span), every word read from shared memory at its
// row-local source index. A thread's vector and row come from one
// division at its start and advance by constant steps; the permutation is
// an op fixed at compile time, with no division or modulo per word. Rows
// too wide for the block's shared memory are read from device memory in
// place (`kStaged` false). Rows or bases that 16-byte vectors do not tile
// take the same in-place walk with single-word copies: staging words one
// at a time would move the same bytes behind an extra barrier. The prunes
// and the bit reversal take every other word of a row, so they read every
// byte of A and B: a third more than the bound counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 48 * 1024;  // most shared memory a block stages

enum Op { kInterleave = 0, kPruneEven = 1, kPruneOdd = 2, kBitReverse = 3,
          kCircularShift = 4 };

// the source index in concat(A[r], B[r]) of output word i (p = i + off)
template <int kOp>
__device__ __forceinline__ int source(int i, int off, int N, int amount,
                                      int log2_2n) {
  const int p = i + off;
  if constexpr (kOp == kInterleave) {
    return (p & 1) * N + (p >> 1);
  } else if constexpr (kOp == kPruneEven || kOp == kPruneOdd) {
    const int comp = kOp == kPruneEven ? 1 : 0;
    const int half = N >> 1;
    return i < half ? 2 * i + comp : N + 2 * (i - half) + comp;
  } else if constexpr (kOp == kBitReverse) {
    return (int)(__brev((unsigned)p) >> (32 - log2_2n));
  } else {
    const int j = p - amount;
    return j < 0 ? j + 2 * N : j;
  }
}

// Copy words [lo, lo + n) of rows r0 .. r0 + nr - 1 of an (R, N) array
// into dst, n words a row, by 16-byte cp.async copies of VE words (to be
// waited for): thread t starts at copy t % units of row t / units and
// steps by nthreads copies.
template <typename W, int VE>
__device__ __forceinline__ void stage(const W* __restrict__ src,
                                      W* __restrict__ dst, long long r0,
                                      int nr, int N, int lo, int n) {
  if (n == 0) return;
  const int units = n / VE;
  int k = threadIdx.x / units, u = threadIdx.x - k * units;
  const int dk = blockDim.x / units, du = blockDim.x - dk * units;
  while (k < nr) {
    const W* s = src + (r0 + k) * N + lo + u * VE;
    W* d = dst + k * n + u * VE;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                 "r"((unsigned)__cvta_generic_to_shared(d)), "l"(s));
    u += du;
    k += dk;
    if (u >= units) {
      u -= units;
      ++k;
    }
  }
}

// W: the word (2 or 4 bytes); kVec: 16-byte copies (the rows of A, B and
// the output whole vectors, the bases aligned), else one word a copy;
// kStaged (with kVec only): the block's rows of A and B in shared memory,
// words [a_lo, a_lo + a_n) of A and [b_lo, b_lo + b_n) of B (the words the
// output takes, whole vectors), else read in place (the ranges then whole
// rows).
template <typename W, int kOp, bool kVec, bool kStaged>
__global__ void __launch_bounds__(kThreads)
shuffle_kernel(const W* __restrict__ a, const W* __restrict__ b,
               W* __restrict__ out, long long R, int N, int out_n, int off,
               int amount, int log2_2n, int a_lo, int a_n, int b_lo,
               int b_n, int rows) {
  static_assert(kVec || !kStaged, "only 16-byte copies are staged");
  constexpr int VE = kVec ? 16 / (int)sizeof(W) : 1;   // words a copy
  extern __shared__ uint4 smem[];
  const long long r0 = (long long)blockIdx.x * rows;
  const int nr = (int)min((long long)rows, R - r0);
  W* const sa = reinterpret_cast<W*>(smem);
  W* const sb = sa + rows * a_n;           // rows * a_n words: whole vectors
  if constexpr (kStaged) {
    stage<W, VE>(a, sa, r0, nr, N, a_lo, a_n);
    stage<W, VE>(b, sb, r0, nr, N, b_lo, b_n);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  }
  // the output: row k of the block, vector u of the row
  const int units = out_n / VE;
  int k = threadIdx.x / units, u = threadIdx.x - k * units;
  const int dk = blockDim.x / units, du = blockDim.x - dk * units;
  while (k < nr) {
    const W* ra = kStaged ? sa + k * a_n : a + (r0 + k) * N + a_lo;
    const W* rb = kStaged ? sb + k * b_n : b + (r0 + k) * N + b_lo;
    W w[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int j = source<kOp>(u * VE + e, off, N, amount, log2_2n);
      w[e] = j < N ? ra[j - a_lo] : rb[j - N - b_lo];
    }
    W* dst = out + (r0 + k) * out_n + u * VE;
    if constexpr (kVec) {
      uint4 v;
      memcpy(&v, w, 16);
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      dst[0] = w[0];
    }
    u += du;
    k += dk;
    if (u >= units) {
      u -= units;
      ++k;
    }
  }
}

template <typename W, int kOp, bool kVec, bool kStaged>
cudaError_t launch(const void* a, const void* b, void* out, long long R,
                   int N, int out_n, int off, int amount, int log2_2n,
                   const int* ranges, int rows, int threads,
                   cudaStream_t stream) {
  const long long blocks = (R + rows - 1) / rows;
  const size_t smem =
      kStaged ? sizeof(W) * (size_t)rows * (ranges[1] + ranges[3]) : 0;
  shuffle_kernel<W, kOp, kVec, kStaged>
      <<<(unsigned)blocks, threads, smem, stream>>>(
          static_cast<const W*>(a), static_cast<const W*>(b),
          static_cast<W*>(out), R, N, out_n, off, amount, log2_2n,
          ranges[0], ranges[1], ranges[2], ranges[3], rows);
  return cudaGetLastError();
}

template <typename W, int kOp>
cudaError_t launch_op(bool vec, bool staged, const void* a, const void* b,
                      void* out, long long R, int N, int out_n, int off,
                      int amount, int log2_2n, const int* ranges, int rows,
                      int threads, cudaStream_t st) {
  if (vec && staged)
    return launch<W, kOp, true, true>(a, b, out, R, N, out_n, off, amount,
                                      log2_2n, ranges, rows, threads, st);
  if (vec)
    return launch<W, kOp, true, false>(a, b, out, R, N, out_n, off, amount,
                                       log2_2n, ranges, rows, threads, st);
  return launch<W, kOp, false, false>(a, b, out, R, N, out_n, off, amount,
                                      log2_2n, ranges, rows, threads, st);
}

template <typename W>
cudaError_t launch_word(int op, bool vec, bool staged, const void* a,
                        const void* b, void* out, long long R, int N,
                        int out_n, int off, int amount, int log2_2n,
                        const int* ranges, int rows, int threads,
                        cudaStream_t st) {
  switch (op) {
    case kInterleave:
      return launch_op<W, kInterleave>(vec, staged, a, b, out, R, N, out_n,
                                       off, amount, log2_2n, ranges, rows,
                                       threads, st);
    case kPruneEven:
      return launch_op<W, kPruneEven>(vec, staged, a, b, out, R, N, out_n,
                                      off, amount, log2_2n, ranges, rows,
                                      threads, st);
    case kPruneOdd:
      return launch_op<W, kPruneOdd>(vec, staged, a, b, out, R, N, out_n,
                                     off, amount, log2_2n, ranges, rows,
                                     threads, st);
    case kBitReverse:
      return launch_op<W, kBitReverse>(vec, staged, a, b, out, R, N, out_n,
                                       off, amount, log2_2n, ranges, rows,
                                       threads, st);
    default:
      return launch_op<W, kCircularShift>(vec, staged, a, b, out, R, N,
                                          out_n, off, amount, log2_2n,
                                          ranges, rows, threads, st);
  }
}

}  // namespace

extern "C" {

const char* shuffle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[r, i] = concat(a[r], b[r])[j(i)] for row-major (R, N) a and b and an
// (R, out_n) out of `elem_bytes`-byte words (2 or 4) on `stream`, on the
// calling thread's current device. `op` is one of Op; `off` is 0, or N for
// the upper half; `amount` the shift in [0, 2N); `log2_2n` is log2(2N)
// (bit_reverse only). The launch geometry comes from the host
// (kernel.py:shuffle_geometry): `vec` 1 for 16-byte copies, which need
// `misalign` = (a | b | out) % 16 to be 0, N * elem_bytes a multiple of 16
// and the ranges whole vectors; `staged` 1 (with `vec` only) to stage
// words [a_lo, a_lo + a_n) of each row of A and [b_lo, b_lo + b_n) of B,
// which must hold every word the output takes, `rows` rows a block, in at
// most kStageBytes (else the rows are read in place and the ranges must be
// whole rows);
// `threads` a block. Returns cudaGetLastError() after the launch (0 on
// success). Allocates nothing and does not synchronise.
int shuffle_launch(const void* a, const void* b, void* out, long long R,
                   int N, int out_n, int op, int off, int amount,
                   int log2_2n, int elem_bytes, int vec, int misalign,
                   int staged, int a_lo, int a_n, int b_lo, int b_n,
                   int rows, int threads, void* stream) {
  const int ve = vec ? 16 / (elem_bytes ? elem_bytes : 1) : 1;
  if (R < 1 || N < 1 || N > (1 << 29) || out_n < 1 || out_n > 2 * N ||
      op < kInterleave || op > kCircularShift || off < 0 ||
      off + out_n > 2 * N || amount < 0 || amount >= 2 * N ||
      (op == kBitReverse && (log2_2n < 1 || (1 << log2_2n) != 2 * N)) ||
      ((op == kPruneEven || op == kPruneOdd) && (N & 1)) ||
      (elem_bytes != 2 && elem_bytes != 4) || rows < 1 || threads < 1 ||
      threads > kThreads || (R + rows - 1) / rows > 0x7fffffffLL ||
      a_lo < 0 || a_n < 0 || a_lo + a_n > N || b_lo < 0 || b_n < 0 ||
      b_lo + b_n > N || (a_lo | a_n | b_lo | b_n) % ve ||
      (staged && !vec) ||
      (!staged && (a_lo || b_lo || a_n != N || b_n != N)) ||
      (staged && (long long)elem_bytes * rows * (a_n + b_n) > kStageBytes) ||
      (long long)rows * out_n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (misalign != 0 || (N * elem_bytes) % 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int ranges[4] = {a_lo, a_n, b_lo, b_n};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      elem_bytes == 4
          ? launch_word<uint32_t>(op, vec, staged, a, b, out, R, N, out_n,
                                  off, amount, log2_2n, ranges, rows,
                                  threads, st)
          : launch_word<uint16_t>(op, vec, staged, a, b, out, R, N, out_n,
                                  off, amount, log2_2n, ranges, rows,
                                  threads, st);
  return static_cast<int>(err);
}

}  // extern "C"
