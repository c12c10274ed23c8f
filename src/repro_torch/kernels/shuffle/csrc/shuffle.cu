// The VWR2A shuffle unit over the rows of (R, N) arrays A and B as one CUDA
// kernel for Hopper (sm_90a), bound to PyTorch through a plain C interface
// (kernels/shuffle/kernel.py). Each output word of a row takes one word of
// concat(A[r], B[r]) at a source index computed arithmetically:
//
//     interleave      j = (p & 1) * N + (p >> 1)
//     prune           j = 2 i + comp  (comp 1 keeps odd words), over A then B
//     bit_reverse     j = brev(p) >> (32 - log2 2N)
//     circular_shift  j = (p - amount) mod 2N
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
// and B is read once and each output word written once, so it is byte-
// bound (3.35 TB/s).
//
// What the design does about it. A block of 256 threads owns one tile of
// 2048 consecutive output words of the flattened (R, out_n) result, so
// every write of a warp is one coalesced 128- or 64-byte line; the reads
// are gathers inside the same one or two rows, which the block's
// neighbouring threads share through L1 and L2. The row and column of a
// word come from one 64-bit division per block and 32-bit arithmetic per
// word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;             // output words per block

enum Op { kInterleave = 0, kPruneEven = 1, kPruneOdd = 2, kBitReverse = 3,
          kCircularShift = 4 };

template <typename W>
__global__ void __launch_bounds__(kThreads)
shuffle_kernel(const W* __restrict__ a, const W* __restrict__ b,
               W* __restrict__ out, long long total, int N, int out_n,
               int op, int off, int amount, int log2_2n) {
  const long long e0 = (long long)blockIdx.x * kTile;
  const long long r0 = e0 / out_n;
  const unsigned i0 = (unsigned)(e0 - r0 * out_n);
  const unsigned n2 = 2u * (unsigned)N;
  const unsigned half = (unsigned)N >> 1;
  for (int o = threadIdx.x; o < kTile; o += kThreads) {
    if (e0 + o >= total) break;
    const unsigned ii = i0 + (unsigned)o;
    const long long r = r0 + ii / (unsigned)out_n;
    const unsigned i = ii % (unsigned)out_n;
    const unsigned p = i + (unsigned)off;
    unsigned j;
    switch (op) {
      case kInterleave:
        j = (p & 1u) * (unsigned)N + (p >> 1);
        break;
      case kPruneEven:
      case kPruneOdd: {
        const unsigned comp = op == kPruneEven ? 1u : 0u;
        j = i < half ? 2u * i + comp : (unsigned)N + 2u * (i - half) + comp;
        break;
      }
      case kBitReverse:
        j = __brev(p) >> (32 - log2_2n);
        break;
      default:                                    // kCircularShift
        j = (p + n2 - (unsigned)amount) % n2;
        break;
    }
    const long long row = r * N;
    out[e0 + o] = j < (unsigned)N ? a[row + j] : b[row + (j - N)];
  }
}

template <typename W>
cudaError_t launch(const void* a, const void* b, void* out, long long R,
                   int N, int out_n, int op, int off, int amount,
                   int log2_2n, cudaStream_t stream) {
  const long long total = R * out_n;
  const long long blocks = (total + kTile - 1) / kTile;
  shuffle_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(a), static_cast<const W*>(b),
      static_cast<W*>(out), total, N, out_n, op, off, amount, log2_2n);
  return cudaGetLastError();
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
// (bit_reverse only). Returns cudaGetLastError() after the launch (0 on
// success). Allocates nothing and does not synchronise.
int shuffle_launch(const void* a, const void* b, void* out, long long R,
                   int N, int out_n, int op, int off, int amount,
                   int log2_2n, int elem_bytes, void* stream) {
  if (R < 1 || N < 1 || N > (1 << 29) || out_n < 1 || out_n > 2 * N ||
      op < kInterleave || op > kCircularShift || off < 0 ||
      off + out_n > 2 * N || amount < 0 || amount >= 2 * N ||
      (op == kBitReverse && (log2_2n < 1 || (1 << log2_2n) != 2 * N)) ||
      ((op == kPruneEven || op == kPruneOdd) && (N & 1)) ||
      (R * out_n + kTile - 1) / kTile > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem_bytes == 4)
    err = launch<uint32_t>(a, b, out, R, N, out_n, op, off, amount, log2_2n,
                           st);
  else if (elem_bytes == 2)
    err = launch<uint16_t>(a, b, out, R, N, out_n, op, off, amount, log2_2n,
                           st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
