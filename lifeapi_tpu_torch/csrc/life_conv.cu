// Torus convolutions of 64x64 boards, hand-written for Hopper (sm_90a).
// Built by lifeapi_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface and called through ctypes from
// lifeapi_tpu_torch/ops/conv_cuda.py, which holds each kernel's plain
// PyTorch twin.
//
// Board layout in device memory: int64[B, 64], one 64-bit word per column x,
// bit y = cell (x, y); dense fields are [B, 64, 64] indexed [x, y].
//
// Two kernel bodies:
//  * The peel (replaces lifeapi_tpu/ops/conv_sparse_pallas.py
//    conv_sparse_lohi and counts_sparse_lohi).  One warp per board, lane l
//    holding columns l and l + 32 (warp_board.cuh).  Each round peels the
//    first ON cell (x, y) of the runtime-sparse operand b: a ballot of the
//    non-empty columns and __ffs give x, a shuffle of that word and
//    __ffsll give y, the owning lane clears the bit.  Then a is translated
//    by (x, y): output column X takes a's column (X - x) mod 64, two
//    shuffles and a select on which register holds it, and each word
//    rotates left by y.  The shifted copy is OR-ed into an accumulator or
//    ripple-added into 13 counter planes.  Each warp loops until its own
//    operand is empty; OR and addition commute, so the peel order cannot
//    change the result.  Bound: shuffle and integer issue, about 6 shuffles
//    and 20 (OR) or 72 (13 counter planes) 64-bit ops per lane per peeled
//    cell; device memory sees each board once.  The TPU kernel loops per
//    128-lane tile until its densest operand is empty; here a sparse board
//    never waits on a dense one.
//  * The dense counts (replaces lifeapi_tpu/ops/conv_pallas.py
//    conv_counts_fused, conv_small_fused and conv_small_packed).  Exact
//    circular-convolution counts by bit-parallel AND + popcount on the
//    packed columns:
//        count[x][y] = sum_u popcount(a[u] & rotl(rev(b[(x - u) mod 64]), y + 1)).
//    One block of 256 threads per board, both boards' 1 KB of words in
//    shared memory (a doubled to 128 words so no index wraps).  Thread t
//    owns y = t % 64 and 16 consecutive x, so every shared read in the
//    inner loop is a broadcast.  The single-prime TPU kernels compute the
//    counts mod 193 (an NTT mod 193 is exact in that ring), which is the
//    residue of the exact count on every input, so one body serves all
//    three with an epilogue: exact int32 counts, count % 193 as int32 or as
//    an int8 mask of count % 193 != 0, or that mask packed to int64 words.
//    Bound: popcount issue (2 32-bit POPC per AND, 262,144 ANDs per board),
//    not bytes (8-32 KB per board).  The TPU ran a two-prime NTT as bf16
//    matmuls on its MXU; a tensor-core NTT on Hopper is a later redesign.

#include "warp_board.cuh"

namespace {

using warp_board::kFullMask;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;
constexpr int kMaxPlanes = 13;  // counts up to 8191; every count is <= 4096

__device__ __forceinline__ u64 rotl(u64 x, int k) {  // k in [0, 64)
  return (x << k) | (x >> ((64 - k) & 63));
}

// Peel the first ON cell (lowest column x, then lowest row y) of the warp's
// operand (r_lo, r_hi) and return a translated by (x, y) in (s_lo, s_hi).
// Returns false, warp-uniformly, once the operand is empty.
__device__ __forceinline__ bool peel(u64& r_lo, u64& r_hi, u64 a_lo, u64 a_hi,
                                     int lane, u64& s_lo, u64& s_hi) {
  const unsigned lo_nz = __ballot_sync(kFullMask, r_lo != 0);
  const unsigned hi_nz = __ballot_sync(kFullMask, r_hi != 0);
  if ((lo_nz | hi_nz) == 0) return false;
  const bool in_lo = lo_nz != 0;
  const int src = __ffs(in_lo ? lo_nz : hi_nz) - 1;
  const int x = in_lo ? src : src + 32;
  const u64 w = __shfl_sync(kFullMask, in_lo ? r_lo : r_hi, src);
  const int y = __ffsll(static_cast<long long>(w)) - 1;
  if (lane == src) {
    if (in_lo) r_lo &= r_lo - 1;
    else r_hi &= r_hi - 1;
  }
  // output column lane takes a's column c = (lane - x) mod 64, and column
  // lane + 32 takes c ^ 32: both live in lane c % 32, in swapped registers
  // when c >= 32
  const int c = (lane - x) & 63;
  const u64 v_lo = __shfl_sync(kFullMask, a_lo, c & 31);
  const u64 v_hi = __shfl_sync(kFullMask, a_hi, c & 31);
  const bool swap = c >= 32;
  s_lo = rotl(swap ? v_hi : v_lo, y);
  s_hi = rotl(swap ? v_lo : v_hi, y);
  return true;
}

// Replaces conv_sparse_pallas.conv_sparse_lohi (_conv_sparse_kernel): the
// OR of a translated by every ON cell of b.
__global__ void __launch_bounds__(kThreadsPerBlock)
conv_sparse_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                   u64* __restrict__ out, int B) {
  const int lane = threadIdx.x & 31;
  const int board = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (board >= B) return;
  const size_t at = static_cast<size_t>(board) * 64 + lane;
  const u64 a_lo = a[at], a_hi = a[at + 32];
  u64 r_lo = b[at], r_hi = b[at + 32];
  u64 acc_lo = 0, acc_hi = 0, s_lo, s_hi;
  while (peel(r_lo, r_hi, a_lo, a_hi, lane, s_lo, s_hi)) {
    acc_lo |= s_lo;
    acc_hi |= s_hi;
  }
  out[at] = acc_lo;
  out[at + 32] = acc_hi;
}

// Replaces conv_sparse_pallas.counts_sparse_lohi (_counts_sparse_kernel):
// the same peel, each shifted copy ripple-added into 13 bit-sliced counter
// planes; the low n_planes are written to out [n_planes, B, 64], which are
// the counts mod 2^n_planes as the TPU kernel's n_planes-wide counter.
__global__ void __launch_bounds__(kThreadsPerBlock)
counts_sparse_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                     u64* __restrict__ out, int B, int n_planes) {
  const int lane = threadIdx.x & 31;
  const int board = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (board >= B) return;
  const size_t at = static_cast<size_t>(board) * 64 + lane;
  const u64 a_lo = a[at], a_hi = a[at + 32];
  u64 r_lo = b[at], r_hi = b[at + 32];
  u64 p_lo[kMaxPlanes], p_hi[kMaxPlanes];
#pragma unroll
  for (int i = 0; i < kMaxPlanes; ++i) p_lo[i] = p_hi[i] = 0;
  u64 c_lo, c_hi;
  while (peel(r_lo, r_hi, a_lo, a_hi, lane, c_lo, c_hi)) {
#pragma unroll
    for (int i = 0; i < kMaxPlanes; ++i) {
      const u64 t_lo = p_lo[i] & c_lo, t_hi = p_hi[i] & c_hi;  // carries
      p_lo[i] ^= c_lo;
      p_hi[i] ^= c_hi;
      c_lo = t_lo;
      c_hi = t_hi;
    }
  }
  const size_t plane = static_cast<size_t>(B) * 64;
#pragma unroll
  for (int i = 0; i < kMaxPlanes; ++i) {
    if (i < n_planes) {
      out[i * plane + at] = p_lo[i];
      out[i * plane + at + 32] = p_hi[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Dense counts
// ---------------------------------------------------------------------------

constexpr int kXPerThread = 16;  // 256 threads = 64 rows y x 4 groups of 16 x
constexpr int kModulus = 193;    // the TPU single-prime kernels' prime

enum Epilogue {
  kCounts = 0,        // int32 [B, 64, 64] exact counts (conv_counts_fused)
  kResidue = 1,       // int32 count % 193 (conv_small_fused, out_or=False)
  kResidueMask = 2,   // int8 count % 193 != 0 (conv_small_fused, out_or=True)
  kResiduePacked = 3  // that mask as int64 [B, 64] (conv_small_packed)
};

// Load one board into 64 words of shared memory: packed int64 [64], or
// dense bytes [64, 64] (non-zero = ON) packed by ballots, warp w taking
// columns 8w .. 8w + 7.
template <bool kPacked>
__device__ __forceinline__ void load_board(const void* src, size_t board,
                                           u64* dst) {
  if (kPacked) {
    if (threadIdx.x < 64)
      dst[threadIdx.x] = static_cast<const u64*>(src)[board * 64 + threadIdx.x];
    return;
  }
  const unsigned char* cells = static_cast<const unsigned char*>(src) + board * 4096;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* halves = reinterpret_cast<unsigned*>(dst);
  for (int x = warp * 8; x < warp * 8 + 8; ++x) {
    for (int h = 0; h < 2; ++h) {
      const unsigned bits = __ballot_sync(kFullMask, cells[x * 64 + h * 32 + lane] != 0);
      if (lane == 0) halves[2 * x + h] = bits;  // little-endian: y 0..31 first
    }
  }
}

template <bool kPacked, int kEpilogue>
__global__ void __launch_bounds__(kThreadsPerBlock)
conv_dense_kernel(const void* __restrict__ a, const void* __restrict__ b,
                  void* __restrict__ out) {
  __shared__ u64 sa[128];  // a's columns twice: sa[j] = a[j % 64]
  __shared__ u64 sb[64];   // rev(b[c])
  const size_t board = blockIdx.x;
  load_board<kPacked>(a, board, sa);
  load_board<kPacked>(b, board, sb);
  __syncthreads();
  if (threadIdx.x < 64) {
    sa[threadIdx.x + 64] = sa[threadIdx.x];
    sb[threadIdx.x] = __brevll(sb[threadIdx.x]);
  }
  __syncthreads();

  const int y = threadIdx.x & 63;
  const int x0 = (threadIdx.x >> 6) * kXPerThread;
  const int k = (y + 1) & 63;
  int acc[kXPerThread];
#pragma unroll
  for (int i = 0; i < kXPerThread; ++i) acc[i] = 0;
  for (int c = 0; c < 64; ++c) {
    // count[x][y] += popcount(a[x - c] & rotl(rev(b[c]), y + 1))
    const u64 r = rotl(sb[c], k);
    const u64* col = sa + (x0 - c + 64);
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) acc[i] += __popcll(col[i] & r);
  }

  const size_t cell0 = board * 4096 + static_cast<size_t>(x0) * 64 + y;
#pragma unroll
  for (int i = 0; i < kXPerThread; ++i) {
    const int v = kEpilogue == kCounts ? acc[i] : acc[i] % kModulus;
    if (kEpilogue == kCounts || kEpilogue == kResidue) {
      static_cast<int*>(out)[cell0 + i * 64] = v;
    } else if (kEpilogue == kResidueMask) {
      static_cast<signed char*>(out)[cell0 + i * 64] = v != 0;
    } else {
      // a warp holds 32 consecutive rows of one column: one ballot is the
      // column word's low (rows 0-31) or high (32-63) half
      const unsigned bits = __ballot_sync(kFullMask, v != 0);
      if ((threadIdx.x & 31) == 0)
        static_cast<unsigned*>(out)[(board * 64 + x0 + i) * 2 + (y >> 5)] = bits;
    }
  }
}

inline dim3 warp_grid(int B) { return dim3((B + kWarpsPerBlock - 1) / kWarpsPerBlock); }

template <bool kPacked, int kEpilogue>
cudaError_t launch_dense(const void* a, const void* b, void* out, int B,
                         cudaStream_t stream) {
  if (B <= 0) return cudaErrorInvalidValue;
  conv_dense_kernel<kPacked, kEpilogue><<<B, kThreadsPerBlock, 0, stream>>>(a, b, out);
  return cudaGetLastError();
}

}  // namespace

// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return the launch's cudaError_t (0 on success).  B > 0.

extern "C" cudaError_t life_conv_sparse(const u64* a, const u64* b, u64* out,
                                        int B, cudaStream_t stream) {
  if (B <= 0) return cudaErrorInvalidValue;
  conv_sparse_kernel<<<warp_grid(B), kThreadsPerBlock, 0, stream>>>(a, b, out, B);
  return cudaGetLastError();
}

extern "C" cudaError_t life_counts_sparse(const u64* a, const u64* b, u64* out,
                                          int B, int n_planes,
                                          cudaStream_t stream) {
  if (B <= 0 || n_planes < 1 || n_planes > kMaxPlanes) return cudaErrorInvalidValue;
  counts_sparse_kernel<<<warp_grid(B), kThreadsPerBlock, 0, stream>>>(a, b, out, B,
                                                                        n_planes);
  return cudaGetLastError();
}

// a, b: dense bytes [B, 64, 64]; out: int32 [B, 64, 64] exact counts.
extern "C" cudaError_t life_conv_counts(const void* a, const void* b, int* out,
                                        int B, cudaStream_t stream) {
  return launch_dense<false, kCounts>(a, b, out, B, stream);
}

// a, b: dense bytes [B, 64, 64]; out: int8 [B, 64, 64] count % 193 != 0
// when out_or, else int32 [B, 64, 64] count % 193.
extern "C" cudaError_t life_conv_small(const void* a, const void* b, void* out,
                                       int B, int out_or, cudaStream_t stream) {
  return out_or ? launch_dense<false, kResidueMask>(a, b, out, B, stream)
                : launch_dense<false, kResidue>(a, b, out, B, stream);
}

// a, b, out: int64 [B, 64]; out = the boards of count % 193 != 0.
extern "C" cudaError_t life_conv_small_packed(const u64* a, const u64* b, u64* out,
                                              int B, cudaStream_t stream) {
  return launch_dense<true, kResiduePacked>(a, b, out, B, stream);
}
