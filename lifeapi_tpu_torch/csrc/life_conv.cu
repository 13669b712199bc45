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
//    conv_sparse_lohi and counts_sparse_lohi), and the union of the peels of
//    up to 8 pairs (what lifeapi_tpu/core/convolve.py union_interacting
//    computes with method="sparse", around conv_sparse_lohi): described
//    where they are defined below.
//  * The dense counts as a tensor-core NTT (replaces
//    lifeapi_tpu/ops/conv_pallas.py conv_counts_fused, conv_small_fused and
//    conv_small_packed): ntt_conv_kernel, described where it is defined
//    below; the packed mode reads and writes int64 boards.

#include <cuda_bf16.h>

#include "warp_board.cuh"

namespace {

using warp_board::cp_async16;
using warp_board::cp_async_commit;
using warp_board::kFullMask;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;

// ---------------------------------------------------------------------------
// The peel (replaces conv_sparse_pallas.conv_sparse_lohi and
// counts_sparse_lohi; and core/convolve.py union_interacting's stacked call)
// ---------------------------------------------------------------------------
//
// out = the OR (or the count) of a translated by every ON cell (x, y) of the
// runtime-sparse operand b: output column X takes a's column (X - x) mod 64
// rotated left by y.  One warp a board, lane l holding columns l and l + 32
// (warp_board.cuh) of each operand.
//
// The TPU kernel peels one cell a round: find the first ON cell, clear it,
// translate, and loop until the densest operand of its tile is empty, each
// round waiting on the last.  Here a warp first lists b's cells and then
// runs the rounds, which no longer depend on one another:
//  * listing: each lane counts its cells (__popcll), the warp takes an
//    exclusive scan of the counts, and each lane writes its cells to the
//    warp's list in shared memory at its offset, kChunk cells at a time, so
//    that a dense b (up to 4096 cells) stays exact in a fixed budget;
//  * staging: a's columns go to shared memory twice over (columns c and
//    c + 64, so (X - x) mod 64 needs no wrap), and again with each word's
//    halves swapped (a rotated by 32);
//  * a round is a broadcast read of the cell's entry (the table offset of
//    column -x, in the swapped table when y >= 32, and y), two conflict-free
//    64-bit reads of the lane's two columns, four funnel shifts (the rotate
//    by y mod 32) and the accumulation; kUnroll rounds run side by side.
// Bound: device memory sees each board once (1 KB in, 512 B out a pair of
// boards, or 13 counter planes out); a round costs about 11 warp
// instructions a cell (OR; 36 with the 13 planes), five shared-memory
// wavefronts among them, so at the bench's 7 cells a board the bytes bound
// it.  The counts add the four copies of a step into the 13 planes at once,
// first summed into 3 bits by carry-save adders.  Reading a's columns by
// shuffles instead of the table measured 12-17% slower on an H100.

constexpr int kMaxPlanes = 13;  // counts up to 8191; every count is <= 4096
constexpr int kChunk = 64;      // cells a warp lists at a time
constexpr int kUnroll = 4;      // rounds side by side: the accumulations take four
constexpr int kMaxPairs = 8;    // pairs of the union

struct PeelSmem {
  u64 table[2][128];    // a's columns c mod 64; then the same, halves swapped
  uint2 cells[kChunk];  // (byte offset of column -x in table, y)
};

__device__ __forceinline__ u64 rotl_mod32(u64 v, unsigned s) {  // by s mod 32
  const unsigned lo = static_cast<unsigned>(v), hi = static_cast<unsigned>(v >> 32);
  return (static_cast<u64>(__funnelshift_l(lo, hi, s)) << 32) | __funnelshift_l(hi, lo, s);
}

__device__ __forceinline__ u64 swap_halves(u64 v) { return (v << 32) | (v >> 32); }

// a into the warp's table (every lane must have finished reading the last).
__device__ __forceinline__ void stage(PeelSmem& s, u64 a_lo, u64 a_hi, int lane) {
  s.table[0][lane] = s.table[0][lane + 64] = a_lo;
  s.table[0][lane + 32] = s.table[0][lane + 96] = a_hi;
  s.table[1][lane] = s.table[1][lane + 64] = swap_halves(a_lo);
  s.table[1][lane + 32] = s.table[1][lane + 96] = swap_halves(a_hi);
}

// The lane's cells of index [start, start + kChunk) into the list: i is the
// lane's next index, (r_lo, r_hi) its cells not yet listed.  Column x holds
// the table's offset of column -x: lane - x + 64 is in [1, 95] for column
// lane and lane - x + 96 in [33, 127] for column lane + 32.
__device__ __forceinline__ void list_cells(u64& r_lo, u64& r_hi, int& i, int start, int lane,
                                           uint2* cells) {
  const int end = start + kChunk;
  for (; i < end && r_lo != 0; ++i, r_lo &= r_lo - 1) {
    const int y = __ffsll(static_cast<long long>(r_lo)) - 1;
    cells[i - start] = make_uint2(8 * (64 - lane) + ((y & 32) << 5), y);
  }
  for (; i < end && r_hi != 0; ++i, r_hi &= r_hi - 1) {
    const int y = __ffsll(static_cast<long long>(r_hi)) - 1;
    cells[i - start] = make_uint2(8 * (32 - lane) + ((y & 32) << 5), y);
  }
}

// Calls rounds(n) for each chunk of n <= kChunk listed cells of the warp's
// operand (r_lo, r_hi).
template <class Rounds>
__device__ __forceinline__ void for_each_chunk(u64 r_lo, u64 r_hi, int lane, uint2* cells,
                                               Rounds&& rounds) {
  const int own = __popcll(r_lo) + __popcll(r_hi);
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += t;
  }
  const int total = __shfl_sync(kFullMask, incl, 31);
  int i = incl - own;
  for (int start = 0; start < total; start += kChunk) {
    __syncwarp();  // the last chunk's rounds have read the list
    list_cells(r_lo, r_hi, i, start, lane, cells);
    __syncwarp();
    rounds(min(total - start, kChunk));
  }
}

// a translated by one listed cell: the lane's output columns lane, lane + 32.
__device__ __forceinline__ void translate(const unsigned char* lane_table, uint2 cell,
                                          u64& s_lo, u64& s_hi) {
  const unsigned char* p = lane_table + cell.x;
  s_lo = rotl_mod32(*reinterpret_cast<const u64*>(p), cell.y);
  s_hi = rotl_mod32(*reinterpret_cast<const u64*>(p + 256), cell.y);
}

__device__ __forceinline__ const unsigned char* lane_table(const PeelSmem& s, int lane) {
  return reinterpret_cast<const unsigned char*>(s.table) + 8 * lane;
}

// a translated by every cell of b, the copies handed to the accumulators:
// acc4(lo, hi) takes kUnroll copies of the lane's two columns at a time,
// acc1(lo, hi) one copy of the chunk's remainder.
template <class Acc4, class Acc1>
__device__ __forceinline__ void peel_rounds(PeelSmem& s, u64 a_lo, u64 a_hi, u64 b_lo,
                                            u64 b_hi, int lane, Acc4&& acc4, Acc1&& acc1) {
  __syncwarp();  // every lane has read the last table
  stage(s, a_lo, a_hi, lane);
  const unsigned char* lt = lane_table(s, lane);
  for_each_chunk(b_lo, b_hi, lane, s.cells, [&](int n) {
    int k = 0;
    for (; k + kUnroll <= n; k += kUnroll) {
      u64 lo[kUnroll], hi[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) translate(lt, s.cells[k + j], lo[j], hi[j]);
      acc4(lo, hi);
    }
    for (; k < n; ++k) {
      u64 lo, hi;
      translate(lt, s.cells[k], lo, hi);
      acc1(lo, hi);
    }
  });
}

// The OR of a translated by every cell of b into (acc_lo, acc_hi).
__device__ __forceinline__ void peel_or(PeelSmem& s, u64 a_lo, u64 a_hi, u64 b_lo, u64 b_hi,
                                        int lane, u64& acc_lo, u64& acc_hi) {
  peel_rounds(
      s, a_lo, a_hi, b_lo, b_hi, lane,
      [&](const u64 (&lo)[kUnroll], const u64 (&hi)[kUnroll]) {
        acc_lo |= (lo[0] | lo[1]) | (lo[2] | lo[3]);
        acc_hi |= (hi[0] | hi[1]) | (hi[2] | hi[3]);
      },
      [&](u64 lo, u64 hi) {
        acc_lo |= lo;
        acc_hi |= hi;
      });
}

// One shifted copy c added into the bit-sliced counter planes p.
__device__ __forceinline__ void add_copy(u64 (&p)[kMaxPlanes], u64 c) {
#pragma unroll
  for (int i = 0; i < kMaxPlanes; ++i) {
    const u64 carry = p[i] & c;
    p[i] ^= c;
    c = carry;
  }
}

// Four shifted copies added into the planes: a carry-save adder sums them
// into 3 bits (b0 + 2 b1 + 4 b2 <= 4), which then ripple in.
__device__ __forceinline__ void add_copies4(u64 (&p)[kMaxPlanes], u64 c0, u64 c1, u64 c2,
                                            u64 c3) {
  const u64 s = c0 ^ c1 ^ c2, major = (c0 & c1) | (c2 & (c0 ^ c1));
  const u64 b0 = s ^ c3, k = s & c3;
  const u64 b1 = major ^ k, b2 = major & k;
  u64 carry = p[0] & b0;
  p[0] ^= b0;
  u64 t = p[1] ^ b1, next = (p[1] & b1) | (t & carry);
  p[1] = t ^ carry;
  carry = next;
  t = p[2] ^ b2;
  next = (p[2] & b2) | (t & carry);
  p[2] = t ^ carry;
  carry = next;
#pragma unroll
  for (int i = 3; i < kMaxPlanes; ++i) {
    next = p[i] & carry;
    p[i] ^= carry;
    carry = next;
  }
}

__device__ __forceinline__ size_t lane_word(int board, int lane) {
  return static_cast<size_t>(board) * 64 + lane;
}

// Replaces conv_sparse_pallas.conv_sparse_lohi (_conv_sparse_kernel): the
// OR of a translated by every ON cell of b.
__global__ void __launch_bounds__(kThreadsPerBlock)
conv_sparse_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                   u64* __restrict__ out, int B) {
  __shared__ PeelSmem smem[kWarpsPerBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int board = blockIdx.x * kWarpsPerBlock + warp;
  if (board >= B) return;
  const size_t at = lane_word(board, lane);
  u64 acc_lo = 0, acc_hi = 0;
  peel_or(smem[warp], a[at], a[at + 32], b[at], b[at + 32], lane, acc_lo, acc_hi);
  out[at] = acc_lo;
  out[at + 32] = acc_hi;
}

// Replaces conv_sparse_pallas.counts_sparse_lohi (_counts_sparse_kernel):
// the same rounds, each shifted copy added into 13 bit-sliced counter
// planes; the low n_planes are written to out [n_planes, B, 64], which are
// the counts mod 2^n_planes as the TPU kernel's n_planes-wide counter.
__global__ void __launch_bounds__(kThreadsPerBlock)
counts_sparse_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                     u64* __restrict__ out, int B, int n_planes) {
  __shared__ PeelSmem smem[kWarpsPerBlock];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int board = blockIdx.x * kWarpsPerBlock + warp;
  if (board >= B) return;
  const size_t at = lane_word(board, lane);
  u64 p_lo[kMaxPlanes], p_hi[kMaxPlanes];
#pragma unroll
  for (int i = 0; i < kMaxPlanes; ++i) p_lo[i] = p_hi[i] = 0;
  peel_rounds(
      smem[warp], a[at], a[at + 32], b[at], b[at + 32], lane,
      [&](const u64 (&lo)[kUnroll], const u64 (&hi)[kUnroll]) {
        add_copies4(p_lo, lo[0], lo[1], lo[2], lo[3]);
        add_copies4(p_hi, hi[0], hi[1], hi[2], hi[3]);
      },
      [&](u64 lo, u64 hi) {
        add_copy(p_lo, lo);
        add_copy(p_hi, hi);
      });
  const size_t plane = static_cast<size_t>(B) * 64;
#pragma unroll
  for (int i = 0; i < kMaxPlanes; ++i) {
    if (i < n_planes) {
      out[i * plane + at] = p_lo[i];
      out[i * plane + at + 32] = p_hi[i];
    }
  }
}

// Up to kMaxPairs pairs of boards: operand k (left of pair k / 2 when k is
// even, its right when odd) of query q is the board at p[k] + q * stride[k]
// words; a broadcast operand has stride 0.
struct PairSet {
  const u64* p[2 * kMaxPairs];
  int stride[2 * kMaxPairs];
};

__device__ __forceinline__ void load_pair(const PairSet& pairs, int k, int board, int lane,
                                          u64 (&w)[4]) {
  const u64* l = pairs.p[2 * k] + static_cast<long long>(board) * pairs.stride[2 * k];
  const u64* r = pairs.p[2 * k + 1] + static_cast<long long>(board) * pairs.stride[2 * k + 1];
  w[0] = l[lane];
  w[1] = l[lane + 32];
  w[2] = r[lane];
  w[3] = r[lane + 32];
}

// What core/convolve.py union_interacting(pairs, method="sparse") computes,
// in one launch: the OR over the pairs of the OR-convolution of their left
// and right boards.  One block a query and one warp a pair: the warp takes
// the population of both sides (__popcll and a warp reduction) and peels
// the smaller, as the JAX package's per-lane swap does (convolution
// commutes, so the answer does not depend on the choice); the block ORs
// the warps' convolutions through shared memory and writes one board.
// Nothing is stacked, expanded or read back.  One warp looping over the
// pairs of its query, the next pair's boards loading during this pair's
// rounds, measured 15% slower on an H100 (its query's pairs in series).
__global__ void __launch_bounds__(kThreadsPerBlock)
union_sparse_kernel(const __grid_constant__ PairSet pairs, int n_pairs, u64* __restrict__ out) {
  static_assert(kMaxPairs <= kWarpsPerBlock, "one warp a pair");
  __shared__ PeelSmem smem[kWarpsPerBlock];
  __shared__ u64 part[kMaxPairs][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int board = blockIdx.x;
  if (warp < n_pairs) {
    u64 w[4], acc_lo = 0, acc_hi = 0;
    load_pair(pairs, warp, board, lane, w);
    const int pop_l = __reduce_add_sync(kFullMask, __popcll(w[0]) + __popcll(w[1]));
    const int pop_r = __reduce_add_sync(kFullMask, __popcll(w[2]) + __popcll(w[3]));
    if (pop_l != 0 && pop_r != 0) {
      if (pop_l < pop_r) peel_or(smem[warp], w[2], w[3], w[0], w[1], lane, acc_lo, acc_hi);
      else peel_or(smem[warp], w[0], w[1], w[2], w[3], lane, acc_lo, acc_hi);
    }
    part[warp][lane] = acc_lo;
    part[warp][lane + 32] = acc_hi;
  }
  __syncthreads();
  if (threadIdx.x < 64) {
    u64 v = 0;
    for (int k = 0; k < n_pairs; ++k) v |= part[k][threadIdx.x];
    out[static_cast<size_t>(board) * 64 + threadIdx.x] = v;
  }
}

// ---------------------------------------------------------------------------
// Dense counts as a tensor-core NTT (replaces conv_pallas.conv_counts_fused,
// conv_small_fused and conv_small_packed)
// ---------------------------------------------------------------------------
//
// The circular convolution of two 64x64 0/1 fields is V (W A W . W B W) V
// mod p, with W the 64-point NTT matrix mod p and V its inverse (both
// symmetric; built once, in lifeapi_tpu_torch/core/ntt.py, and passed in).
// conv_counts_fused takes the primes 193 and 257 and combines the two
// residues by CRT into the exact count (<= 4096 < 193 * 257);
// conv_small_fused takes 193 alone and returns the residue, or the mask
// residue != 0; conv_small_packed is that mask on packed boards, int64[B, 64]
// in and out, as the TPU kernel expands the bits in the kernel and repacks
// the mask.  Every stage is exact: residues and twiddles are integers
// <= 256, exact in bf16; a 0/1 input times a twiddle sums to <= 16384, the
// later stages to <= 64 * 256^2 = 2^22 < 2^24, and the pointwise product
// to <= 65536, all exact in the f32 accumulators; each sum is reduced mod p
// (mod_p) before it feeds the next stage.
//
// Bound.  The function moves 4 KB + 4 KB in and 16 KB (int32) or 4 KB
// (int8) out per board, 0.03 ms at B = 4096 (packed: 512 B + 512 B in and
// 512 B out, 0.002 ms); its six 64^3 products per prime are 2 * 6 * 64^3
// FLOP, 0.013 ms per prime at the bf16 tensor-core peak; its 7 x 4096 mod
// reductions per prime (and 4096 CRT steps), some 6 instructions each, are
// of the same order at the issue peak.  So the design keeps every stage on
// the tensor cores and on chip: device memory sees each byte once.
//
// Design.  One block of 4 warps per board at a time, persistent over the
// batch (grid = SMs x resident blocks), the twiddles in shared memory for
// the block's lifetime.  Products are mma.sync.m16n8k16 (bf16 in, f32
// accumulate); every shared tile is read by ldmatrix from rows padded to
// 72 bf16, so the 8 rows of each 8x8 matrix fall on distinct banks.  A warp
// owns a 16-row strip with all 64 columns, and the stages run
//   forward y: S1 = W X^T (A = W from shared, B = the board from shared)
//   forward x: S2 = S1 W  (A = S1 from registers)
//   product:   P  = S2a . S2b, element-wise, in registers
//   inverse x: S3 = P V   (A = P from registers)
//   corner turn through shared memory (S3 stored [ky][x])
//   inverse y: C  = S3^T V (A = S3^T by ldmatrix.trans)
// so C[x][y] = (V (FA . FB) V)[x][y].  The A operand of a stage is the
// previous stage's accumulator: two 16x8 f32 accumulator tiles side by side
// hold exactly the elements of one 16x16 A fragment (the identity
// FlashAttention-2 uses for P V), reduced mod p and converted to bf16 in
// registers.  Both boards share the stage-1 A fragments and the stage-2 B
// fragments.  The next board's bytes arrive by cp.async during the current
// board's products; the bytes are turned into bf16 0/1 (non-zero = ON) in
// shared memory, and the results are staged through shared memory for
// 16-byte stores.  Packed boards arrive as 2 x 512 bytes and are expanded
// bit by bit into the same tiles; each result word is assembled in
// registers (a lane holds 16 of a row's 64 cells, the quad ORs its four
// parts by shuffles) and stored directly.  The two primes run one after the
// other, the first prime's residues kept in registers as bf16 pairs for
// the CRT.

namespace ntt {

constexpr int kWarps = 4;           // one 16-row strip of the board each
constexpr int kThreads = kWarps * 32;
constexpr int kStride = 72;         // bf16 per shared row: 64 + 8 of padding
constexpr int kTile = 64 * kStride;
constexpr int kTileBytes = kTile * 2;
constexpr int kIntStride = 72;      // int32 per staging row
constexpr int kByteStride = 80;     // int8 per staging row
constexpr int kMaxPrime = 257;      // residues <= 256 are exact in bf16

// kPacked: int64[B, 64] boards in, the mask residue != 0 as int64[B, 64] out
enum Out { kCounts = 0, kResidue = 1, kMask = 2, kPacked = 3 };

using bf16 = __nv_bfloat16;

// bytes of one input board: 64 x 64 cells, or 64 words of 64 bits
template <int kOut>
__host__ __device__ constexpr int board_bytes() { return kOut == kPacked ? 512 : 4096; }

// shared memory: W, V of each prime, the two boards' bf16 tiles (which
// double as the output staging, 64 x 72 int32), the corner-turn tile and
// the next boards' raw bytes
template <int kPrimes, int kOut>
constexpr int smem_bytes() { return (2 * kPrimes + 3) * kTileBytes + 2 * board_bytes<kOut>(); }

struct Prime {
  float p, rinv;
};

// x mod p for an integer 0 <= x <= 2^22 held in a float.  x * (1/p) is
// within 2^-23 x/p < 1/257 of x/p, so its floor is the quotient, or one
// short when p divides x; one fix-up then gives [0, p).
__device__ __forceinline__ float mod_p(float x, Prime m) {
  const float r = fmaf(-floorf(x * m.rinv), m.p, x);
  return r >= m.p ? r - m.p : r;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float low_bf16(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float high_bf16(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of a warp's 16-row strip of a shared tile, row-major [m][k]
// (four k-blocks of 16).
__device__ __forceinline__ void load_a(unsigned (&a)[4][4], const bf16* tile, int strip,
                                       int lane) {
  const bf16* p = tile + (strip * 16 + (lane & 15)) * kStride + ((lane >> 4) << 3);
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) ldsm_x4(a[kb], p + 16 * kb);
}

// A fragments of the strip of the transposed tile: A[m][k] = tile[k][m].
__device__ __forceinline__ void load_a_trans(unsigned (&a)[4][4], const bf16* tile,
                                             int strip, int lane) {
  const int j = lane >> 3;
  const bf16* p = tile + ((lane & 7) + ((j >> 1) << 3)) * kStride + strip * 16 +
                  ((j & 1) << 3);
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) ldsm_x4_trans(a[kb], p + 16 * kb * kStride);
}

// The B operand's lane address in a shared 64x64 tile stored [n][k] (row n
// holds column n of B): one ldmatrix.x4 at (n-tile pair np, k-block kb)
// gives the fragments of n-tiles 2np and 2np + 1.
__device__ __forceinline__ const bf16* b_base(const bf16* tile, int lane) {
  return tile + ((lane & 7) + ((lane >> 4) << 3)) * kStride + (((lane >> 3) & 1) << 3);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// acc = a @ B for a warp's strip; B from a shared tile stored [n][k].
__device__ __forceinline__ void mma_strip(float (&acc)[8][4], const unsigned (&a)[4][4],
                                          const bf16* tile, int lane) {
  zero(acc);
  const bf16* p = b_base(tile, lane);
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldsm_x4(b, p + 16 * np * kStride + 16 * kb);
      mma(acc[2 * np], a[kb], b[0], b[1]);
      mma(acc[2 * np + 1], a[kb], b[2], b[3]);
    }
}

// acc_a = a_a @ B and acc_b = a_b @ B, each B fragment loaded once.
__device__ __forceinline__ void mma_strip_pair(float (&acc_a)[8][4], float (&acc_b)[8][4],
                                               const unsigned (&a_a)[4][4],
                                               const unsigned (&a_b)[4][4],
                                               const bf16* tile, int lane) {
  zero(acc_a);
  zero(acc_b);
  const bf16* p = b_base(tile, lane);
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldsm_x4(b, p + 16 * np * kStride + 16 * kb);
      mma(acc_a[2 * np], a_a[kb], b[0], b[1]);
      mma(acc_a[2 * np + 1], a_a[kb], b[2], b[3]);
      mma(acc_b[2 * np], a_b[kb], b[0], b[1]);
      mma(acc_b[2 * np + 1], a_b[kb], b[2], b[3]);
    }
}

__device__ __forceinline__ void reduce(float (&acc)[8][4], Prime m) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = mod_p(acc[nt][i], m);
}

// The accumulator strip (reduced) as the A operand of the next product:
// accumulator tiles 2kb and 2kb + 1 hold k-block kb's fragment, rows g and
// g + 8 in elements (0, 1) and (2, 3).
__device__ __forceinline__ void to_operand(const float (&acc)[8][4], unsigned (&a)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    a[kb][0] = pack_bf16(acc[2 * kb][0], acc[2 * kb][1]);
    a[kb][1] = pack_bf16(acc[2 * kb][2], acc[2 * kb][3]);
    a[kb][2] = pack_bf16(acc[2 * kb + 1][0], acc[2 * kb + 1][1]);
    a[kb][3] = pack_bf16(acc[2 * kb + 1][2], acc[2 * kb + 1][3]);
  }
}

// Issue the cp.async copies of one board pair's bytes into raw.
template <int kOut>
__device__ __forceinline__ void fetch(const unsigned char* a, const unsigned char* b,
                                      int board, unsigned char* raw) {
  constexpr int kBytes = board_bytes<kOut>();
  const size_t at = static_cast<size_t>(board) * kBytes;
  for (int c = threadIdx.x; c < kBytes / 16; c += kThreads) {
    cp_async16(raw + 16 * c, a + at + 16 * c);
    cp_async16(raw + kBytes + 16 * c, b + at + 16 * c);
  }
  cp_async_commit();
}

// The next board pair's raw input -> bf16 0/1 tiles [x][y], 16 cells of one
// column x per step: dense bytes (non-zero = ON), 16 bytes a step; or packed
// words, whose 16-bit pieces are spread so that bit 2i of the piece lands
// in the low half of h[i] and bit 2i + 1 in its high half.
template <int kOut>
__device__ __forceinline__ void unpack(const unsigned char* raw, bf16* xa, bf16* xb) {
  for (int c = threadIdx.x; c < 512; c += kThreads) {
    const int chunk = c & 255;  // column chunk >> 2, rows 16 (chunk & 3) + 0..15
    unsigned h[8];
    if constexpr (kOut == kPacked) {
      const unsigned half = reinterpret_cast<const unsigned*>(raw)[c >> 1];
      const unsigned bits = (c & 1) ? half >> 16 : half & 0xffffu;
      const unsigned spread = (bits & 0x5555u) | ((bits >> 1) & 0x5555u) << 16;
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = ((spread >> (2 * i)) & 0x10001u) * 0x3f80u;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(raw + 16 * c);
      const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned on = __vcmpne4(words[i], 0u);  // 0xff in each ON byte
        h[2 * i] = __byte_perm(on, 0u, 0x1100) & 0x3f803f80u;  // bf16 1.0 = 0x3f80
        h[2 * i + 1] = __byte_perm(on, 0u, 0x3322) & 0x3f803f80u;
      }
    }
    uint4* dst = reinterpret_cast<uint4*>((c < 256 ? xa : xb) + (chunk >> 2) * kStride +
                                          ((chunk & 3) << 4));
    dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
    dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// Store a board's results (rows x = 16 strip + g, + 8; columns y = 8 nt + 2t,
// + 1) through the staging area with 16-byte stores.
template <int kOut>
__device__ __forceinline__ void store_board(const float (&res)[8][4], unsigned char* stage,
                                            void* out, int board, int strip, int lane) {
  const int x = strip * 16 + (lane >> 2), y = 2 * (lane & 3);
  const size_t at = static_cast<size_t>(board) * 4096;
  if (kOut == kMask) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + y;
      *reinterpret_cast<unsigned short*>(stage + x * kByteStride + col) =
          (res[nt][0] != 0.f) | ((res[nt][1] != 0.f) << 8);
      *reinterpret_cast<unsigned short*>(stage + (x + 8) * kByteStride + col) =
          (res[nt][2] != 0.f) | ((res[nt][3] != 0.f) << 8);
    }
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(static_cast<signed char*>(out) + at);
    for (int c = threadIdx.x; c < 64 * 4; c += kThreads)
      dst[c] = *reinterpret_cast<const uint4*>(stage + (c >> 2) * kByteStride + 16 * (c & 3));
  } else {
    int* s = reinterpret_cast<int*>(stage);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + y;
      *reinterpret_cast<int2*>(s + x * kIntStride + col) =
          make_int2(__float2int_rn(res[nt][0]), __float2int_rn(res[nt][1]));
      *reinterpret_cast<int2*>(s + (x + 8) * kIntStride + col) =
          make_int2(__float2int_rn(res[nt][2]), __float2int_rn(res[nt][3]));
    }
    __syncthreads();
    int4* dst = reinterpret_cast<int4*>(static_cast<int*>(out) + at);
    for (int c = threadIdx.x; c < 64 * 16; c += kThreads)
      dst[c] = *reinterpret_cast<const int4*>(s + (c >> 4) * kIntStride + 4 * (c & 15));
  }
}

// Store the mask residue != 0 of a board as packed words.  Lane (g, t) =
// (lane >> 2, lane & 3) holds rows x = 16 strip + g and x + 8 at columns
// y = 8 nt + 2t and + 1: 16 bits of each row's word, which the quad's four
// lanes OR together.
__device__ __forceinline__ void store_packed(const float (&res)[8][4], void* out, int board,
                                             int strip, int lane) {
  u64 w0 = 0, w1 = 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    w0 |= static_cast<u64>((res[nt][0] != 0.f) | ((res[nt][1] != 0.f) << 1)) << (8 * nt);
    w1 |= static_cast<u64>((res[nt][2] != 0.f) | ((res[nt][3] != 0.f) << 1)) << (8 * nt);
  }
  w0 <<= 2 * (lane & 3);
  w1 <<= 2 * (lane & 3);
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    w0 |= __shfl_xor_sync(kFullMask, w0, m);
    w1 |= __shfl_xor_sync(kFullMask, w1, m);
  }
  if ((lane & 3) == 0) {
    u64* dst = static_cast<u64*>(out) + static_cast<size_t>(board) * 64 + strip * 16 + (lane >> 2);
    dst[0] = w0;
    dst[8] = w1;
  }
}

template <int kPrimes, int kOut>
__global__ void __launch_bounds__(kThreads)
ntt_conv_kernel(const unsigned char* __restrict__ a, const unsigned char* __restrict__ b,
                const bf16* __restrict__ twiddles, void* __restrict__ out, int B, int p1,
                int p2, int crt_inverse) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tw = reinterpret_cast<bf16*>(smem);  // W, V of each prime
  bf16* xa = tw + 2 * kPrimes * kTile;
  bf16* xb = xa + kTile;
  bf16* turn = xb + kTile;
  unsigned char* raw = reinterpret_cast<unsigned char*>(turn + kTile);
  const int lane = threadIdx.x & 31, strip = threadIdx.x >> 5;

  for (int c = threadIdx.x; c < 2 * kPrimes * 64 * 8; c += kThreads)
    *reinterpret_cast<uint4*>(tw + (c >> 3) * kStride + 8 * (c & 7)) =
        reinterpret_cast<const uint4*>(twiddles)[c];
  const Prime primes[2] = {{static_cast<float>(p1), 1.f / static_cast<float>(p1)},
                           {static_cast<float>(p2), 1.f / static_cast<float>(p2)}};

  int board = blockIdx.x;
  fetch<kOut>(a, b, board, raw);
  for (; board < B; board += gridDim.x) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the bytes are in; the last board's staging is read
    unpack<kOut>(raw, xa, xb);
    __syncthreads();
    if (board + gridDim.x < B) fetch<kOut>(a, b, board + gridDim.x, raw);

    float res[8][4];
    unsigned first[8][2];  // the first prime's residues, bf16 pairs
#pragma unroll
    for (int k = 0; k < kPrimes; ++k) {
      const Prime m = primes[k];
      const bf16* w = tw + 2 * k * kTile;
      const bf16* v = w + kTile;
      unsigned fa[4][4], fb[4][4];
      {
        float acc_a[8][4], acc_b[8][4];
        load_a(fa, w, strip, lane);  // the strip of W, shared by both boards
        mma_strip(acc_a, fa, xa, lane);
        mma_strip(acc_b, fa, xb, lane);
        reduce(acc_a, m);
        reduce(acc_b, m);
        to_operand(acc_a, fa);
        to_operand(acc_b, fb);
        mma_strip_pair(acc_a, acc_b, fa, fb, w, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc_a[nt][i] = mod_p(mod_p(acc_a[nt][i], m) * mod_p(acc_b[nt][i], m), m);
        to_operand(acc_a, fa);
      }
      float acc[8][4];
      mma_strip(acc, fa, v, lane);
      reduce(acc, m);
      if (k > 0) __syncthreads();  // every warp has read the last prime's turn
      const int row = strip * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<unsigned*>(turn + row * kStride + 8 * nt + col) =
            pack_bf16(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<unsigned*>(turn + (row + 8) * kStride + 8 * nt + col) =
            pack_bf16(acc[nt][2], acc[nt][3]);
      }
      __syncthreads();
      load_a_trans(fa, turn, strip, lane);
      mma_strip(res, fa, v, lane);
      reduce(res, m);
      if (kPrimes == 2 && k == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          first[nt][0] = pack_bf16(res[nt][0], res[nt][1]);
          first[nt][1] = pack_bf16(res[nt][2], res[nt][3]);
        }
      }
    }
    if (kPrimes == 2) {
      // CRT: c1 + p1 * ((c2 - c1) * p1^-1 mod p2), with c2 - c1 + p2 > 0
      const Prime m2 = primes[1];
      const float crt = static_cast<float>(crt_inverse);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float c1[4] = {low_bf16(first[nt][0]), high_bf16(first[nt][0]),
                             low_bf16(first[nt][1]), high_bf16(first[nt][1])};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          res[nt][i] = c1[i] + primes[0].p * mod_p((res[nt][i] - c1[i] + m2.p) * crt, m2);
      }
    }
    if constexpr (kOut == kPacked) {
      store_packed(res, out, board, strip, lane);
    } else {
      // the board tiles are free: every warp passed the barrier after its
      // last stage-1 read
      store_board<kOut>(res, reinterpret_cast<unsigned char*>(xa), out, board, strip, lane);
    }
  }
}

inline bool prime_ok(int p) { return p > 2 && p <= kMaxPrime; }

// Opt the instantiation into its shared memory; resident blocks an SM.
template <int kPrimes, int kOut>
cudaError_t configure(int& per_sm) {
  auto kernel = ntt_conv_kernel<kPrimes, kOut>;
  constexpr int bytes = smem_bytes<kPrimes, kOut>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  return err;
}

template <int kPrimes, int kOut>
cudaError_t launch(const void* a, const void* b, const void* twiddles, void* out, int B,
                   int p1, int p2, int crt_inverse, cudaStream_t stream) {
  if (B <= 0 || !prime_ok(p1) ||
      (kPrimes == 2 && (!prime_ok(p2) || crt_inverse < 0 || crt_inverse >= p2)))
    return cudaErrorInvalidValue;
  int device, sms, per_sm;
  cudaError_t err = configure<kPrimes, kOut>(per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = B < sms * per_sm ? B : sms * per_sm;
  ntt_conv_kernel<kPrimes, kOut><<<grid, kThreads, smem_bytes<kPrimes, kOut>(), stream>>>(
      static_cast<const unsigned char*>(a), static_cast<const unsigned char*>(b),
      static_cast<const bf16*>(twiddles), out, B, p1, p2, crt_inverse);
  return cudaGetLastError();
}

// info = {resident blocks an SM, registers a thread, local (spilled) bytes a
// thread} of one instantiation.
template <int kPrimes, int kOut>
cudaError_t info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = configure<kPrimes, kOut>(out[0]);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, ntt_conv_kernel<kPrimes, kOut>);
  if (err != cudaSuccess) return err;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

}  // namespace ntt

inline dim3 warp_grid(int B) { return dim3((B + kWarpsPerBlock - 1) / kWarpsPerBlock); }

}  // namespace

// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return the launch's cudaError_t (0 on success).  B > 0.

extern "C" cudaError_t life_conv_sparse(const u64* a, const u64* b, u64* out,
                                        int B, cudaStream_t stream) {
  if (B <= 0) return cudaErrorInvalidValue;
  conv_sparse_kernel<<<warp_grid(B), kThreadsPerBlock, 0, stream>>>(a, b, out, B);
  return cudaGetLastError();
}

// desc: the pointers of the 2 n_pairs operands (left, right of each pair
// in turn), then their board strides in words (0 broadcasts, < 2^31); out:
// int64 [B, 64].
extern "C" cudaError_t life_union_sparse(const long long* desc, int n_pairs, u64* out, int B,
                                         cudaStream_t stream) {
  if (B <= 0 || n_pairs < 1 || n_pairs > kMaxPairs) return cudaErrorInvalidValue;
  PairSet pairs = {};
  for (int k = 0; k < 2 * n_pairs; ++k) {
    pairs.p[k] = reinterpret_cast<const u64*>(desc[k]);
    pairs.stride[k] = static_cast<int>(desc[2 * n_pairs + k]);
  }
  union_sparse_kernel<<<B, kThreadsPerBlock, 0, stream>>>(pairs, n_pairs, out);
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

// a, b: dense bytes [B, 64, 64], 16-byte aligned; twiddles: bf16 [4, 64, 64]
// (W, V mod p1, then mod p2); out: int32 [B, 64, 64] exact counts.
extern "C" cudaError_t life_conv_counts(const void* a, const void* b, const void* twiddles,
                                        int* out, int B, int p1, int p2, int crt_inverse,
                                        cudaStream_t stream) {
  return ntt::launch<2, ntt::kCounts>(a, b, twiddles, out, B, p1, p2, crt_inverse, stream);
}

// a, b: dense bytes [B, 64, 64], 16-byte aligned; twiddles: bf16 [2, 64, 64]
// (W, V mod p) or more; out: int8 [B, 64, 64] count % p != 0 when out_or,
// else int32 [B, 64, 64] count % p.
extern "C" cudaError_t life_conv_small(const void* a, const void* b, const void* twiddles,
                                       void* out, int B, int p, int out_or,
                                       cudaStream_t stream) {
  return out_or ? ntt::launch<1, ntt::kMask>(a, b, twiddles, out, B, p, p, 0, stream)
                : ntt::launch<1, ntt::kResidue>(a, b, twiddles, out, B, p, p, 0, stream);
}

// a, b: boards int64 [B, 64], 16-byte aligned; twiddles as life_conv_small;
// out: int64 [B, 64], the boards of count % p != 0.
extern "C" cudaError_t life_conv_small_packed(const void* a, const void* b,
                                              const void* twiddles, void* out, int B, int p,
                                              cudaStream_t stream) {
  return ntt::launch<1, ntt::kPacked>(a, b, twiddles, out, B, p, p, 0, stream);
}

// info[3 k .. 3 k + 2] = ntt::info of instantiation k: <2, kCounts>,
// <1, kResidue>, <1, kMask>, <1, kPacked>.
extern "C" cudaError_t life_conv_ntt_info(int* info) {
  cudaError_t err = ntt::info<2, ntt::kCounts>(info);
  if (err == cudaSuccess) err = ntt::info<1, ntt::kResidue>(info + 3);
  if (err == cudaSuccess) err = ntt::info<1, ntt::kMask>(info + 6);
  if (err == cudaSuccess) err = ntt::info<1, ntt::kPacked>(info + 9);
  return err;
}
