// Bit-exact B3/S23 rollouts of 64x64 torus boards, hand-written for Hopper
// (sm_90a).  Built by lifeapi_tpu_torch/ops/_build.py with nvcc into a
// shared library with a plain C interface and called through ctypes from
// lifeapi_tpu_torch/ops/step_cuda.py, which holds each kernel's plain
// PyTorch twin.
//
// Board layout in device memory: int64[B, 64], one 64-bit word per column x,
// bit y = cell (x, y) (the reference's LifeState layout); rollout_lohi_kernel
// alone takes the JAX kernels' half-word layout, two uint32[64, B] arrays.
//
// Design:
//  * One warp steps one board, held in registers for the whole horizon, so
//    device-memory traffic is one read and one write of the board per
//    rollout; only the controlled kernel streams more (its toggles).  This
//    is what the TPU kernels get from holding the batch tile in VMEM.
//  * Vertical neighbours are native 64-bit rotates of the lane's own words;
//    the TPU's even/odd interleave (lifeapi_tpu/core/bitops.py
//    interleave_split) only saved 32-bit funnel shifts and is not used.
//  * Every rollout kernel gives lane l the adjacent columns 2l (even) and
//    2l + 1 (odd), and steps them with one circuit (life_step_pair).  A
//    column's horizontal neighbours are then its partner in the lane and one
//    column of the previous or next lane: 4 64-bit shuffles of the vertical
//    3-sums a generation and no selects, since column 63 (lane 31's odd) sits
//    next to column 0 (lane 0's even) as the lanes wrap.  A lane's two
//    columns are 16 contiguous bytes, so a warp reads and writes its board in
//    one coalesced access.  The split layout of warp_board.cuh (lane l on
//    columns l and l + 32) is left to the still-life, convolution and
//    calibration kernels.
//  * Bound: integer-ALU and shuffle issue per board-step; the board never
//    leaves registers, so bytes are not the limit for T >> 1.  LOP3 issues
//    at most every other clock, so the step takes Rokicki's terms as six
//    explicit LOP3 a 32-bit half (rokicki_lop3): a generation is 40 LOP3, 8
//    funnel shifts (the vertical rotates) and 8 32-bit shuffles a lane.
//  * No padding: the B % 128 batch padding of the TPU wrappers goes away.  A
//    warp whose board index is past B leaves at once, as a whole, so every
//    shuffle in the warps that remain has all 32 lanes ([4] excepted, whose
//    warps past B step an empty board: its block shares barriers).

#include "warp_board.cuh"

namespace {

using warp_board::cp_async16;
using warp_board::cp_async_commit;
using warp_board::cp_async_wait_one;
using warp_board::kFullMask;
using warp_board::rotl1;
using warp_board::rotr1;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;
// resident blocks an SM asked of ptxas for [1] and [4]: 64 warps, the most
// an SM holds, at 32 registers a thread
constexpr int kBlocksPerSM = 8;

// The three-input logic function kLut of each bit of a, b and c (PTX's
// lop3 truth table: a is 0xf0, b 0xcc, c 0xaa), one LOP3 a 32-bit half.
template <int kLut>
__device__ __forceinline__ u64 lop3(u64 a, u64 b, u64 c) {
  unsigned lo, hi;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(lo)
      : "r"(static_cast<unsigned>(a)), "r"(static_cast<unsigned>(b)),
        "r"(static_cast<unsigned>(c)), "n"(kLut));
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(hi)
      : "r"(static_cast<unsigned>(a >> 32)), "r"(static_cast<unsigned>(b >> 32)),
        "r"(static_cast<unsigned>(c >> 32)), "n"(kLut));
  return (static_cast<u64>(hi) << 32) | lo;
}

// Rokicki's next-state formula (reference LifeAPI.hpp:837-848) for one
// column a, as six explicit LOP3 a 32-bit half, where nvcc's own fusion of
// the formula written in C takes eight: (s0, s1) is the sum of its two
// vertical neighbours, (u0, u1) and (b0, b1) the vertical 3-sums of the
// columns to its left and right.  The neighbour count is
// t0 + 2 (ts1 + b1 + u1 + s1); the cell lives where the twos sum to 1 and
// t0 | a.
__device__ __forceinline__ u64 rokicki_lop3(u64 a, u64 s0, u64 s1, u64 u0, u64 u1,
                                            u64 b0, u64 b1) {
  const u64 t0 = lop3<0x96>(b0, u0, s0);     // b0 ^ u0 ^ s0
  const u64 ts1 = lop3<0xe8>(b0, u0, s0);    // their majority: the carry
  const u64 one = lop3<0x16>(b1, u1, s1);    // exactly one of b1, u1, s1
  const u64 none = lop3<0x01>(b1, u1, s1);   // none of them
  const u64 twos = lop3<0xca>(ts1, none, one);  // ts1 ? none : one
  return lop3<0xe0>(twos, t0, a);               // twos & (t0 | a)
}

// One generation of a board whose lane l holds the adjacent columns 2l
// (even) and 2l + 1 (odd), the layout of every rollout kernel: the CSA
// netlist of lifeapi_tpu_torch/core/step.py step(), bit for bit.  A column's
// neighbours are its partner in the lane and one column of the previous or
// next lane: 4 64-bit shuffles a generation and no selects, since column 63
// (lane 31's odd) sits next to column 0 (lane 0's even) as the lanes wrap.
// 40 LOP3 a generation.
__device__ __forceinline__ void life_step_pair(u64& even, u64& odd, int lane) {
  const u64 we = rotl1(even), ee = rotr1(even);
  const u64 wo = rotl1(odd), eo = rotr1(odd);
  const u64 s0e = we ^ ee, s1e = we & ee;
  const u64 s0o = wo ^ eo, s1o = wo & eo;
  const u64 c0e = s0e ^ even, c1e = (s0e & even) | s1e;
  const u64 c0o = s0o ^ odd, c1o = (s0o & odd) | s1o;
  // column 2l - 1 is the previous lane's odd, column 2l + 2 the next lane's even
  const int prev = (lane + 31) & 31, next = (lane + 1) & 31;
  const u64 u0 = __shfl_sync(kFullMask, c0o, prev);
  const u64 u1 = __shfl_sync(kFullMask, c1o, prev);
  const u64 b0 = __shfl_sync(kFullMask, c0e, next);
  const u64 b1 = __shfl_sync(kFullMask, c1e, next);
  even = rokicki_lop3(even, s0e, s1e, u0, u1, c0o, c1o);
  odd = rokicki_lop3(odd, s0o, s1o, c0e, c1e, b0, b1);
}

// Replaces lifeapi_tpu/ops/step_pallas.py rollout_eo (_rollout_kernel_eo):
// T generations of every board.  Bound: integer-ALU and shuffle issue per
// board-step; device memory sees 1 KB per board per rollout, whatever T is.
// The design keeps the board in registers for the whole horizon, lane l on
// columns 2l and 2l + 1 (life_step_pair), and gives the card B warps to hide
// each step's shuffle latency behind other warps: 8 warps a block, at most
// 32 registers a thread so that 8 blocks (64 warps) fit an SM.  A lane reads
// and writes its two columns as one 16-byte word, so in and out must start
// on 16 bytes (the launcher refuses them otherwise).
__global__ void __launch_bounds__(kThreadsPerBlock, kBlocksPerSM)
rollout_kernel(const u64* __restrict__ in, u64* __restrict__ out,
               int B, int T) {
  const int lane = threadIdx.x & 31;
  const int board = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (board >= B) return;
  const size_t at = static_cast<size_t>(board) * 64 + 2 * lane;
  const ulonglong2 cols = *reinterpret_cast<const ulonglong2*>(in + at);
  u64 even = cols.x, odd = cols.y;
#pragma unroll 4
  for (int t = 0; t < T; ++t) life_step_pair(even, odd, lane);
  *reinterpret_cast<ulonglong2*>(out + at) = make_ulonglong2(even, odd);
}

// -- controlled rollout ---------------------------------------------------------

// Toggle rows a stage of the controlled kernel holds: 4 KB a stage, two
// stages a block, so that blocks of one warp are not held back by shared
// memory (28 of them fit an SM).
constexpr int kToggleChunk = 8;

// Issue the copies of `rows` generations of a board's toggles into a stage:
// each lane copies the 16 bytes of a row that it will read (its columns
// 2l and 2l + 1), so no lane waits for another's copies.
__device__ __forceinline__ void stage_toggles(u64 (*stage)[64], const u64* tog,
                                              size_t stride, int rows, int lane) {
  for (int r = 0; r < rows; ++r) cp_async16(&stage[r][2 * lane], tog + r * stride + 2 * lane);
}

// Replaces lifeapi_tpu/ops/step_pallas.py controlled_rollout_eo
// (_controlled_kernel_eo): at each generation t, XOR toggles[t] into the
// board, then step.  toggles: [T, B, 64].  The MPC solver calls it on 64
// candidates over 32 generations, far too little work to fill the card:
// the bound there is one warp's dependent chain, T generations of the
// loop's instructions at one a clock, not the 512 bytes per board-step of
// toggles or the ALUs.
//
// Design: one warp a block and one block a board, so 64 boards run on 64
// SMs, not 8; lane l holds columns 2l and 2l + 1 (life_step_pair: 8 32-bit
// shuffles a generation and no selects).  Each lane streams its 16 bytes of
// every toggle row into shared memory by cp.async, kToggleChunk generations
// a stage, two stages in flight: the next chunk is copied while this one is
// stepped, so a generation's XOR reads shared memory instead of waiting on a
// global load at the head of its chain.  The generation loop is unrolled by
// 4.  toggles must start on 16 bytes (the wrapper copies it otherwise).
__global__ void __launch_bounds__(32)
controlled_kernel(const u64* __restrict__ in,
                  const u64* __restrict__ toggles,
                  u64* __restrict__ out, int B, int T) {
  __shared__ __align__(16) u64 stages[2][kToggleChunk][64];
  const int lane = threadIdx.x;
  const size_t at = static_cast<size_t>(blockIdx.x) * 64 + 2 * lane;
  const size_t stride = static_cast<size_t>(B) * 64;  // words between generations
  const u64* tog = toggles + static_cast<size_t>(blockIdx.x) * 64;
  u64 even = in[at], odd = in[at + 1];
  const int chunks = (T + kToggleChunk - 1) / kToggleChunk;
  if (chunks > 0) stage_toggles(stages[0], tog, stride, min(kToggleChunk, T), lane);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kToggleChunk;
    if (c + 1 < chunks)
      stage_toggles(stages[(c + 1) & 1], tog + (t0 + kToggleChunk) * stride, stride,
                    min(kToggleChunk, T - t0 - kToggleChunk), lane);
    cp_async_commit();    // a group every pass, empty at the last
    cp_async_wait_one();  // chunk c has landed
    const u64 (*rows)[64] = stages[c & 1];
    const int n = min(kToggleChunk, T - t0);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const ulonglong2 t = *reinterpret_cast<const ulonglong2*>(&rows[i][2 * lane]);
      even ^= t.x;
      odd ^= t.y;
      life_step_pair(even, odd, lane);
    }
  }
  out[at] = even;
  out[at + 1] = odd;
}

// The catalyst rollout's interaction term for one word: acc | (x ^ (base |
// p)) & z, where x is a column of the board, base the baseline's and p, z
// the placed catalyst's and its ZOI's.  Two explicit LOP3 a 32-bit half.
__device__ __forceinline__ u64 interaction(u64 acc, u64 x, u64 base, u64 p, u64 z) {
  const u64 t = lop3<0x1e>(x, base, p);  // x ^ (base | p)
  return lop3<0xf8>(acc, t, z);          // acc | (t & z)
}

// Replaces lifeapi_tpu/ops/step_pallas.py catalyst_rollout_eo
// (_catalyst_kernel_eo): step the placed boards; after step t + 1 OR
// (board ^ (base_traj[t] | placed)) & placed_zoi into an accumulator, where
// base_traj[t] is the baseline reaction after t + 1 generations, shared by
// every board ([T, 64]).  The accumulator is reduced to one flag per board
// in-kernel (the TPU kernel wrote its acc planes out and search.py reduced
// them).  Bound: integer-ALU issue per board-step, as for rollout_kernel,
// plus the interaction's 8 LOP3 a generation; base_traj (T x 512 bytes) is
// shared by every warp, so it stays in L1/L2 and adds no device-memory
// traffic per board.
//
// Design: one warp a board, 8 a block, the board in registers for the whole
// horizon with lane l on columns 2l and 2l + 1 of the board, of placed and
// of placed_zoi (life_step_pair), and one 64-bit accumulator a lane.  A lane
// reads its two columns of each input, and writes the final board's, as one
// 16-byte word, and reads its 16 bytes of the baseline row through the
// read-only cache each generation; the generation loop is unrolled by 4.
// Every pointer but out_interacted starts on 16 bytes (the launcher refuses
// it otherwise; the wrapper copies).
__global__ void __launch_bounds__(kThreadsPerBlock)
catalyst_kernel(const u64* __restrict__ in,
                const u64* __restrict__ placed,
                const u64* __restrict__ placed_zoi,
                const u64* __restrict__ base_traj,
                u64* __restrict__ out_final,
                uint8_t* __restrict__ out_interacted, int B, int T) {
  const int lane = threadIdx.x & 31;
  const int board = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (board >= B) return;
  const size_t at = static_cast<size_t>(board) * 64 + 2 * lane;
  const ulonglong2 cols = *reinterpret_cast<const ulonglong2*>(in + at);
  const ulonglong2 p = *reinterpret_cast<const ulonglong2*>(placed + at);
  const ulonglong2 z = *reinterpret_cast<const ulonglong2*>(placed_zoi + at);
  const ulonglong2* base = reinterpret_cast<const ulonglong2*>(base_traj) + lane;
  u64 even = cols.x, odd = cols.y, acc = 0;
#pragma unroll 4
  for (int t = 0; t < T; ++t, base += 32) {
    life_step_pair(even, odd, lane);
    const ulonglong2 row = __ldg(base);  // base_traj[t][2l .. 2l + 1]
    acc = interaction(acc, even, row.x, p.x, z.x);
    acc = interaction(acc, odd, row.y, p.y, z.y);
  }
  *reinterpret_cast<ulonglong2*>(out_final + at) = make_ulonglong2(even, odd);
  const bool interacted = __any_sync(kFullMask, acc != 0);
  if (lane == 0) out_interacted[board] = interacted ? 1 : 0;
}

// Replaces lifeapi_tpu/ops/step_pallas.py rollout_lohi (_rollout_kernel,
// step_lohi): T generations of boards held in the half-word layout, two
// uint32[64, B] arrays, low32[x][b] and high32[x][b] the bits y 0..31 and
// 32..63 of column x of board b.  The kernel reads and writes that layout
// itself.  A block takes kWarpsPerBlock consecutive boards: its threads copy
// the block's 64 x 8 low and high words into shared memory (each row of a
// block is 32 contiguous bytes, one sector), lane l joins the halves of
// columns 2l and 2l + 1 into two 64-bit words, steps them in registers
// exactly as rollout_kernel does (life_step_pair), and the results go back
// the same way.  The staging runs once a rollout, against T generations, and
// is not tuned (the pair's rows, 18 words apart, meet 2-way bank conflicts).
// Warps past B step an empty board instead of leaving, so every thread
// reaches both barriers.  Bound: as rollout_kernel, integer-ALU and shuffle
// issue per board-step; device memory sees 4 x 64 x 4 bytes per board per
// rollout, whatever T is.
__global__ void __launch_bounds__(kThreadsPerBlock, kBlocksPerSM)
rollout_lohi_kernel(const uint32_t* __restrict__ low32_in,
                    const uint32_t* __restrict__ high32_in,
                    uint32_t* __restrict__ low32_out,
                    uint32_t* __restrict__ high32_out, int B, int T) {
  // a row of 9 words: the copies' column accesses (stride 9) hit 32 banks
  __shared__ uint32_t low32[64][kWarpsPerBlock + 1];
  __shared__ uint32_t high32[64][kWarpsPerBlock + 1];
  const int first = blockIdx.x * kWarpsPerBlock;
  // 64 rows x 8 boards = 512 words per half, two per thread
  for (int i = threadIdx.x; i < 64 * kWarpsPerBlock; i += kThreadsPerBlock) {
    const int x = i / kWarpsPerBlock, k = i % kWarpsPerBlock;
    const size_t at = static_cast<size_t>(x) * B + first + k;
    const bool live = first + k < B;
    low32[x][k] = live ? low32_in[at] : 0u;
    high32[x][k] = live ? high32_in[at] : 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = 2 * lane;  // this lane's columns col and col + 1, as 64-bit words
  u64 even = (static_cast<u64>(high32[col][warp]) << 32) | low32[col][warp];
  u64 odd = (static_cast<u64>(high32[col + 1][warp]) << 32) | low32[col + 1][warp];
#pragma unroll 4
  for (int t = 0; t < T; ++t) life_step_pair(even, odd, lane);
  __syncthreads();  // every warp has read its words before any is replaced
  low32[col][warp] = static_cast<uint32_t>(even);
  high32[col][warp] = static_cast<uint32_t>(even >> 32);
  low32[col + 1][warp] = static_cast<uint32_t>(odd);
  high32[col + 1][warp] = static_cast<uint32_t>(odd >> 32);
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * kWarpsPerBlock; i += kThreadsPerBlock) {
    const int x = i / kWarpsPerBlock, k = i % kWarpsPerBlock;
    if (first + k < B) {
      const size_t at = static_cast<size_t>(x) * B + first + k;
      low32_out[at] = low32[x][k];
      high32_out[at] = high32[x][k];
    }
  }
}

inline dim3 grid_for(int B) { return dim3((B + kWarpsPerBlock - 1) / kWarpsPerBlock); }

// info = {resident blocks of kThreadsPerBlock an SM, registers a thread,
// local (spilled) bytes a thread} of a kernel.
template <typename Kernel>
cudaError_t block_info(Kernel kernel, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, kThreadsPerBlock, 0);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

}  // namespace

// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return the launch's cudaError_t (0 on success).  B must be
// positive and T non-negative.

// in and out start on 16 bytes.
extern "C" cudaError_t life_rollout(const u64* in, u64* out, int B,
                                    int T, cudaStream_t stream) {
  if (B <= 0 || T < 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) % 16)
    return cudaErrorMisalignedAddress;
  rollout_kernel<<<grid_for(B), kThreadsPerBlock, 0, stream>>>(in, out, B, T);
  return cudaGetLastError();
}

extern "C" cudaError_t life_rollout_lohi(const uint32_t* low32_in,
                                         const uint32_t* high32_in,
                                         uint32_t* low32_out, uint32_t* high32_out,
                                         int B, int T, cudaStream_t stream) {
  if (B <= 0 || T < 0) return cudaErrorInvalidValue;
  rollout_lohi_kernel<<<grid_for(B), kThreadsPerBlock, 0, stream>>>(
      low32_in, high32_in, low32_out, high32_out, B, T);
  return cudaGetLastError();
}

// kernel: 0 rollout_kernel, 1 rollout_lohi_kernel, 2 catalyst_kernel; info as
// block_info's, 3 ints.
extern "C" cudaError_t life_rollout_info(int kernel, int* info) {
  switch (kernel) {
    case 0: return block_info(rollout_kernel, info);
    case 1: return block_info(rollout_lohi_kernel, info);
    case 2: return block_info(catalyst_kernel, info);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" cudaError_t life_controlled_rollout(const u64* in,
                                               const u64* toggles,
                                               u64* out, int B, int T,
                                               cudaStream_t stream) {
  if (B <= 0 || T < 0) return cudaErrorInvalidValue;
  if (T > 0 && reinterpret_cast<uintptr_t>(toggles) % 16) return cudaErrorMisalignedAddress;
  controlled_kernel<<<B, 32, 0, stream>>>(in, toggles, out, B, T);
  return cudaGetLastError();
}

// in, placed, placed_zoi, out_final and (for T > 0) base_traj start on 16
// bytes.
extern "C" cudaError_t life_catalyst_rollout(const u64* in,
                                             const u64* placed,
                                             const u64* placed_zoi,
                                             const u64* base_traj,
                                             u64* out_final,
                                             uint8_t* out_interacted, int B,
                                             int T, cudaStream_t stream) {
  if (B <= 0 || T < 0) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(placed) |
       reinterpret_cast<uintptr_t>(placed_zoi) | reinterpret_cast<uintptr_t>(out_final) |
       (T > 0 ? reinterpret_cast<uintptr_t>(base_traj) : 0)) % 16)
    return cudaErrorMisalignedAddress;
  catalyst_kernel<<<grid_for(B), kThreadsPerBlock, 0, stream>>>(
      in, placed, placed_zoi, base_traj, out_final, out_interacted, B, T);
  return cudaGetLastError();
}
