// One 64x64 torus board per warp: the column helpers of the split layout
// (from_left and from_right, used by life_stable.cu alone; life_conv.cu and
// life_calibrate.cu hold their boards in the same layout), and the cp.async
// copies into shared memory (life_rollout.cu, life_conv.cu).
//
// Layout: a board is 64 words of 64 bits, one per column x, bit y = cell
// (x, y) (the reference's LifeState layout).  In the split layout lane l of
// the warp holds columns l and l + 32 ("lo" and "hi") in two registers.
// Vertical neighbours are native 64-bit rotates of a lane's own words;
// horizontal neighbours are __shfl_sync of the neighbouring lane's words,
// with the torus wrap at lanes 0 and 31 swapping the two registers.  Every
// rollout kernel (life_rollout.cu life_step_pair) instead gives lane l the
// adjacent columns 2l and 2l + 1, which halves the shuffles and needs no
// swap at the wrap, and uses only rotl1, rotr1 and the copies from here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// unsigned long long, not uint64_t (unsigned long here): it is the type the
// __shfl_sync and __ldg overloads are declared for.
using u64 = unsigned long long;

namespace warp_board {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ u64 rotl1(u64 x) { return (x << 1) | (x >> 63); }
__device__ __forceinline__ u64 rotr1(u64 x) { return (x >> 1) | (x << 63); }

// Column x - 1 of the lane's columns (l, l + 32).  Lane 0 wraps: column 0
// takes column 63 (lane 31's hi) and column 32 takes column 31 (lane 31's lo).
__device__ __forceinline__ void from_left(u64 lo, u64 hi, int lane,
                                          u64& out_lo, u64& out_hi) {
  const int src = (lane + 31) & 31;
  const u64 a = __shfl_sync(kFullMask, lo, src);
  const u64 b = __shfl_sync(kFullMask, hi, src);
  out_lo = lane == 0 ? b : a;
  out_hi = lane == 0 ? a : b;
}

// Column x + 1.  Lane 31 wraps: column 31 takes column 32 (lane 0's hi) and
// column 63 takes column 0 (lane 0's lo).
__device__ __forceinline__ void from_right(u64 lo, u64 hi, int lane,
                                           u64& out_lo, u64& out_hi) {
  const int src = (lane + 1) & 31;
  const u64 a = __shfl_sync(kFullMask, lo, src);
  const u64 b = __shfl_sync(kFullMask, hi, src);
  out_lo = lane == 31 ? b : a;
  out_hi = lane == 31 ? a : b;
}

// 16 bytes from device memory into shared memory, asynchronously; both
// addresses start on 16 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

// Close this thread's group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this thread's groups is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

}  // namespace warp_board
