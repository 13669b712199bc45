// Calibration: a chain of a known number of integer ops, hand-written for
// Hopper (sm_90a), to measure the card's own ceiling for the port's bit
// kernels.  Replaces lifeapi_tpu/ops/calibrate_pallas.py calibrate
// (_calib_kernel).  Called through ctypes from
// lifeapi_tpu_torch/ops/calibrate_cuda.py, which holds the plain twin and
// the op count.
//
// Layout: a, b, out are [B, 64] words, one warp per row of 64 words, lane l
// holding words l and l + 32 (the port's board layout, warp_board.cuh).
// Each lane runs two independent chains (its two words).  Per iteration and
// word: 4 units of a ^= b << 1; b += a >> 3 (16 ops, the "elemwise" mix);
// the "rolls" mix first rolls a by +1 and b by -1 along the 64 words, a
// shuffle and a wrap select per word each (4 more ops), in place of the TPU
// kernel's two sublane rolls.  Every step depends on the one before and
// the output a ^ b on every step, so the compiler can drop nothing.
//
// Bound: integer and shuffle issue; device memory sees 24 bytes per word
// per call whatever the iteration count.  Many independent warps (one per
// row) hide each chain's latency.  The word is the port's u64 (the TPU
// kernel's is u32; the plain twin runs both).

#include "warp_board.cuh"

namespace {

using warp_board::kFullMask;

constexpr int kWarpsPerBlock = 8;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;

// Word i takes word i - 1 (up) or i + 1 (down) of the 64, with the wrap at
// lanes 0 and 31 swapping the lane's two registers (warp_board.cuh).
__device__ __forceinline__ void roll(u64& lo, u64& hi, int lane, bool up) {
  const int src = up ? (lane + 31) & 31 : (lane + 1) & 31;
  const bool wrap = up ? lane == 0 : lane == 31;
  const u64 l = __shfl_sync(kFullMask, lo, src);
  const u64 h = __shfl_sync(kFullMask, hi, src);
  lo = wrap ? h : l;
  hi = wrap ? l : h;
}

template <bool kRolls>
__global__ void __launch_bounds__(kThreadsPerBlock)
calibrate_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                 u64* __restrict__ out, int B, int iters) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;
  const size_t at = static_cast<size_t>(row) * 64 + lane;
  u64 a_lo = a[at], a_hi = a[at + 32], b_lo = b[at], b_hi = b[at + 32];
  for (int i = 0; i < iters; ++i) {
    if (kRolls) {
      roll(a_lo, a_hi, lane, true);
      roll(b_lo, b_hi, lane, false);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a_lo ^= b_lo << 1;
      b_lo += a_lo >> 3;
      a_hi ^= b_hi << 1;
      b_hi += a_hi >> 3;
    }
  }
  out[at] = a_lo ^ b_lo;
  out[at + 32] = a_hi ^ b_hi;
}

template <bool kRolls>
cudaError_t launch(const void* a, const void* b, void* out, int B, int iters,
                   cudaStream_t stream) {
  calibrate_kernel<kRolls><<<(B + kWarpsPerBlock - 1) / kWarpsPerBlock,
                             kThreadsPerBlock, 0, stream>>>(
      static_cast<const u64*>(a), static_cast<const u64*>(b), static_cast<u64*>(out),
      B, iters);
  return cudaGetLastError();
}

}  // namespace

// a, b, out: [B, 64] u64 words.  Runs on the caller's stream, does not
// synchronise, allocates nothing, and returns the launch's cudaError_t.
extern "C" cudaError_t life_calibrate(const void* a, const void* b, void* out,
                                      int B, int iters, int rolls,
                                      cudaStream_t stream) {
  if (B <= 0 || iters < 0) return cudaErrorInvalidValue;
  return rolls ? launch<true>(a, b, out, B, iters, stream)
               : launch<false>(a, b, out, B, iters, stream);
}
