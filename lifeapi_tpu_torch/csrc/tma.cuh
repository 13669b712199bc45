// Hopper's asynchronous copies and barriers, shared by the kernels that take
// their inputs by TMA (soft_life.cu, solver_update.cu): cp.async.bulk copies
// of contiguous spans into shared memory, completing on an mbarrier that
// counts the bytes in, and the thread-block cluster's barrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

// polls of an mbarrier before a copy that never lands traps instead of hanging
constexpr unsigned kMaxPolls = 1u << 26;

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of this CTA's shared ``p`` in CTA ``rank``'s shared memory
__device__ __forceinline__ uint32_t cluster_address(const void* p, unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(shared_address(p)),
               "r"(rank));
  return out;
}

__device__ __forceinline__ void barriers_init(uint64_t* bars, int count) {
  for (int s = 0; s < count; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_address(bars + s))
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the barrier's current phase expects ``bytes`` more, and has its one arrival
__device__ __forceinline__ void expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// one contiguous span (16-byte aligned, a multiple of 16 bytes), global ->
// this CTA's shared memory, counted on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

// Wait for the phase of ``bar`` of the given parity to complete; at cluster
// scope where the partner's stores are counted on it.
template <bool kClusterScope>
__device__ __forceinline__ void wait_phase(uint64_t* bar, unsigned parity) {
  const uint32_t addr = shared_address(bar);
  for (unsigned polls = 0;; ++polls) {
    uint32_t done;
    if constexpr (kClusterScope) {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    } else {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    }
    if (done) return;
    if (polls == kMaxPolls) __trap();
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The cluster's barrier in two halves: a CTA arrives as it starts and waits
// before its first access to another CTA's shared memory, which then has
// started.  The arrival orders nothing, so the wait costs nothing once every
// CTA has come that far.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

}  // namespace tma
