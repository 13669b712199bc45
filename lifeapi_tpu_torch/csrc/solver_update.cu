// The SQP solve's per-iteration updates, hand-written for Hopper (sm_90a):
// conjugate gradients' update of a batch of systems and adam's step.  Built
// by lifeapi_tpu_torch/ops/_build.py with nvcc into the kernels' shared
// library and called through ctypes from lifeapi_tpu_torch/ops/solver_cuda.py,
// which holds each kernel's plain PyTorch twin.
//
// Replace no TPU kernel: the JAX package leaves conjugate gradients
// (jax.scipy.sparse.linalg.cg under jax.vmap, lifeapi_tpu/mpc/solver.py
// solve_sqp) and optax.adam (solve_gradient) to XLA, which fuses them.  Run
// eagerly, a CG iteration's update is about 19 launches and an adam step 14,
// each a pass over [C, T, 64, 64] float32 (34 MB at 64 candidates and
// horizon 32); here each is one launch.
//
// Bound: bytes.  The CG update reads x, r, p and A p and writes x, r and p
// (a few flops an element); adam reads the logits, the gradient and the two
// moments and writes the three.
//  * cg_update_kernel: a system on a cluster of kCgCluster CTAs, each a
//    contiguous share of its elements in 16-byte pieces (the few elements
//    before the system's first 16-byte boundary and after its last are held
//    by CTA 0's first six threads, one each).  An iteration is three steps
//    with a cluster-wide reduction between each two: <p, A p>; then
//    alpha = gamma / <p, A p>, x += alpha p, r -= alpha A p and <r', r'>;
//    then p = r' + (<r', r'> / gamma) p.  Each byte moves once: the CTA's
//    share of p and A p is copied into shared memory by TMA (two
//    cp.async.bulk copies on one mbarrier) and stays there across both
//    reductions; its share of x and r is loaded into registers (8 pieces a
//    thread) once the copies have landed, so those loads are in flight
//    while the first reduction waits, and r' stays there across the
//    second; x' and r' are stored before it.  (Asked for together with the
//    copies, x and r land with them and the first reduction waits with
//    nothing in flight: 4% longer over four whole waves on an H100.)  At
//    horizon 32 (n = 131,072) a share is 16,384 floats: 128 KB of shared
//    memory, one CTA of 512 threads an SM.  An H100 holds 15 such clusters
//    at once (120 SMs; its SMs do not group into 16 clusters of 8), so 64
//    systems are 4 waves of 15 and one of 4.  A share larger than a tile
//    (kCgTile pieces, 64 KB an array) is walked in tiles, each step reading
//    again what it needs.  The dot products are reduced in a fixed order: a
//    thread's pieces in four running sums (one for each lane of a piece),
//    a warp's butterfly, the CTA's warps in turn and the cluster's CTAs in
//    rank order through distributed shared memory, so every CTA holds the
//    same sum and a system's iterates are the same from run to run (the
//    order is not torch.sum's).  A converged system (<r, r> <= the stopping
//    level) returns at once and keeps its state, as the eager loop's
//    torch.where does.  The element updates round as the eager ops do
//    (alpha p, then x + that).
//  * adam_kernel: one elementwise pass, each operation rounded as the eager
//    ops round it on the card (a Python scalar cast to float32, a division
//    by a scalar a product with its float32 reciprocal, as aten's kernels
//    do), so it equals the eager update bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace tma;

constexpr int kCgCluster = 8;  // CTAs a system
constexpr int kCgThreads = 512;
// 16-byte pieces of p and of A p a CTA holds in shared memory: 64 KB each,
// a whole share at horizon 32
constexpr int kCgTile = 4096;
constexpr int kCgSlots = kCgTile / kCgThreads;  // a thread's pieces of a tile
constexpr int kCgBarrierBytes = 128;  // the mbarrier, ahead of the tiles
constexpr int kAdamThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The cluster's total of each thread's ``v``, in a fixed order, in every
// thread.  ``slots`` (kCgCluster floats) must not be reused by a later call:
// a CTA may still read its slots while a faster one writes the next call's.
__device__ __forceinline__ float cluster_sum(float v, float* warp_sums, float* slots) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int w = 0; w < kCgThreads / 32; ++w) sum += warp_sums[w];
    const unsigned rank = cluster.block_rank();
    for (int r = 0; r < kCgCluster; ++r) cluster.map_shared_rank(slots, r)[rank] = sum;
  }
  cluster.sync();
  float total = 0.0f;
  for (int r = 0; r < kCgCluster; ++r) total += slots[r];
  return total;
}

// x + a p and r - a p as the eager ops round them: the product, then the sum
__device__ __forceinline__ float add_scaled(float x, float a, float p) {
  return __fadd_rn(x, __fmul_rn(a, p));
}

__device__ __forceinline__ float sub_scaled(float r, float a, float p) {
  return __fsub_rn(r, __fmul_rn(a, p));
}

__device__ __forceinline__ float4 add_scaled(float4 x, float a, float4 p) {
  return make_float4(add_scaled(x.x, a, p.x), add_scaled(x.y, a, p.y), add_scaled(x.z, a, p.z),
                     add_scaled(x.w, a, p.w));
}

__device__ __forceinline__ float4 sub_scaled(float4 r, float a, float4 p) {
  return make_float4(sub_scaled(r.x, a, p.x), sub_scaled(r.y, a, p.y), sub_scaled(r.z, a, p.z),
                     sub_scaled(r.w, a, p.w));
}

// a piece's products into four running sums, one for each of its lanes
__device__ __forceinline__ void dot_into(float (&acc)[4], float4 a, float4 b) {
  acc[0] = fmaf(a.x, b.x, acc[0]);
  acc[1] = fmaf(a.y, b.y, acc[1]);
  acc[2] = fmaf(a.z, b.z, acc[2]);
  acc[3] = fmaf(a.w, b.w, acc[3]);
}

// Thread 0: ``pieces`` of p, and of A p where ``with_ap``, from piece ``at``
// of the share into the tiles in shared memory, counted on ``bar``.  Every
// thread has passed a barrier since its last read of the tiles.
__device__ __forceinline__ void fill_tiles(float4* p_s, float4* ap_s, const float4* p4,
                                           const float4* ap4, int at, int pieces, bool with_ap,
                                           uint64_t* bar) {
  const unsigned bytes = static_cast<unsigned>(pieces) * sizeof(float4);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  expect_bytes(bar, with_ap ? 2 * bytes : bytes);
  bulk_copy(p_s, p4 + at, bytes, bar);
  if (with_ap) bulk_copy(ap_s, ap4 + at, bytes, bar);
}

// a thread's pieces of a tile of ``v`` (from piece ``at`` of the share) into
// registers
__device__ __forceinline__ void load_slots(float4 (&out)[kCgSlots], const float4* v, int at,
                                           int pieces) {
#pragma unroll
  for (int m = 0; m < kCgSlots; ++m) {
    const int j = static_cast<int>(threadIdx.x) + m * kCgThreads;
    if (j < pieces) out[m] = v[at + j];
  }
}

// One iteration of conjugate gradients on system c of n elements, in place:
// alpha = gamma / <p, ap>, x += alpha p, r -= alpha ap, gamma' = <r, r>,
// p = r + (gamma' / gamma) p, gamma = gamma'; nothing where gamma <= stop.
// ap may be p (an identity operator): it is then copied once.  Every array
// starts on 16 bytes; ``tile`` is the pieces of each tile in shared memory.
__global__ void __launch_bounds__(kCgThreads, 1)
    cg_update_kernel(float* x, float* r, float* p, const float* ap, float* gamma,
                     const float* stop, long long n, int tile) {
  extern __shared__ __align__(128) unsigned char shared[];
  __shared__ float warp_sums[kCgThreads / 32];
  __shared__ float slots[2][kCgCluster];
  const long long c = blockIdx.x / kCgCluster;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const float g = gamma[c];
  if (!(g > stop[c])) return;  // the whole cluster: it keeps its state
  cluster_arrive_relaxed();

  // the system's elements [first, last): a head before its first 16-byte
  // boundary, the body in pieces, shared out by rank, a tail after the body
  const long long first = c * n, last = first + n;
  const long long body = min((first + 3) & ~3LL, last);
  const long long body_end = max(body, last & ~3LL);
  const long long all_pieces = (body_end - body) / 4;
  const long long piece0 = all_pieces * rank / kCgCluster;
  const int pieces = static_cast<int>(all_pieces * (rank + 1) / kCgCluster - piece0);
  const int tiles = (pieces + tile - 1) / tile;
  const bool resident = tiles <= 1;  // the share is read once
  float4* x4 = reinterpret_cast<float4*>(x + body) + piece0;
  float4* r4 = reinterpret_cast<float4*>(r + body) + piece0;
  float4* p4 = reinterpret_cast<float4*>(p + body) + piece0;
  const float4* ap4 = reinterpret_cast<const float4*>(ap + body) + piece0;

  // CTA 0's threads 0-2 hold the head's elements, threads 3-5 the tail's
  long long e = -1;
  if (rank == 0 && threadIdx.x < 6) {
    const long long at = threadIdx.x < 3 ? first + threadIdx.x : body_end + threadIdx.x - 3;
    if (at < (threadIdx.x < 3 ? body : last)) e = at;
  }
  const bool has_e = e >= 0;
  float ex = 0.0f, er = 0.0f, ep = 0.0f, eap = 0.0f;
  if (has_e) {
    ex = x[e];
    er = r[e];
    ep = p[e];
    eap = ap[e];
  }

  uint64_t* bar = reinterpret_cast<uint64_t*>(shared);
  float4* p_s = reinterpret_cast<float4*>(shared + kCgBarrierBytes);
  const bool alias = ap == p;
  float4* ap_s = alias ? p_s : p_s + tile;
  if (threadIdx.x == 0) barriers_init(bar, 1);
  __syncthreads();
  unsigned phase = 0;
  float4 xv[kCgSlots], rv[kCgSlots];

  // 1. <p, A p>; a resident share's x and r asked for once p and A p are in
  float acc[4] = {has_e ? ep * eap : 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < tiles; ++t) {
    const int at = t * tile, len = min(tile, pieces - at);
    if (t) __syncthreads();
    if (threadIdx.x == 0) fill_tiles(p_s, ap_s, p4, ap4, at, len, !alias, bar);
    wait_phase<false>(bar, phase);
    phase ^= 1;
    if (resident) {
      load_slots(xv, x4, 0, len);
      load_slots(rv, r4, 0, len);
    }
#pragma unroll
    for (int m = 0; m < kCgSlots; ++m) {
      const int j = static_cast<int>(threadIdx.x) + m * kCgThreads;
      if (j < len) dot_into(acc, p_s[j], ap_s[j]);
    }
  }
  cluster_wait();  // every CTA of the cluster has started
  const float alpha =
      g / cluster_sum((acc[0] + acc[1]) + (acc[2] + acc[3]), warp_sums, slots[0]);

  // 2. x += alpha p, r -= alpha A p and <r', r'>, x' and r' stored before
  // the reduction; r' kept
  if (has_e) {
    x[e] = add_scaled(ex, alpha, ep);
    er = sub_scaled(er, alpha, eap);
    r[e] = er;
  }
  float acc2[4] = {has_e ? er * er : 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < tiles; ++t) {
    const int at = t * tile, len = min(tile, pieces - at);
    if (!resident) {
      __syncthreads();
      if (threadIdx.x == 0) fill_tiles(p_s, ap_s, p4, ap4, at, len, !alias, bar);
      load_slots(xv, x4, at, len);
      load_slots(rv, r4, at, len);
      wait_phase<false>(bar, phase);
      phase ^= 1;
    }
#pragma unroll
    for (int m = 0; m < kCgSlots; ++m) {
      const int j = static_cast<int>(threadIdx.x) + m * kCgThreads;
      if (j < len) {
        x4[at + j] = add_scaled(xv[m], alpha, p_s[j]);
        rv[m] = sub_scaled(rv[m], alpha, ap_s[j]);
        r4[at + j] = rv[m];
        dot_into(acc2, rv[m], rv[m]);
      }
    }
  }
  const float next = cluster_sum((acc2[0] + acc2[1]) + (acc2[2] + acc2[3]), warp_sums, slots[1]);
  const float beta = next / g;

  // 3. p = r' + beta p
  if (has_e) p[e] = add_scaled(er, beta, ep);
  for (int t = 0; t < tiles; ++t) {
    const int at = t * tile, len = min(tile, pieces - at);
    if (!resident) {  // r' as this thread stored it, p again
      __syncthreads();
      if (threadIdx.x == 0) fill_tiles(p_s, ap_s, p4, ap4, at, len, false, bar);
      load_slots(rv, r4, at, len);
      wait_phase<false>(bar, phase);
      phase ^= 1;
    }
#pragma unroll
    for (int m = 0; m < kCgSlots; ++m) {
      const int j = static_cast<int>(threadIdx.x) + m * kCgThreads;
      if (j < len) p4[at + j] = add_scaled(rv[m], beta, p_s[j]);
    }
  }
  // every CTA of the cluster read gamma[c] before the cluster's barriers
  if (rank == 0 && threadIdx.x == 0) gamma[c] = next;
}

// adam's constants as the eager ops take them: the Python scalars cast to
// float32, the bias corrections 1 - b1^t and 1 - b2^t as the float32
// reciprocals aten multiplies by
struct AdamScalars {
  float one_b1, b1, one_b2, b2, inv_c1, inv_c2, eps, lr;
};

// One element: mu' = (1 - b1) g + b1 mu; nu' = ((1 - b2) g) g + b2 nu;
// logits' = logits - lr ((mu' / c1) / (sqrt(nu' / c2) + eps))
__device__ __forceinline__ void adam_step(float& logit, float g, float& mu, float& nu,
                                          const AdamScalars& k) {
  mu = __fadd_rn(__fmul_rn(k.one_b1, g), __fmul_rn(k.b1, mu));
  nu = __fadd_rn(__fmul_rn(__fmul_rn(k.one_b2, g), g), __fmul_rn(k.b2, nu));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(nu, k.inv_c2)), k.eps);
  logit = __fsub_rn(logit, __fmul_rn(k.lr, __fdiv_rn(__fmul_rn(mu, k.inv_c1), denom)));
}

// The elements in 16-byte pieces of 4 (every array starts on 16 bytes), the
// last n % 4 one at a time
__global__ void __launch_bounds__(kAdamThreads)
    adam_kernel(const float* __restrict__ logits, const float* __restrict__ grads,
                const float* __restrict__ mu, const float* __restrict__ nu,
                float* __restrict__ logits_out, float* __restrict__ mu_out,
                float* __restrict__ nu_out, long long n, AdamScalars k) {
  const long long first = blockIdx.x * static_cast<long long>(kAdamThreads) + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kAdamThreads;
  for (long long i = first; i < n / 4; i += step) {
    float4 l = reinterpret_cast<const float4*>(logits)[i];
    const float4 g = reinterpret_cast<const float4*>(grads)[i];
    float4 m = reinterpret_cast<const float4*>(mu)[i];
    float4 v = reinterpret_cast<const float4*>(nu)[i];
    adam_step(l.x, g.x, m.x, v.x, k);
    adam_step(l.y, g.y, m.y, v.y, k);
    adam_step(l.z, g.z, m.z, v.z, k);
    adam_step(l.w, g.w, m.w, v.w, k);
    reinterpret_cast<float4*>(logits_out)[i] = l;
    reinterpret_cast<float4*>(mu_out)[i] = m;
    reinterpret_cast<float4*>(nu_out)[i] = v;
  }
  for (long long i = n / 4 * 4 + first; i < n; i += step) {
    float l = logits[i], m = mu[i], v = nu[i];
    adam_step(l, grads[i], m, v, k);
    logits_out[i] = l;
    mu_out[i] = m;
    nu_out[i] = v;
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte pieces of p and of A p a CTA's tiles hold for systems of n
// elements: a whole share where it fits (a share is at most this many)
int cg_tile(long long n) {
  const long long share = (n / 4 + kCgCluster - 1) / kCgCluster;
  return static_cast<int>(share < 1 ? 1 : share < kCgTile ? share : kCgTile);
}

int cg_shared(int tile, bool alias) {
  return kCgBarrierBytes + (alias ? 1 : 2) * tile * static_cast<int>(sizeof(float4));
}

cudaLaunchConfig_t cg_config(unsigned systems, int shared, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCgCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(systems * kCgCluster);
  config.blockDim = dim3(kCgThreads);
  config.dynamicSmemBytes = shared;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

// One CG iteration of `count` systems of n elements each, every array
// [count, n] contiguous and starting on 16 bytes; gamma and stop [count]
extern "C" cudaError_t life_cg_update(float* x, float* r, float* p, const float* ap,
                                      float* gamma, const float* stop, int count, long long n,
                                      cudaStream_t stream) {
  if (count <= 0 || n <= 0) return cudaErrorInvalidValue;
  if (!aligned(x) || !aligned(r) || !aligned(p) || !aligned(ap))
    return cudaErrorMisalignedAddress;
  const int tile = cg_tile(n);
  const int shared = cg_shared(tile, ap == p);
  cudaError_t err =
      cudaFuncSetAttribute(cg_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cg_config(static_cast<unsigned>(count), shared, stream, &attr);
  err = cudaLaunchKernelEx(&config, cg_update_kernel, x, r, p, ap, gamma, stop, n, tile);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The CG update's launch shape for systems of n elements (A p apart from p,
// or p itself where ``ap_is_p``): info = threads a CTA, CTAs a system,
// dynamic shared bytes, pieces a tile, then the runtime occupancy
// calculator's resident CTAs an SM and clusters resident at once
extern "C" cudaError_t life_cg_update_info(long long n, int ap_is_p, int* info) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int tile = cg_tile(n);
  const int shared = cg_shared(tile, ap_is_p != 0);
  cudaError_t err =
      cudaFuncSetAttribute(cg_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return err;
  info[0] = kCgThreads;
  info[1] = kCgCluster;
  info[2] = shared;
  info[3] = tile;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[4], cg_update_kernel, kCgThreads,
                                                      shared);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = cg_config(1, shared, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(&info[5], cg_update_kernel, &config);
}

// One adam step over n elements into new arrays
extern "C" cudaError_t life_adam_update(const float* logits, const float* grads,
                                        const float* mu, const float* nu, float* logits_out,
                                        float* mu_out, float* nu_out, long long n,
                                        float one_b1, float b1, float one_b2, float b2,
                                        float inv_c1, float inv_c2, float eps, float lr,
                                        cudaStream_t stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  if (!aligned(logits) || !aligned(grads) || !aligned(mu) || !aligned(nu) ||
      !aligned(logits_out) || !aligned(mu_out) || !aligned(nu_out))
    return cudaErrorMisalignedAddress;
  const AdamScalars k = {one_b1, b1, one_b2, b2, inv_c1, inv_c2, eps, lr};
  const long long blocks = n / 4 / kAdamThreads + 1;
  const unsigned grid = static_cast<unsigned>(blocks < 132 * 8 ? blocks : 132 * 8);
  adam_kernel<<<grid, kAdamThreads, 0, stream>>>(logits, grads, mu, nu, logits_out, mu_out,
                                                 nu_out, n, k);
  return cudaGetLastError();
}
