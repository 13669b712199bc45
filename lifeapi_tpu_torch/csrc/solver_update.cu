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
//  * cg_update_kernel: a candidate's system on a cluster of kCgCluster CTAs,
//    each a contiguous share of its elements.  The two dot products a CG
//    iteration needs (<p, A p> for the step, <r', r'> for the next
//    direction) are reduced in a fixed order, a thread's elements in turn,
//    a warp's butterfly, the CTA's warps in turn and the cluster's CTAs in
//    rank order through distributed shared memory, so every CTA holds the
//    same sum and a candidate's iterates are the same from run to run.  A
//    converged candidate (<r, r> <= the stopping level) returns at once and
//    keeps its state, as the eager loop's torch.where does.  The element
//    updates round as the eager ops do (alpha p, then x + that); the dot
//    products sum in another order than torch.sum.
//  * adam_kernel: one elementwise pass, each operation rounded as the eager
//    ops round it on the card (a Python scalar cast to float32, a division
//    by a scalar a product with its float32 reciprocal, as aten's kernels
//    do), so it equals the eager update bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kCgCluster = 8;  // CTAs a candidate
constexpr int kCgThreads = 512;
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

// One iteration of conjugate gradients on candidate c's system of n
// elements, in place: alpha = gamma / <p, ap>, x += alpha p, r -= alpha ap,
// gamma' = <r, r>, p = r + (gamma' / gamma) p, gamma = gamma'; nothing where
// gamma <= stop.  ap may alias p (an identity operator): each element is
// read and written by one thread only, reads first.
__global__ void __launch_bounds__(kCgThreads)
    cg_update_kernel(float* x, float* r, float* p, const float* ap, float* gamma,
                     const float* stop, long long n) {
  __shared__ float warp_sums[kCgThreads / 32];
  __shared__ float slots[2][kCgCluster];
  const long long c = blockIdx.x / kCgCluster;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const float g = gamma[c];
  if (!(g > stop[c])) return;  // the whole cluster: it keeps its state
  const long long lo = c * n + n * rank / kCgCluster;
  const long long hi = c * n + n * (rank + 1) / kCgCluster;
  float acc = 0.0f;
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += kCgThreads) acc = fmaf(p[i], ap[i], acc);
  const float alpha = g / cluster_sum(acc, warp_sums, slots[0]);
  acc = 0.0f;
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += kCgThreads) {
    const float pi = p[i], api = ap[i];
    x[i] = __fadd_rn(x[i], __fmul_rn(alpha, pi));
    const float ri = __fsub_rn(r[i], __fmul_rn(alpha, api));
    r[i] = ri;
    acc = fmaf(ri, ri, acc);
  }
  const float next = cluster_sum(acc, warp_sums, slots[1]);
  const float beta = next / g;
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += kCgThreads)
    p[i] = __fadd_rn(r[i], __fmul_rn(beta, p[i]));
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

}  // namespace

// One CG iteration of `count` systems of n elements each, every array
// [count, n] contiguous; gamma and stop [count]
extern "C" cudaError_t life_cg_update(float* x, float* r, float* p, const float* ap,
                                      float* gamma, const float* stop, int count, long long n,
                                      cudaStream_t stream) {
  if (count <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCgCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(count) * kCgCluster);
  config.blockDim = dim3(kCgThreads);
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, cg_update_kernel, x, r, p, ap, gamma, stop, n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
