// Still-life constraint propagation and the whole beam completion search on
// 64x64 torus boards, hand-written for Hopper (sm_90a).  Built by
// lifeapi_tpu_torch/ops/_build.py with nvcc into a shared library with a
// plain C interface and called through ctypes from
// lifeapi_tpu_torch/ops/stable_cuda.py, which holds each kernel's plain
// PyTorch twin.
//
// A board of the solver is 10 planes in device memory, int64[10, 64]: state,
// unknown and the 8 ruled-option planes (live2, live3, dead0, dead1, dead2,
// dead4, dead5, dead6; bit set = option ruled out), each one 64-bit word per
// column (warp_board.cuh).  The circuits are those of
// lifeapi_tpu/stable/bitplane.py, gate for gate, and the step is the TPU
// kernel's fused step (lifeapi_tpu/ops/stable_pallas.py _step_planes).
//
// Design, shared by the four kernels:
//  * One warp holds one board: lane l keeps columns l and l + 32 of each
//    plane, 10 x 2 u64 = 40 registers, for the whole fixpoint.  Device
//    memory sees the 5 KB board once in and once out per call; the TPU
//    kernels get the same from holding the batch tile in VMEM.
//  * Per-cell circuits run on the lane's own two words.  The cross-cell
//    primitives are the 9-count (vertical 3-sum by rotates, horizontal sum
//    by shuffles of the 3-sum bit planes, then two carry-save adds) and the
//    hollow ZOI (rotate plus shuffle dilation).
//  * The per-board OR of the changed and abort cells is __any_sync, so every
//    warp runs its own fixpoint loop; the TPU's per-tile loop until the
//    slowest board converges gives the same result board by board.
//  * Bound: integer instruction throughput, about 700 64-bit logic ops per
//    lane per step (each two 32-bit ALU instructions) and 16 shuffles.
//    Registers, not bytes, are the scarce resource: kernels B and C need the
//    board twice (a step that aborts keeps the planes it started from) plus
//    the counts and circuit temporaries; kernel D needs it once and is held
//    to 128 registers for occupancy.  The compiler's report is kept beside
//    the library.

#include "warp_board.cuh"

namespace {

using warp_board::from_left;
using warp_board::from_right;
using warp_board::kFullMask;
using warp_board::rotl1;
using warp_board::rotr1;

constexpr int kPlanes = 10;
constexpr int kBoardWords = kPlanes * 64;
constexpr int kWarpsPerBlock = 4;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;
constexpr int kLeafSentinel = 1 << 20;  // > every leaf key pop * 16 + slot
constexpr int kSeedGrowthCap = 33;      // 32 dilations cover the torus
constexpr int kInt32Max = 0x7fffffff;

constexpr u64 kOnes = ~0ull;

// A lane's share of a board: p[plane][h], h = 0 for column lane, 1 for
// column lane + 32.  Plane 0 = state, 1 = unknown, 2 + i = ruled option i.
struct Board {
  u64 p[kPlanes][2];
};

// A 4-bit value per cell, bit-sliced LSB first.
struct Nib {
  u64 b[4];
};

// -- option table (lifeapi_tpu/stable/bitplane.py OPTIONS) --------------------

// Neighbour count of option i: live2, live3, dead0, dead1, dead2, dead4,
// dead5, dead6.
__device__ __forceinline__ constexpr int option_count(int i) {
  return i == 0 ? 2 : i == 1 ? 3 : i == 2 ? 0 : i == 3 ? 1 : i == 4 ? 2 : i - 1;
}
__device__ __forceinline__ constexpr bool option_live(int i) { return i < 2; }

// -- nibble arithmetic (lifeapi_tpu/stable/nibble.py) -------------------------

__device__ __forceinline__ Nib nib_const(int k) {
  Nib o;
#pragma unroll
  for (int i = 0; i < 4; ++i) o.b[i] = (k >> i) & 1 ? kOnes : 0;
  return o;
}

__device__ __forceinline__ Nib nib_add(const Nib& x, const Nib& y) {
  Nib o;
  u64 carry = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o.b[i] = x.b[i] ^ y.b[i] ^ carry;
    carry = (x.b[i] & y.b[i]) | (carry & (x.b[i] ^ y.b[i]));
  }
  return o;
}

__device__ __forceinline__ Nib nib_sub(const Nib& x, const Nib& y) {
  Nib o;
  u64 borrow = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o.b[i] = x.b[i] ^ y.b[i] ^ borrow;
    borrow = (~x.b[i] & (y.b[i] | borrow)) | (x.b[i] & y.b[i] & borrow);
  }
  return o;
}

__device__ __forceinline__ Nib nib_sub_bit(const Nib& x, u64 bit) {
  Nib o;
  u64 borrow = bit;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o.b[i] = x.b[i] ^ borrow;
    borrow = ~x.b[i] & borrow;
  }
  return o;
}

__device__ __forceinline__ u64 eq_const(const Nib& x, int k) {
  u64 acc = kOnes;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc &= (k >> i) & 1 ? x.b[i] : ~x.b[i];
  return acc;
}

__device__ __forceinline__ u64 gt_const(const Nib& x, int k) {
  u64 gt = 0, eq = kOnes;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    if ((k >> i) & 1) {
      eq &= x.b[i];
    } else {
      gt |= eq & x.b[i];
      eq &= ~x.b[i];
    }
  }
  return gt;
}

__device__ __forceinline__ u64 le_const(const Nib& x, int k) { return ~gt_const(x, k); }

// -- circuit helpers (lifeapi_tpu/stable/bitplane.py) -------------------------

// out[c] = x > c for c = 0..6 (_gt_thresholds7).
__device__ __forceinline__ void gt_thresholds7(const Nib& x, u64 out[7]) {
  const u64 b0 = x.b[0], b1 = x.b[1], b2 = x.b[2], b3 = x.b[3];
  const u64 or01 = b1 | b0, and10 = b1 & b0, hi = b2 | b3;
  out[0] = hi | or01;
  out[1] = hi | b1;
  out[2] = hi | and10;
  out[3] = hi;
  out[4] = b3 | (b2 & or01);
  out[5] = b3 | (b2 & b1);
  out[6] = b3 | (b2 & and10);
}

// Per-option ruled-out planes from the interval [A, AU] and the center's
// three-state (_maximal_ruled_planes).
__device__ __forceinline__ void maximal_ruled(const Nib& A, const Nib& AU, u64 center_on,
                                              u64 known_off, u64 out[8]) {
  u64 gtA[7], geAU[7];
  gt_thresholds7(A, gtA);
  gt_thresholds7(AU, geAU);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int cnt = option_count(i);
    u64 r = gtA[cnt];
    if (cnt > 0) r |= ~geAU[cnt - 1];
    out[i] = r | (option_live(i) ? known_off : center_on);
  }
}

// Options of neighbour count c (_BY_COUNT), as a possibility plane.
__device__ __forceinline__ u64 count_class(const u64 possible[8], int c) {
  switch (c) {
    case 0: return possible[2];
    case 1: return possible[3];
    case 2: return possible[0] | possible[4];
    case 3: return possible[1];
    default: return possible[c + 1];
  }
}

__device__ __forceinline__ u64 single_count(const u64 possible[8]) {
  u64 any = 0, two = 0;
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    const u64 p = count_class(possible, c);
    two |= any & p;
    any |= p;
  }
  return ~two;
}

__device__ __forceinline__ u64 and_ruled(const Board& P, int h, int from) {
  u64 acc = kOnes;
#pragma unroll
  for (int i = from; i < 8; ++i) acc &= P.p[2 + i][h];
  return acc;
}

// -- the step's circuits, on half h of the lane's board -----------------------

// sync_circuit, in place; returns abort and change cells.
__device__ __forceinline__ void sync_half(Board& P, int h, u64& abort, u64& changes) {
  u64& s = P.p[0][h];
  u64& u = P.p[1][h];
  const u64 known_on = ~u & s;
  const u64 known_off = ~u & ~s;
  const u64 maybe_dead_b = ~and_ruled(P, h, 2);
  const u64 maybe_live_b = ~(P.p[2][h] & P.p[3][h]);
  changes = (maybe_dead_b & known_on) | (maybe_live_b & known_off);
  P.p[2][h] |= known_off;
  P.p[3][h] |= known_off;
#pragma unroll
  for (int i = 2; i < 8; ++i) P.p[2 + i][h] |= known_on;
  const u64 maybe_dead = ~and_ruled(P, h, 2);
  const u64 maybe_live = ~(P.p[2][h] & P.p[3][h]);
  abort = ~maybe_live & ~maybe_dead;
  const u64 forced_on = maybe_live & ~maybe_dead;
  changes |= ~s & forced_on;
  s |= forced_on;
  const u64 still_unknown = maybe_live & maybe_dead;
  changes |= u & ~still_unknown;
  u &= still_unknown;
}

// update_circuit_interval, in place on the ruled planes.
__device__ __forceinline__ void update_half(Board& P, int h, const Nib& A, const Nib& AU,
                                            u64& abort, u64& changes) {
  const u64 s = P.p[0][h], u = P.p[1][h];
  u64 out[8];
  maximal_ruled(A, AU, s, ~s & ~u, out);
  abort = kOnes;
#pragma unroll
  for (int i = 0; i < 8; ++i) abort &= out[i];
  changes = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const u64 add = out[i] & ~abort;
    changes |= add & ~P.p[2 + i][h];
    P.p[2 + i][h] |= add;
  }
}

// signal_circuit_post: (signal_on, signal_off, center_on_force,
// center_off_force) on post-update ruled planes.
__device__ __forceinline__ void signal_half(const Board& P, int h, const Nib& A, const Nib& U,
                                            const Nib& AU, u64& son, u64& soff, u64& con,
                                            u64& coff) {
  const u64 s = P.p[0][h], u = P.p[1][h];
  const u64 known_off = ~s & ~u;
  u64 possible[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) possible[i] = ~P.p[2 + i][h];
  const u64 o_ok = ~and_ruled(P, h, 0);
  u64 gtA[7], gtAU[7];
  gt_thresholds7(A, gtA);
  gt_thresholds7(AU, gtAU);
  u64 has_above = count_class(possible, 1) & ~gtA[0];
  u64 has_below = count_class(possible, 0) & gtAU[0];
#pragma unroll
  for (int c = 2; c < 7; ++c) has_above |= count_class(possible, c) & ~gtA[c - 1];
#pragma unroll
  for (int c = 1; c < 7; ++c) has_below |= count_class(possible, c) & gtAU[c];
  const u64 maybe_live = possible[0] | possible[1];
  const u64 maybe_dead = possible[2] | possible[3] | possible[4] | possible[5] |
                         possible[6] | possible[7];
  const u64 conflict = (s & maybe_dead & ~maybe_live) | (known_off & maybe_live & ~maybe_dead);
  const u64 guards = ~eq_const(U, 0) & o_ok & ~conflict;
  soff = guards & ~has_above;
  son = guards & ~has_below & ~soff;
  const u64 cen_guards = u & o_ok;
  con = cen_guards & maybe_live & ~maybe_dead;
  coff = cen_guards & maybe_dead & ~maybe_live;
}

// -- cross-cell primitives ---------------------------------------------------

// Inclusive 9-cell window counts of a plane's two columns (_count9).
__device__ __forceinline__ void count9(const u64 x[2], int lane, Nib out[2]) {
  u64 c0[2], c1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const u64 a = x[h], l = rotl1(a), r = rotr1(a);
    c0[h] = l ^ r ^ a;
    c1[h] = ((l ^ r) & a) | (l & r);
  }
  u64 u0[2], u1[2], d0[2], d1[2];
  from_left(c0[0], c0[1], lane, u0[0], u0[1]);
  from_left(c1[0], c1[1], lane, u1[0], u1[1]);
  from_right(c0[0], c0[1], lane, d0[0], d0[1]);
  from_right(c1[0], c1[1], lane, d1[0], d1[1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const u64 uc0 = u0[h] ^ c0[h], uc_carry = u0[h] & c0[h];
    const u64 t = u1[h] ^ c1[h];
    const u64 uc1 = t ^ uc_carry, uc2 = (u1[h] & c1[h]) | (uc_carry & t);
    const u64 on0 = uc0 ^ d0[h], on_carry0 = uc0 & d0[h];
    const u64 v = uc1 ^ d1[h];
    const u64 on1 = v ^ on_carry0, on_carry1 = (uc1 & d1[h]) | (on_carry0 & v);
    out[h].b[0] = on0;
    out[h].b[1] = on1;
    out[h].b[2] = uc2 ^ on_carry1;
    out[h].b[3] = uc2 & on_carry1;
  }
}

// 8-neighbour dilation without the center (_zoi_hollow).
__device__ __forceinline__ void zoi_hollow(const u64 x[2], int lane, u64 out[2]) {
  u64 t[2], mid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mid[h] = rotl1(x[h]) | rotr1(x[h]);
    t[h] = x[h] | mid[h];
  }
  u64 a[2], b[2];
  from_left(t[0], t[1], lane, a[0], a[1]);
  from_right(t[0], t[1], lane, b[0], b[1]);
  out[0] = a[0] | b[0] | mid[0];
  out[1] = a[1] | b[1] | mid[1];
}

// -- the fused step (_step_planes) --------------------------------------------

// One propagation step of the warp's board, in place; changed and abort are
// the lane's cell-level masks.
__device__ __forceinline__ void stable_step(Board& P, int lane, u64 changed[2], u64 abort[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) sync_half(P, h, abort[h], changed[h]);

  // Two 9-counts per step: signal's counts follow from update's, since state
  // and unknown are disjoint (count9(state | unknown) == on9 + unk9).
  Nib on9[2], unk9[2];
  count9(P.p[0], lane, on9);
  count9(P.p[1], lane, unk9);

  u64 son[2], soff[2], con[2], coff[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Nib A = nib_sub_bit(on9[h], P.p[0][h]);
    const Nib U = nib_sub_bit(unk9[h], P.p[1][h]);
    const Nib AU = nib_add(A, U);
    u64 ab, ch;
    update_half(P, h, A, AU, ab, ch);
    abort[h] |= ab;
    changed[h] |= ch;
    signal_half(P, h, A, U, AU, son[h], soff[h], con[h], coff[h]);
  }

  u64 offz[2], onz[2];
  zoi_hollow(soff, lane, offz);
  zoi_hollow(son, lane, onz);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    offz[h] |= coff[h];
    onz[h] |= con[h];
    u64& s = P.p[0][h];
    u64& u = P.p[1][h];
    // both signals on a still-unknown cell (LifeStable.hpp:666-667)
    abort[h] |= offz[h] & onz[h] & u;
    const u64 off_cells = offz[h] & u;
    s &= ~off_cells;
    u &= ~off_cells;
    P.p[2][h] |= off_cells;
    P.p[3][h] |= off_cells;
    const u64 on_cells = onz[h] & u;
    s |= on_cells;
    u &= ~on_cells;
#pragma unroll
    for (int i = 2; i < 8; ++i) P.p[2 + i][h] |= on_cells;
    changed[h] |= off_cells | on_cells;
  }
}

// The masked fixpoint (_run_fixpoint) of the warp's board: a step that
// aborts leaves the planes as they were before it and stops the board, a
// step that changes nothing stops it.  Returns whether the board aborted;
// changed_ever says whether any applied or aborting step changed a cell.
__device__ __forceinline__ bool fixpoint(Board& P, int lane, int max_iters,
                                         bool& changed_ever) {
  bool aborted = false, alive = true;
  changed_ever = false;
  for (int it = 0; alive && it < max_iters; ++it) {
    Board next = P;
    u64 changed[2], abort[2];
    stable_step(next, lane, changed, abort);
    const bool a = __any_sync(kFullMask, (abort[0] | abort[1]) != 0);
    const bool c = __any_sync(kFullMask, (changed[0] | changed[1]) != 0);
    if (!a) P = next;
    aborted |= a;
    changed_ever |= c;
    alive = !a && c;
  }
  return aborted;
}

// -- branch priorities (_priority_planes) -------------------------------------

// _is_forced of vulnerable_circuit: the cell's options are decided under the
// hypothetical center (c_on, c_off, c_unk) and interval [A_, A_ + U_].
__device__ __forceinline__ u64 is_forced(const Board& P, int h, u64 c_on, u64 c_off, u64 c_unk,
                                         const Nib& A_, const Nib& U_) {
  u64 o2[8];
  maximal_ruled(A_, nib_add(A_, U_), c_on, c_off, o2);
  u64 impossible = kOnes;
  u64 possible[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o2[i] |= P.p[2 + i][h];
    impossible &= o2[i];
    possible[i] = ~o2[i];
  }
  const u64 decided = single_count(possible);
  const u64 maybe_live = possible[0] | possible[1];
  const u64 maybe_dead = possible[2] | possible[3] | possible[4] | possible[5] |
                         possible[6] | possible[7];
  return impossible | decided | (c_unk & (maybe_live ^ maybe_dead));
}

// vulnerable_circuit on half h: (v_on, v_off, vc_on, vc_off).
__device__ __forceinline__ void vulnerable_half(const Board& P, int h, const Nib& on9,
                                                const Nib& unk9, u64& v_on, u64& v_off,
                                                u64& vc_on, u64& vc_off) {
  const u64 s = P.p[0][h], u = P.p[1][h];
  const u64 known_off = ~s & ~u;
  const Nib A = nib_sub_bit(on9, s);
  const Nib U = nib_sub_bit(unk9, u);
  const Nib one = nib_const(1);
  const Nib U_less = nib_sub(U, one);
  const u64 f_on = is_forced(P, h, s, known_off, u, nib_add(A, one), U_less);
  const u64 f_off = is_forced(P, h, s, known_off, u, A, U_less);
  const u64 neigh_ok = ~((~u & le_const(U, 1)) | (u & eq_const(U, 0)));
  v_on = neigh_ok & f_on;
  v_off = neigh_ok & f_off;
  const u64 cen_ok = u & ~eq_const(U, 0);
  vc_on = cen_ok & is_forced(P, h, kOnes, 0, 0, A, U);
  vc_off = cen_ok & is_forced(P, h, 0, kOnes, 0, A, U);
}

// The 4 branch-priority levels of the warp's board, highest first:
// vulnerable, exactly-2-unknown window, exactly-3-unknown window, settable.
__device__ __forceinline__ void priority(const Board& P, int lane, u64 levels[4][2]) {
  Nib on9[2], unk9[2];
  count9(P.p[0], lane, on9);
  count9(P.p[1], lane, unk9);
  u64 v_on[2], v_off[2], vc_on[2], vc_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    vulnerable_half(P, h, on9[h], unk9[h], v_on[h], v_off[h], vc_on[h], vc_off[h]);
  u64 onz[2], offz[2], dz[2];
  zoi_hollow(v_on, lane, onz);
  zoi_hollow(v_off, lane, offz);
  zoi_hollow(P.p[4], lane, dz);  // dead0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const u64 vuln = (onz[h] | vc_on[h]) & (offz[h] | vc_off[h]);
    u64 perturbed = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) perturbed |= P.p[2 + i][h];
    const u64 settable = (dz[h] | P.p[4][h]) & perturbed & P.p[1][h];
    levels[0][h] = vuln & settable;
    levels[1][h] = settable & eq_const(unk9[h], 2);
    levels[2][h] = settable & eq_const(unk9[h], 3);
    levels[3][h] = settable;
  }
}

// -- board I/O -----------------------------------------------------------------

__device__ __forceinline__ void load_board(Board& P, const u64* src, int lane) {
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) {
    P.p[i][0] = src[i * 64 + lane];
    P.p[i][1] = src[i * 64 + 32 + lane];
  }
}

__device__ __forceinline__ void store_board(const Board& P, u64* dst, int lane) {
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) {
    dst[i * 64 + lane] = P.p[i][0];
    dst[i * 64 + 32 + lane] = P.p[i][1];
  }
}

// -- kernels A-C ---------------------------------------------------------------

// Kernel A.  Replaces lifeapi_tpu/ops/stable_pallas.py propagate_step_planes
// (_step_kernel): one fused step of every board, with the cell-level changed
// and abort masks.  Bound: integer instruction throughput (one step, ~700
// logic ops per lane) against 5 KB in and 6 KB out per board, so a call is
// close to the bytes bound.  A loop over it pays those bytes, and on the
// host a readback, every step: propagate_fused (stable_pallas.py's loop over
// this kernel) launches kernel B instead.
__global__ void __launch_bounds__(kThreadsPerBlock)
step_kernel(const u64* __restrict__ in, u64* __restrict__ out, u64* __restrict__ changed,
            u64* __restrict__ abort, int B) {
  const int lane = threadIdx.x & 31;
  const int board = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (board >= B) return;
  Board P;
  load_board(P, in + static_cast<size_t>(board) * kBoardWords, lane);
  u64 ch[2], ab[2];
  stable_step(P, lane, ch, ab);
  store_board(P, out + static_cast<size_t>(board) * kBoardWords, lane);
  const size_t at = static_cast<size_t>(board) * 64 + lane;
  changed[at] = ch[0];
  changed[at + 32] = ch[1];
  abort[at] = ab[0];
  abort[at + 32] = ab[1];
}

// -- kernels B and C: the whole fixpoint --------------------------------------

// N planes of a batch of boards where they lie in device memory: plane i of
// board b is the 64 words at p[i] + b * stride[i].  Passed by value, so the
// pointers and strides are read from the kernel's parameter bank.  A board
// stride of 640 is the board-major int64[B, 10, 64] of the planes API, 64 a
// plane of its own (a BitStable's).  The strides are 32-bit, so a plane's
// address is one wide multiply and one shifted 64-bit add.
template <int N>
struct PlaneSet {
  u64* p[N];
  int stride[N];
};

template <int N>
__device__ __forceinline__ void load_planes(u64 (*w)[2], const PlaneSet<N>& src, int b,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const u64* s = src.p[i] + static_cast<long long>(b) * src.stride[i];
    w[i][0] = s[lane];
    w[i][1] = s[lane + 32];
  }
}

template <int N>
__device__ __forceinline__ void store_planes(const u64 (*w)[2], const PlaneSet<N>& dst, int b,
                                             int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    u64* d = dst.p[i] + static_cast<long long>(b) * dst.stride[i];
    d[lane] = w[i][0];
    d[lane + 32] = w[i][1];
  }
}

// Kernel B (kPriorities false).  Replaces stable_pallas.py
// propagate_fused_inkernel (_fixpoint_kernel): the whole fixpoint of every
// board.  Kernel C (kPriorities true).  Replaces stable_pallas.py
// propagate_fused_beam_planes (_fixpoint_beam_kernel): kernel B, then the
// branch priorities of the result (another ~1000 instructions a lane, once).
//
// One warp a board, 4 a block.  The planes come and go where they lie
// (PlaneSet), so a BitStable's separate planes need no stacking.
//
// Bound: the bytes (5 KB in, 5 KB out, and C's 2 KB of levels a board) and
// the SASS instructions over the issue peak (about 870 a board-step, about
// 3 steps a board on the solver's fixpoint set, 1050 for C's priorities)
// are nearly equal, but 84% of a step's instructions are LOP3s, which a
// scheduler issues at most every other clock: the kernel is held by the
// integer pipe, not by memory.  Persistent warps at 16 an SM that stage the
// next board by cp.async and keep the planes to roll back to in shared
// memory were measured slower on the card in every variant (PERF.md,
// section 6): the step run in place compiles to about 20 more LOP3s than
// the step run on a copy, and staging buys nothing where memory is not the
// limit.  So the step runs on a copy, at about 168 registers and 12 warps
// an SM.
template <bool kPriorities>
__global__ void __launch_bounds__(kThreadsPerBlock)
fixpoint_kernel(const PlaneSet<kPlanes> in, const PlaneSet<kPlanes> out,
                const PlaneSet<4> levels, uint8_t* __restrict__ flags, int B,
                int max_iters) {
  const int lane = threadIdx.x & 31;
  const int board = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (board >= B) return;
  Board P;
  load_planes<kPlanes>(P.p, in, board, lane);
  bool changed_ever;
  const bool aborted = fixpoint(P, lane, max_iters, changed_ever);
  store_planes<kPlanes>(P.p, out, board, lane);
  if (lane == 0) {
    flags[board] = aborted ? 0 : 1;          // consistent
    flags[B + board] = changed_ever ? 1 : 0;  // changed
  }
  if (kPriorities) {
    u64 lv[4][2];
    priority(P, lane, lv);
    store_planes<4>(lv, levels, board, lane);
  }
}

// -- kernel D: the whole beam search -----------------------------------------

// Seed-proximity restriction (reference useSeed, LifeStable.hpp:1366-1375)
// of an ok slot's levels: grow the seed's ZOI until it touches the settable
// set (at most 33 times), then intersect every level with it.  An empty
// seed leaves the levels as they are.
__device__ __forceinline__ void seed_restrict(u64 levels[4][2], const u64 seed[2], int lane) {
  const bool has_set = __any_sync(kFullMask, (levels[3][0] | levels[3][1]) != 0);
  const bool seed_empty = !__any_sync(kFullMask, (seed[0] | seed[1]) != 0);
  u64 sz[2] = {seed_empty ? kOnes : seed[0], seed_empty ? kOnes : seed[1]};
  for (int it = 0; it < kSeedGrowthCap; ++it) {
    const bool touches =
        __any_sync(kFullMask, ((levels[3][0] & sz[0]) | (levels[3][1] & sz[1])) != 0);
    if (!has_set || touches) break;
    u64 z[2];
    zoi_hollow(sz, lane, z);
    sz[0] |= z[0];
    sz[1] |= z[1];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    levels[j][0] &= sz[0];
    levels[j][1] &= sz[1];
  }
}

// The branch cell of the warp's board: the first cell (lowest column, then
// lowest row) of the highest nonempty level.  Returns the column, or -1 when
// every level is empty; `bit` is the row.
__device__ __forceinline__ int branch_cell(const u64 levels[4][2], int& bit) {
  u64 c0 = levels[3][0], c1 = levels[3][1];
#pragma unroll
  for (int k = 2; k >= 0; --k) {
    if (__any_sync(kFullMask, (levels[k][0] | levels[k][1]) != 0)) {
      c0 = levels[k][0];
      c1 = levels[k][1];
    }
  }
  const unsigned lo = __ballot_sync(kFullMask, c0 != 0);
  const unsigned hi = __ballot_sync(kFullMask, c1 != 0);
  const int src = __ffs(lo ? lo : hi) - 1;
  const u64 word = __shfl_sync(kFullMask, lo ? c0 : c1, src < 0 ? 0 : src);
  bit = __ffsll(static_cast<long long>(word)) - 1;
  if (!lo && !hi) return -1;
  return lo ? src : 32 + src;
}

// The beam's fixpoint: fixpoint() without the rollback.  A slot whose step
// aborts is not ok, so none of its children is active and it is no round's
// leaf: its planes are never read again, and the step can run in place.
// Dropping the second board frees 40 registers a thread.
__device__ __forceinline__ bool fixpoint_in_place(Board& P, int lane, int max_iters,
                                                  bool alive) {
  bool aborted = false;
  for (int it = 0; alive && it < max_iters; ++it) {
    u64 changed[2], abort[2];
    stable_step(P, lane, changed, abort);
    aborted = __any_sync(kFullMask, (abort[0] | abort[1]) != 0);
    const bool changed_any = __any_sync(kFullMask, (changed[0] | changed[1]) != 0);
    alive = !aborted && changed_any;
  }
  return aborted;
}

// Kernel D.  Replaces lifeapi_tpu/ops/stable_pallas.py beam_search_planes
// (_beam_kernel), decision for decision: the entire beam search, one block
// per problem, one warp per frontier slot, F = kF a power of two in
// [2, 16].  Each round: the fixpoint per warp (in place, above);
// population (__popc and a warp reduce) and the bound; for the ok slots
// only (a slot that is not ok branches on nothing), the priorities, the
// seed restriction, the leaf test and the branch cell; then, across the
// block through shared memory, the harvest (key pop * 16 + slot, lowest
// slot on ties), the ranks of the 2F children (key score * 2F + child,
// child = slot for OFF and F + slot for ON, score pop or pop + 1 for ok
// slots and 1 << 20 otherwise), the drop accounting, and the gather: slot
// j loads the parent of the child ranked j from shared memory and applies
// its OFF/ON rule.  The harvest and the ranking run across the lanes of
// every warp, lane c holding child c (a warp min-reduce, and 2F shuffles
// of the keys per rank), so the cross-slot work is a few dozen
// instructions a round.
//
// Bound: the integer instructions of the fixpoints and the priorities, as
// for kernels B and C.  Occupancy hides their dependent LOP3 / SHFL chains
// and the slots that wait at the round's barriers for the longest
// fixpoint; the register budget sets it: __launch_bounds__ asks for 16
// warps an SM at every F (4 blocks at F = 4), which caps ptxas at 128
// registers a thread.  The round loop is block-uniform (it ends when no
// slot is active or after `iters` rounds) and every __syncthreads lies
// outside warp-divergent code.
constexpr int kBeamWarpsPerSM = 16;

template <int kF>
__global__ void __launch_bounds__(kF * 32, kBeamWarpsPerSM / kF)
beam_kernel(const u64* __restrict__ in, const u64* __restrict__ seed,
            const int* __restrict__ bound, u64* __restrict__ best_out,
            int* __restrict__ best_pop_out, uint8_t* __restrict__ found_out,
            uint8_t* __restrict__ complete_out, uint8_t* __restrict__ exhausted_out,
            int iters, bool minimise, int max_fix_iters) {
  extern __shared__ u64 parents[];  // [F][10][64]
  __shared__ u64 s_seed[64];
  __shared__ int s_pop[kF];
  __shared__ int s_ok[kF];    // ok after the leaf test
  __shared__ int s_leaf[kF];
  __shared__ int s_col[kF];   // branch cell column, -1 for none
  __shared__ int s_bit[kF];

  const int slot = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t problem = blockIdx.x;

  Board P;
  load_board(P, in + problem * kBoardWords, lane);
  const bool seeded = seed != nullptr;
  if (seeded && threadIdx.x < 64) s_seed[threadIdx.x] = seed[problem * 64 + threadIdx.x];
  u64* best = best_out + problem * 64;
  if (slot == 0) {
    best[lane] = 0;
    best[lane + 32] = 0;
  }
  __syncthreads();  // the seed is in
  // Block-wide state, computed identically by every thread.
  int best_pop = bound != nullptr ? bound[problem] : kInt32Max;
  bool found = false, complete = true, any_active = true;
  bool active = slot == 0;

  for (int it = 0; it < iters && any_active; ++it) {
    const bool aborted = fixpoint_in_place(P, lane, max_fix_iters, active);
    const int pop = static_cast<int>(__reduce_add_sync(
        kFullMask, static_cast<unsigned>(__popcll(P.p[0][0]) + __popcll(P.p[0][1]))));
    // population bound (reference LifeStable.hpp:1351-1355), or first
    // solution only
    const bool ok = active && !aborted && (minimise ? pop < best_pop : !found);
    bool leaf = false;
    int col = -1, bit = 0;
    if (ok) {  // warp-uniform
      u64 lv[4][2];
      priority(P, lane, lv);
      if (seeded) {
        const u64 sw[2] = {s_seed[lane], s_seed[lane + 32]};
        seed_restrict(lv, sw, lane);
      }
      leaf = !__any_sync(kFullMask, (lv[3][0] | lv[3][1]) != 0);
      if (!leaf) col = branch_cell(lv, bit);
    }
    if (lane == 0) {
      s_pop[slot] = pop;
      s_ok[slot] = ok && !leaf;
      s_leaf[slot] = leaf;
      s_col[slot] = col;
      s_bit[slot] = bit;
    }
    __syncthreads();

    // harvest: the round's best leaf, lowest slot on ties
    const int leaf_key = lane < kF && s_leaf[lane] ? s_pop[lane] * 16 + lane : kLeafSentinel;
    const int gmin = __reduce_min_sync(kFullMask, leaf_key);
    if (gmin < kLeafSentinel && (gmin >> 4) < best_pop) {
      if (slot == (gmin & 15)) {
        best[lane] = P.p[0][0];
        best[lane + 32] = P.p[0][1];
      }
      best_pop = gmin >> 4;
      found = true;
    }

    // rank the 2F children, lane c holding child c (of slot c mod F); slot j
    // takes the child ranked j.  An ok child ranked F or later is dropped:
    // the search is no longer exhaustive.
    const bool child_ok = lane < 2 * kF && s_ok[lane & (kF - 1)];
    const int key =
        (child_ok ? s_pop[lane & (kF - 1)] + (lane >= kF) : kLeafSentinel) * 2 * kF + lane;
    int rank = 0;
#pragma unroll
    for (int d = 0; d < 2 * kF; ++d) rank += __shfl_sync(kFullMask, key, d) < key;
    const int child = __ffs(__ballot_sync(kFullMask, lane < 2 * kF && rank == slot)) - 1;
    if (__any_sync(kFullMask, child_ok && rank >= kF)) complete = false;
    any_active = __any_sync(kFullMask, child_ok);
    const bool on = child >= kF;
    const int parent = child & (kF - 1);
    const int cell_col = s_col[parent];
    const int cell_bit = s_bit[parent];
    active = s_ok[parent] != 0;

    // gather: every slot's parent planes go through shared memory
    store_board(P, parents + slot * kBoardWords, lane);
    __syncthreads();
    if (parent != slot) load_board(P, parents + parent * kBoardWords, lane);
    const u64 m[2] = {cell_col == lane ? 1ull << cell_bit : 0,
                      cell_col == lane + 32 ? 1ull << cell_bit : 0};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      P.p[0][h] = on ? P.p[0][h] | m[h] : P.p[0][h] & ~m[h];
      P.p[1][h] &= ~m[h];
      // OFF rules out live2/live3, ON rules out every dead option
      if (on) {
#pragma unroll
        for (int i = 2; i < 8; ++i) P.p[2 + i][h] |= m[h];
      } else {
        P.p[2][h] |= m[h];
        P.p[3][h] |= m[h];
      }
    }
  }

  if (threadIdx.x == 0) {
    best_pop_out[problem] = best_pop;
    found_out[problem] = found;
    complete_out[problem] = complete;
    exhausted_out[problem] = !any_active;
  }
}

inline dim3 grid_for(int B) { return dim3((B + kWarpsPerBlock - 1) / kWarpsPerBlock); }

// beam_kernel<kF>'s dynamic shared memory, the F parent boards of a round,
// which the kernel is opted into (80 KB at F = 16).
template <int kF>
constexpr int beam_smem() { return kF * kBoardWords * static_cast<int>(sizeof(u64)); }

template <int kF>
cudaError_t configure_beam() {
  return cudaFuncSetAttribute(beam_kernel<kF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              beam_smem<kF>());
}

template <int kF>
cudaError_t launch_beam(const u64* in, const u64* seed, const int* bound, u64* best,
                        int* best_pop, uint8_t* found, uint8_t* complete,
                        uint8_t* exhausted, int B, int iters, bool minimise,
                        int max_fix_iters, cudaStream_t stream) {
  const cudaError_t err = configure_beam<kF>();
  if (err != cudaSuccess) return err;
  beam_kernel<kF><<<B, kF * 32, beam_smem<kF>(), stream>>>(
      in, seed, bound, best, best_pop, found, complete, exhausted, iters, minimise,
      max_fix_iters);
  return cudaGetLastError();
}

// info = {resident blocks an SM, registers a thread, local (spilled) bytes a
// thread} of beam_kernel<kF>.
template <int kF>
cudaError_t beam_info(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = configure_beam<kF>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], beam_kernel<kF>, kF * 32,
                                                        beam_smem<kF>());
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, beam_kernel<kF>);
  if (err != cudaSuccess) return err;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// info = {resident blocks an SM, registers a thread, local (spilled) bytes a
// thread} of fixpoint_kernel<kPriorities>.
template <bool kPriorities>
cudaError_t fixpoint_info(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[0], fixpoint_kernel<kPriorities>, kThreadsPerBlock, 0);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fixpoint_kernel<kPriorities>);
  if (err != cudaSuccess) return err;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

template <int N>
PlaneSet<N> plane_set(const long long* desc) {
  PlaneSet<N> s;
  for (int i = 0; i < N; ++i) {
    s.p[i] = reinterpret_cast<u64*>(desc[i]);
    s.stride[i] = static_cast<int>(desc[N + i]);
  }
  return s;
}

template <bool kPriorities>
cudaError_t launch_fixpoint(const long long* in, const long long* out, const long long* levels,
                            uint8_t* flags, int B, int max_iters, cudaStream_t stream) {
  fixpoint_kernel<kPriorities><<<grid_for(B), kThreadsPerBlock, 0, stream>>>(
      plane_set<kPlanes>(in), plane_set<kPlanes>(out),
      levels ? plane_set<4>(levels) : PlaneSet<4>{}, flags, B, max_iters);
  return cudaGetLastError();
}

}  // namespace

// The launchers run on the caller's stream, do not synchronise, allocate
// nothing, and return the launch's cudaError_t (0 on success).  Boards are
// int64[B, 10, 64] (kernels B and C take them as planes, below); B must be
// positive and the iteration counts non-negative.

extern "C" cudaError_t life_stable_step(const u64* in, u64* out, u64* changed, u64* abort,
                                        int B, cudaStream_t stream) {
  if (B <= 0) return cudaErrorInvalidValue;
  step_kernel<<<grid_for(B), kThreadsPerBlock, 0, stream>>>(in, out, changed, abort, B);
  return cudaGetLastError();
}

// Kernel B, or kernel C where `levels` is not null.  `in` and `out` describe
// the 10 planes of the boards, `levels` the 4 levels of kernel C: N
// pointers, then the N board strides in words (PlaneSet), each below 2^31.
// flags is uint8[2, B]: consistent, then changed.
extern "C" cudaError_t life_stable_fixpoint(const long long* in, const long long* out,
                                            const long long* levels, uint8_t* flags, int B,
                                            int max_iters, cudaStream_t stream) {
  if (B <= 0 || max_iters < 0) return cudaErrorInvalidValue;
  return levels ? launch_fixpoint<true>(in, out, levels, flags, B, max_iters, stream)
                : launch_fixpoint<false>(in, out, nullptr, flags, B, max_iters, stream);
}

// info = fixpoint_info of kernel B (priorities 0) or C (priorities 1).
extern "C" cudaError_t life_stable_fixpoint_info(int priorities, int* info) {
  return priorities ? fixpoint_info<true>(info) : fixpoint_info<false>(info);
}

// F, the frontier, is a power of two in [2, 16]; seed (int64[B, 64]) and
// bound (int32[B]) may be null.  The block of F warps needs F x 5 KB of
// dynamic shared memory (80 KB at F = 16), which the launcher opts into; a
// device that allows less returns the cudaFuncSetAttribute error.
extern "C" cudaError_t life_stable_beam(const u64* in, const u64* seed, const int* bound,
                                        u64* best, int* best_pop, uint8_t* found,
                                        uint8_t* complete, uint8_t* exhausted, int B, int F,
                                        int iters, int minimise, int max_fix_iters,
                                        cudaStream_t stream) {
  if (B <= 0 || iters < 0 || max_fix_iters < 0) return cudaErrorInvalidValue;
  const bool m = minimise != 0;
  switch (F) {
    case 2: return launch_beam<2>(in, seed, bound, best, best_pop, found, complete, exhausted,
                                  B, iters, m, max_fix_iters, stream);
    case 4: return launch_beam<4>(in, seed, bound, best, best_pop, found, complete, exhausted,
                                  B, iters, m, max_fix_iters, stream);
    case 8: return launch_beam<8>(in, seed, bound, best, best_pop, found, complete, exhausted,
                                  B, iters, m, max_fix_iters, stream);
    case 16: return launch_beam<16>(in, seed, bound, best, best_pop, found, complete,
                                    exhausted, B, iters, m, max_fix_iters, stream);
    default: return cudaErrorInvalidValue;
  }
}

// info = beam_info of beam_kernel<F>, F a power of two in [2, 16].
extern "C" cudaError_t life_stable_beam_info(int F, int* info) {
  switch (F) {
    case 2: return beam_info<2>(info);
    case 4: return beam_info<4>(info);
    case 8: return beam_info<8>(info);
    case 16: return beam_info<16>(info);
    default: return cudaErrorInvalidValue;
  }
}
