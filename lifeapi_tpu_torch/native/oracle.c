/* Independent scalar Conway-Life oracle on the 64x64 torus.
 *
 * Deliberately naive (per-cell neighbour loops over dense byte grids): this
 * is the third, independent implementation used to differentially test the
 * bit-parallel JAX/Pallas kernels, in the spirit of the reference's
 * StepAltTest (tests/StepAltTest.cpp:5-13).  It shares no structure with
 * either the CSA netlist or the numpy oracle.
 *
 * Also provides a uint64 bit-packed stepper (independent derivation, full
 * adder over explicitly rotated columns) used to cross-check the packed
 * representation itself, and batch entry points for throughput testing.
 */

#include <stdint.h>
#include <string.h>

#define N 64

static inline int wrap(int v) { return v & (N - 1); }

void life_step_dense_one(const uint8_t *g, uint8_t *o);

/* grid: bytes, grid[x * N + y], 0/1 */
void life_step_dense(const uint8_t *in, uint8_t *out, int n_boards) {
  for (int b = 0; b < n_boards; b++) {
    const uint8_t *g = in + (size_t)b * N * N;
    uint8_t *o = out + (size_t)b * N * N;
    for (int x = 0; x < N; x++) {
      for (int y = 0; y < N; y++) {
        int count = 0;
        for (int dx = -1; dx <= 1; dx++) {
          for (int dy = -1; dy <= 1; dy++) {
            if (dx == 0 && dy == 0) continue;
            count += g[wrap(x + dx) * N + wrap(y + dy)];
          }
        }
        int alive = g[x * N + y];
        o[x * N + y] = (uint8_t)(count == 3 || (alive && count == 2));
      }
    }
  }
}

void life_step_dense_n(const uint8_t *in, uint8_t *out, int n_boards,
                       int steps) {
  uint8_t tmp[N * N];
  for (int b = 0; b < n_boards; b++) {
    const uint8_t *src = in + (size_t)b * N * N;
    uint8_t *dst = out + (size_t)b * N * N;
    memcpy(dst, src, N * N);
    for (int s = 0; s < steps; s++) {
      life_step_dense_one(dst, tmp);
      memcpy(dst, tmp, N * N);
    }
  }
}

void life_step_dense_one(const uint8_t *g, uint8_t *o) {
  life_step_dense(g, o, 1);
}

/* boards: uint64 columns, board[x] bit y = cell (x, y); independent
 * bit-parallel derivation: vertical full-adds of rotated columns, then
 * horizontal full-adds, then B3/S23 mux — NOT the Rokicki formula. */
void life_step_packed(const uint64_t *in, uint64_t *out, int n_boards) {
  for (int b = 0; b < n_boards; b++) {
    const uint64_t *g = in + (size_t)b * N;
    uint64_t *o = out + (size_t)b * N;
    uint64_t v0[N], v1[N]; /* per-column vertical triple sums */
    for (int x = 0; x < N; x++) {
      uint64_t a = g[x];
      uint64_t up = (a << 1) | (a >> 63);
      uint64_t dn = (a >> 1) | (a << 63);
      uint64_t s = up ^ dn;
      v0[x] = s ^ a;
      v1[x] = (s & a) | (up & dn);
    }
    for (int x = 0; x < N; x++) {
      uint64_t l0 = v0[wrap(x - 1)], l1 = v1[wrap(x - 1)];
      uint64_t r0 = v0[wrap(x + 1)], r1 = v1[wrap(x + 1)];
      uint64_t c0 = v0[x], c1 = v1[x];
      /* sum three 2-bit numbers -> 4-bit S (includes the center cell) */
      uint64_t t0 = l0 ^ r0;
      uint64_t s0 = t0 ^ c0;
      uint64_t ca = (l0 & r0) | (t0 & c0);
      uint64_t t1 = l1 ^ r1;
      uint64_t sb = t1 ^ c1;
      uint64_t cb = (l1 & r1) | (t1 & c1);
      uint64_t s1 = sb ^ ca;
      uint64_t cc = sb & ca;
      uint64_t s2 = cb ^ cc;
      uint64_t s3 = cb & cc;
      /* alive' = (S == 3) | (alive & S == 4) */
      uint64_t a = g[x];
      uint64_t is3 = s0 & s1 & ~s2 & ~s3;
      uint64_t is4 = ~s0 & ~s1 & s2 & ~s3;
      o[x] = is3 | (a & is4);
    }
  }
}

void life_step_packed_n(const uint64_t *in, uint64_t *out, int n_boards,
                        int steps) {
  uint64_t tmp[N];
  for (int b = 0; b < n_boards; b++) {
    const uint64_t *src = in + (size_t)b * N;
    uint64_t *dst = out + (size_t)b * N;
    memcpy(dst, src, N * sizeof(uint64_t));
    for (int s = 0; s < steps; s++) {
      life_step_packed(dst, tmp, 1);
      memcpy(dst, tmp, N * sizeof(uint64_t));
    }
  }
}

uint64_t popcount_board(const uint64_t *g) {
  uint64_t total = 0;
  for (int x = 0; x < N; x++) total += (uint64_t)__builtin_popcountll(g[x]);
  return total;
}
