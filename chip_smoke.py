#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing what it saw:

1. environment: the card's name and power limit; build the CUDA kernels
   of ``lifeapi_tpu_torch/csrc`` with nvcc; each kernel's registers and
   spills (ptxas), and the resident blocks an SM of the NTT, beam and
   fixpoint kernels (the CUDA runtime's occupancy calculator);
2. the main path, with the kernels' launch counters set to 0 just before:
   the headline rollout (8192 random boards, 512 generations), the MPC
   solver in its demo and bench configurations (their gradients through the
   soft-Life rollout and VJP sweeps), and the catalyst search on the full
   64x64 offset grid and on the example's grid;
3. checks: every kernel against its plain PyTorch twin on the same inputs
   (bit-exact), the rollout against an independent numpy B3/S23 oracle on
   64 boards and, ``[oracle]``, against the native C oracle
   (``lifeapi_tpu_torch/native/oracle.c``, built with ``cc``) on all 8192,
   the MPC demo at Hamming 0, the known catalyst hit counts, and every
   kernel launched by the main path; ``[state]``: LifeState's parse, step,
   convolve (both routes), match_live, interaction offsets, strips and
   patches on the card equal to the same calls on the CPU;
4. the still-life solver's path ([stable]), with its own counters set to 0
   just before: the beam completion of the bench problem (8192 problems,
   frontier 4, 24 rounds), the queued beam over 131,072 problems, and the
   propagate fixpoint of 4096 boards through its four entries; then each
   of the four solver kernels against its twin (bit-exact, on the bench
   shapes and on random, seeded and bounded instances; kernels B and C
   through every entry at three step caps), each BitStable entry shown to
   be one launch of B or C and no other kernel, the known answers
   (pop-7 eater on every problem, 49 -> 40 unknowns, a lone cell proved
   inconsistent, bound 7 finds nothing), the beam kernel on uneven
   instances at every frontier, and every board found checked to be a
   still life;
5. the convolution layer's path ([conv]), with the conv and calibration
   counters set to 0 just before: the catalyst search over the offsets
   ``candidate_offsets`` keeps (4025; 195 interacted, 3845 recovered, 15
   hits) and over every orientation of the eater, interaction offsets of
   1024 7-cell pairs by the union peel and by the dense counts, the
   convolve, counts and match routes at B=4096, the 16-transform orbit
   sweep and the calibration in both mixes; then the known answers, the
   routes against one another (dense counts = peel at 13 planes,
   single-prime = dense mod 193) and each kernel against its twin (the
   union peel on the 1024 pairs' masks and on the glider and eater's);
6. the weld / dense-stable path ([weld]), with every counter set to 0 just
   before: the Bellman pipeline (catalyst search, weld, reaction replay,
   host DFS, the batched beam of all 15 recovering placements, their
   backgrounds verified by step_n, kernels [1] and [4] and the numpy
   oracle), UnweldableMask on the catalyst x eater fixture (1893
   placements; tier 1, then escalated), the two-anchor portfolio and the
   dense propagate of the welded problems; then the known answers, tier 1
   against the beam's plain twin and the JAX package's count, tier 3's
   soundness, the dense propagate against kernel B, and kernel [4] against
   its twin and kernel [1];
7. timings on the card (CUDA events, medians after a warm-up; device
   times from torch.profiler traces, the mean of the launches each holds,
   with the SM clock read under the same load),
   the calibrated word-op ceilings, every kernel's bound (the rollout,
   solver and peel kernels' from the SASS of the library just built), and
   the NTT kernels' tensor-core instructions (HMMA) in that SASS; then
   ``[roofline]``: the lane-ops a board of the plain circuits
   (``utils.roofline``: the step of [1] and [4], the propagation step of
   [5], the simple step), before and after CSE, traced on CPU tensors and
   on the card's, which must agree, with post-CSE no more than pre-CSE;
   beside each, the SASS of [1], [4] and [5] and the kernel's rate in the
   circuit's lane-ops over the card's lane-op peak; and ``[entry]``:
   ``graft_entry``'s forward step at its own shape (4 candidates, horizon
   8) and at the MPC bench's width (64 candidates, horizon 32), each with
   the counters set to 0 just before: the soft costs against the same call
   on the CPU (rtol 1e-4), kernel [2]'s hard costs and finals against
   ``controlled_rollout_plain`` and the numpy step of the toggles, the host
   time and the device's busy share;
8. after the timings, the MPC paths, each with the counters set to 0 just
   before it and read just after: ``[sqp]``, ``solve(method="sqp")`` at
   north-star config 3's width (64 candidates, horizon 32, a protected
   background block), its seconds by stage, the soft objective no worse
   than after the warm-up, kernel [2] against its twin on every candidate,
   the toy problem's known answer, the launches of the three soft-Life
   sweeps (``csrc/soft_life.cu``: the rollout, its VJP, the HVP sweep);
   ``[soft]``, the three sweeps at the same shapes against their plain twins
   (the forward bit for bit, also at the line search's 192 candidates; the
   adjoint sweeps' ptxas registers and spills, which must be 0, and their
   threads, shared memory and residency; the VJP on the
   cost's cotangent and the HVP sweep at 8, 64 and 192 candidates within a
   stated tolerance of the float32 twin and as close to the float64 twin as
   the float32 twin is), then each sweep's call and device time beside its
   bytes bound;
   ``[receding]``, the example through
   ``run`` (Hamming 0) and ``run_fused``, both along the numpy step, then
   ``run_fused`` at horizon 32 under sync-debug mode "error";
   ``[symmetric]``, the C2even problem of ``tests/test_symmetric_mpc.py``
   from that test's draw at Hamming 0 and D4even at horizon 32 with a
   stable region, symmetric toggles, kernel B's consistency flags against
   ``bitplane.propagate`` on every final board, one launch of B with no
   host sync, and the block / lone-cell answers; ``[reach]``, the eater
   fixture's known answer, then a glider at each of 4096 offsets over two
   propagated eater backgrounds for 32 steps, the card against the CPU on
   256 and the bounds around kernel [1]'s exact Hamming of the completed
   boards, with the candidates bounded and pruned a second;
9. ``[parallel]``: ``make_mesh()`` at world size 1 over NCCL, then
   the seven sharded runners of ``parallel/elite.py`` at their unsharded
   entries' widths with the counters set to 0 just before them (they must
   launch [1], [2], [3] and [10]): the headline rollout, the catalyst
   search over 4096 offsets (16/266/3846), the beam over the 8192 bench
   problems in one pass and two-phase (champion pop 7), the portfolio
   example's instance (pop 6), the MPC bench problem's 64 candidates and
   an 8 x 8 scenario sweep at horizon 32, each equal to its unsharded
   entry on the same inputs (hard costs exactly); each runner's host time
   beside its entry's, in turns; then the process group is torn down;
10. last, ``[dryrun]``: ``graft_entry.dryrun_multichip`` over every card
   (NCCL; in this process on one card, whose counters must show [1], [2],
   [3] and [10]), every result held to the same runners on a mesh of one
   rank; and ``[adversarial]``: the 224 instances of
   ``tests/test_beam_adversarial.py`` (``tests/torch_beam_sweep.py``)
   through kernel [10] at frontier 8, 96 rounds, with the counters set to
   0 just before: every find a still life keeping its knowns, every proof
   one the host DFS also finds, no DFS completion proved inconsistent, at
   least 40 of each, and the kernel equal to its plain version.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  There is no CPU path: without
CUDA, or when any check fails, the script exits non-zero.
"""

import collections
import contextlib
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROLLOUT_SOURCE = "lifeapi_tpu_torch/csrc/life_rollout.cu"
STABLE_SOURCE = "lifeapi_tpu_torch/csrc/life_stable.cu"
REPLACES = {
    "rollout": "lifeapi_tpu/ops/step_pallas.py:340",
    "controlled_rollout": "lifeapi_tpu/ops/step_pallas.py:160",
    "catalyst_rollout": "lifeapi_tpu/ops/step_pallas.py:243",
    "rollout_lohi": "lifeapi_tpu/ops/step_pallas.py:307",
}
# the kernels of REPLACES that the main path drives; rollout_lohi has no
# caller there and is driven by the [weld] phase
MAIN_PATH_KERNELS = ("rollout", "controlled_rollout", "catalyst_rollout")
STABLE_REPLACES = {  # [6] and [9] are entries over kernels B and C
    "propagate_step": "lifeapi_tpu/ops/stable_pallas.py:441",
    "propagate_fused": "lifeapi_tpu/ops/stable_pallas.py:589",
    "propagate_fixpoint": "lifeapi_tpu/ops/stable_pallas.py:487",
    "propagate_fixpoint_priorities": "lifeapi_tpu/ops/stable_pallas.py:519",
    "propagate_fused_beam": "lifeapi_tpu/ops/stable_pallas.py:549",
    "beam_search": "lifeapi_tpu/ops/stable_pallas.py:906",
}
CONV_SOURCE = "lifeapi_tpu_torch/csrc/life_conv.cu"
CALIBRATE_SOURCE = "lifeapi_tpu_torch/csrc/life_calibrate.cu"
CONV_REPLACES = {
    "convolve_sparse_fused": "lifeapi_tpu/ops/conv_sparse_pallas.py:179",
    "counts_sparse_fused": "lifeapi_tpu/ops/conv_sparse_pallas.py:206",
    # union_interacting(method="sparse"): [11] over the stacked pairs
    "union_sparse_fused": "lifeapi_tpu/core/convolve.py:625",
    "conv_counts_fused": "lifeapi_tpu/ops/conv_pallas.py:334",
    "conv_small_fused": "lifeapi_tpu/ops/conv_pallas.py:180",
    "conv_small_packed": "lifeapi_tpu/ops/conv_pallas.py:281",
}
CALIBRATE_REPLACES = {"calibrate": "lifeapi_tpu/ops/calibrate_pallas.py:65"}
# The soft-Life sweeps replace no TPU kernel: the JAX package leaves
# soft_rollout (lifeapi_tpu/mpc/soft.py:49) to XLA, which fuses it; the
# line is where its rollout, and so its gradient and HVP, is defined.
SOFT_SOURCE = "lifeapi_tpu_torch/csrc/soft_life.cu"
SOFT_REPLACES = dict.fromkeys(("soft_rollout", "soft_rollout_vjp", "soft_rollout_hvp"),
                              "lifeapi_tpu/mpc/soft.py:49")
SOFT_KERNELS = {"soft_rollout": "soft_rollout_kernel", "soft_rollout_vjp": "soft_vjp_kernel",
                "soft_rollout_hvp": "soft_hvp_kernel"}
# Each sweep's bytes: the boards [T, C, 64, 64] in float32 it reads and
# writes (the start board once), and its float32 operations a cell and
# generation, counted from soft_life.cu (a sigmoid as 4: neg, exp, add, div;
# the gates' arguments 2 each): the forward 34 (toggle 5, stencil 5, three
# gates 18, step 6), the VJP 56 (toggle 5, two stencils 10, first
# derivatives 27, the adjoint 14), the HVP 106 (toggle 5, tangent 7, four
# stencils 20, second derivatives 40, the partials 34), over the card's
# float32 rate outside the tensor cores (H100 SXM data sheet).
SOFT_BOARDS_MOVED = {"soft_rollout": 2, "soft_rollout_vjp": 5, "soft_rollout_hvp": 7}
SOFT_FLOP_PER_CELL = {"soft_rollout": 34, "soft_rollout_vjp": 56, "soft_rollout_hvp": 106}
FP32_FLOP_PER_S = 67e12
# the sweeps against their plain twins on the card: the forward bit for
# bit; the VJP and HVP, which sum a cell's terms in float32 in another order
# than the twins' autograd, each candidate's relative error (over its cells)
# within SOFT_TWIN_TOL of the float32 twin, and no further from the float64
# twin on the same inputs than SOFT_F64_RATIO times the float32 twin is
# (plus 1e-6): on the cost's cotangent, which is 1 on every cell of the
# mostly empty board, both float32 sums sit a relative 4e-5 from float64
# and 2e-5 from each other
SOFT_TWIN_TOL, SOFT_F64_RATIO = 1e-4, 2.0
# the CG update against its twin: each system's relative error within
# CG_TWIN_TOL of the float32 twin (the update's roundings are the eager
# ops'; only the dot products' order differs), and SOFT_F64_RATIO from
# float64 as the sweeps
CG_TWIN_TOL = 1e-5
# [soft] holds the adjoint sweeps to their twins at these candidates besides
# [sqp]'s SQP_C and the line search's 3 * SQP_C
SOFT_FEW_C = 8
# The MPC objective's sweeps in their objective mode and the solver's
# updates.  None replaces a TPU kernel: JAX's soft_objective, conjugate
# gradients and optax.adam are left to XLA; each line is where JAX defines
# what the kernel computes.
SOLVER_SOURCE = "lifeapi_tpu_torch/csrc/solver_update.cu"
OBJECTIVE_KERNELS = {"soft_objective": "soft_objective_kernel",
                     "soft_objective_vjp": "soft_objective_vjp_kernel",
                     "soft_objective_hvp": "soft_objective_hvp_kernel"}
UPDATE_KERNELS = {"cg_update": "cg_update_kernel", "adam_update": "adam_kernel"}
OBJECTIVE_REPLACES = dict.fromkeys(OBJECTIVE_KERNELS, "lifeapi_tpu/mpc/solver.py:61")
UPDATE_REPLACES = {"cg_update": "lifeapi_tpu/mpc/solver.py:177",
                   "adam_update": "lifeapi_tpu/mpc/solver.py:136"}
# Their boards [C, T, 64, 64] of float32 moved, each read or written once:
# the forward reads the logits and writes traj; the adjoint, as a gradient
# runs it, reads the logits and traj and writes the gradient and the
# adjoints; the HVP sweep reads the logits, traj, the adjoints, the gradient
# and the direction and writes two partials; the CG update reads x, r, p and
# A p and writes x, r and p; adam reads the logits, the gradient and the two
# moments and writes three.  Their float32 operations a cell and generation,
# counted from the sources as for the plain sweeps: the sweep's own, the
# controls (a sigmoid 4, its mask 1, du/dl 3) and the cost's terms (the
# forward 9, the adjoint's cotangent and chain rule 12, the HVP's 2
# sigmoids and the chain rule's terms 16); the CG update 8, adam 13.
UPDATE_BOARDS_MOVED = {"soft_objective": 2, "soft_objective_vjp": 4, "soft_objective_hvp": 7,
                       "cg_update": 7, "adam_update": 7}
UPDATE_FLOP_PER_CELL = {"soft_objective": 48, "soft_objective_vjp": 73,
                        "soft_objective_hvp": 130, "cg_update": 8, "adam_update": 13}
# launches an adam iteration's gradient, an HVP and a CG iteration's update
# (its damping's add and the update) may take on the card, counted on the
# host (launches_of)
GRADIENT_LAUNCHES, HVP_LAUNCHES, CG_UPDATE_LAUNCHES = 8, 6, 3
# the convolution layer's bench shapes (bench.py:366-460, 571-618;
# benches/extra.py:764-809) and the calibration's
CONV_B, IO_B = 4096, 1024
CALIB_ROWS, CALIB_ITERS = 16384, 2048
# known answers of the [conv] path (the JAX package on the same inputs)
CANDIDATES, PRUNED_COUNTS, IO_POP = 4025, (195, 3845, 15), 71
ORIENTATION_HITS = [(0, 15), (2, 0), (13, 15), (4, 16), (15, 16), (6, 1), (8, 15), (9, 15)]
# Bounds.  Device memory: 3.35e12 B/s (H100 SXM data sheet).  Word-ops (the
# calibration's bound, and the hand counts printed beside the SASS bounds of
# the solver kernels): the 64-bit integer operations a kernel needs per word
# (one column of one board), counted by hand from its CUDA source: a logic
# function of up to three inputs counts once (one LOP3 per half-word), as do
# a shift, rotate, add, shuffle, select or popcount; over the calibrated
# ceiling of the matching mix, "rolls" for kernels that shuffle and
# "elemwise" for those that do not.
HBM_BYTES_PER_S = 3.35e12
# The four rollout kernels (life_rollout.cu) are not held to hand counts: the
# calibrated ceiling is the rate of the calibration's own instruction mix, and
# life_step's hand count over it came out above the rollout's measured device
# time.  Their generation loop is one straight-line body,
# so their operations are the SASS instructions of that loop in the library
# this run built (cuobjdump -sass), one warp per board, over the card's issue
# peak: one warp instruction per clock per scheduler, four schedulers per SM,
# at the SM clock's maximum.  A loop's generations are told by its shuffles:
# 16 a generation where lane l holds columns l and l + 32 (4 column exchanges
# x (lo, hi) x two 32-bit halves), 8 where it holds columns 2l and 2l + 1
# (the controlled kernel's life_step_pair: 2 exchanges x (even, odd) x 2).
SCHEDULERS_PER_SM = 4
SHFL_PER_GENERATION = 16
ROLLOUT_KERNELS = {"rollout": ("rollout_kernel", 16),
                   "rollout_lohi": ("rollout_lohi_kernel", 16),
                   "controlled_rollout": ("controlled_kernel", 8),
                   "catalyst_rollout": ("catalyst_kernel", 16)}
# Hand counts of life_stable.cu, printed beside the SASS bounds of kernels
# A-D: stable_step: sync 26, two count9 46 (8
# shuffles and selects each), nibble sums 21, update 55, signal 53, two
# hollow ZOIs 18, apply 19, the fixpoint's vote and copy-back 12
STABLE_STEP_OPS = 250
# priority: two count9 46, vulnerable 306 (four is_forced 264), three hollow
# ZOIs 27, levels 16
PRIORITY_OPS = 395
# Kernels B-D (life_stable.cu fixpoint_kernel, beam_kernel) are held to their
# SASS, as the rollouts: warp instructions per board-step (the fixpoint
# loop: stable_step, the votes and, in B and C, the copy-back) and per
# priority board (the straight-line block of priority()), one warp per
# board, over the issue peak.  The loop and the block are told by their
# 32-bit shuffles: two count9 (16 each) and two hollow ZOIs (8 each) a
# step, two count9 and three hollow ZOIs in priority().
STEP_SHUFFLES, PRIORITY_SHUFFLES = 48, 56
SOLVER_KERNELS = {"propagate_fixpoint": "fixpoint_kernel<0>",
                  "propagate_fixpoint_priorities": "fixpoint_kernel<1>",
                  "beam_search": "beam_kernel<4>"}  # the bench's frontier
# The peel kernels ([11], [12] and the union, life_conv.cu) are held to the
# SASS of their round loop: a round rotates the lane's two columns by the
# cell's row with four funnel shifts (SHF.L.W), so a loop's rounds are its
# funnel shifts over 4, and a round's instructions are those of the
# unrolled loop over its rounds; times the cells peeled, over the issue
# peak.  Kernel A ([5], life_stable.cu step_kernel) is one straight-line
# step a board: the basic block of the step's 48 shuffles.
FUNNEL_SHIFTS_PER_ROUND = 4
PEEL_KERNELS = {"convolve_sparse_fused": "conv_sparse_kernel",
                "counts_sparse_fused": "counts_sparse_kernel",
                "union_sparse_fused": "union_sparse_kernel"}
# The dense counts ([13]-[15]) are bounded by the work the function needs,
# not by [15]'s bit-parallel loop: the NTT of the TPU kernels
# (conv_pallas.py) as bf16 matmuls (residues <= 256 are exact in bf16) at the
# card's dense bf16 tensor-core peak (H100 SXM data sheet).  One 64-point
# transform of a board along one axis is a 64x64 @ 64x64 matmul, 2 * 64**3
# FLOP; a prime takes 6 (two operands forward along x and y, the inverse
# along both).  The element-wise mods and the CRT are left out.
BF16_FLOP_PER_S = 989e12
NTT_FLOP_PER_PRIME = 6 * 2 * 64**3
# The NTT kernel of [13]-[15] (life_conv.cu ntt_conv_kernel<primes, out>)
# also reduces every stage mod p on the ALUs: 7 x 4096 reductions a
# board and prime (both forward stages of both boards, the product, both
# inverse stages) and 4096 CRT steps for two primes, each MOD_INSTRUCTIONS
# thread instructions (mod_p: FMUL, FRND.FLOOR, FFMA, FSETP, FADD, FSEL),
# printed as a second bound over the issue peak.
NTT_KERNEL = "ntt_conv_kernel"
MOD_REDUCTIONS_PER_PRIME = 7 * 4096
MOD_INSTRUCTIONS = 6

# Device times at these shapes before the kernels' redesign (the beam kernel
# as one block of F warps at 173 registers, [15] on a popcount body, the
# controlled rollout as 8 boards a block reading its toggles from device
# memory; kernels B and C as one warp a board at 167 registers with the
# BitStable entries stacking the planes first: the whole call for [6] and
# [9]; the peel [11] and [12] one cell a round, each round waiting on the
# last, and the union as [11] over the stacked pairs with the stack,
# population, where and OR kernels around it, the whole call), on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md section 6; [2], [6]-[9], [11], [12] and
# the union by device_times.py on the parent tree), printed beside this
# run's.
DEVICE_MS_BEFORE = {"beam_search": 1.3101, "conv_small_packed": 0.5484,
                    "controlled_rollout": 0.0107, "propagate_fused": 0.0396,
                    "propagate_fixpoint": 0.0244, "propagate_fixpoint_priorities": 0.0332,
                    "propagate_fused_beam": 0.0476, "convolve_sparse_fused": 0.0046,
                    "counts_sparse_fused": 0.0108, "union_sparse_fused": 0.1835,
                    "cg_update": 0.1639}
# profiler traces of one device time taken before a run of traces that each
# miss half of a kernel's launches fails the run
PROFILE_TRIES = 5
# the BitStable entries over kernels B and C, and the counter each launch
# adds to: [6], [7] (as propagate_fixpoint's) and [9]
ENTRY_COUNTERS = {"propagate_fused": "propagate_fused",
                  "propagate_fused_inkernel": "propagate_fixpoint",
                  "propagate_fused_beam": "propagate_fused_beam"}
# bytes the L2-rotated device times ([5]-[9], [11], [12], the union and
# torch.bitwise_or beside [11]) cycle through: twice the H100's 50 MB of L2
L2_ROTATED_BYTES = 100_000_000

# the solver's bench shapes (bench.py): beam, queued beam, fixpoint
BEAM_B, BEAM_F, BEAM_ITERS = 8192, 4, 24
QUEUED_CHUNKS = 16
FIX_B = 4096
EATER_RLE = "2b2o$bobo$bo$2o!"
HEADLINE_B, HEADLINE_T = 8192, 512
# the [weld] phase: benches/weld_bench.py's catalyst x eater welds (the
# reference LifeWeldTest fixtures: pattern, required cells)
WELD_CATALYST = ("2o$o2bob2o$b3obobo$5bobo$b5ob3o$bo4bo3bo$4bobo2b2o$4b2o!",
                 "4o$5o2bo$4o$5o4bo$b5ob5o$b12o$b12o$b12o$4b9o$4b4o!")
WELD_EATER = ("2b2o$bobo$bo$2o!", "2b2o$b3o$b4o$5o$4o$4o!")
WELD_HORIZON = 64
WELD_PATH_KERNELS = ("catalyst_rollout", "rollout", "rollout_lohi", "beam_search",
                     "propagate_fixpoint")
# known answers of the [weld] phase, from the JAX package on the CPU:
# examples/bellman_pipeline.py (candidates, hits, offset, stripped cells, DFS
# pop; the batched beam of all hits: found, verified) and the catxeater
# tier 1 (engine="beam", batch_size=4096, beam_iters=24, escalate=False)
PIPELINE_ANSWERS = (4025, 15, (0, 4), 4, 7, 15, 15)
WELD_TESTED = 1893
# the 68 placements it proves unweldable (displacements mod 64)
WELD_TIER1_MARKS = (
    (0, 5), (0, 7), (0, 61), (1, 7), (1, 60), (1, 61), (1, 62), (2, 6), (2, 7), (2, 61),
    (2, 62), (3, 6), (3, 7), (3, 61), (3, 62), (4, 5), (4, 6), (4, 7), (4, 61), (4, 62),
    (5, 0), (5, 4), (5, 5), (5, 6), (5, 7), (5, 61), (5, 62), (5, 63), (6, 0), (6, 1),
    (6, 4), (6, 5), (6, 61), (6, 62), (6, 63), (7, 0), (7, 1), (7, 2), (7, 3), (7, 5),
    (7, 62), (7, 63), (8, 0), (8, 1), (8, 2), (8, 3), (60, 0), (60, 1), (60, 2), (60, 62),
    (60, 63), (61, 0), (61, 1), (61, 2), (61, 3), (61, 61), (61, 62), (61, 63), (62, 3),
    (62, 4), (62, 5), (62, 61), (62, 62), (62, 63), (63, 4), (63, 5), (63, 62), (63, 63),
)
# the instance's minimum, the barge: no still life of fewer cells holds two
# cells at offset (2, 2), and the JAX package finds the barge on the same
# instance (tests/test_torch_portfolio_example.py)
PORTFOLIO_MIN_POP = 6
GLIDER = [(8, 10), (9, 8), (9, 10), (10, 9), (10, 10)]
# the [parallel] phase: the runners at their unsharded entries' full widths
# (the MPC bench problem's candidates and horizon; the scenario sweep's 8 x 8
# candidates for 40 iterations; the portfolio example's instance), the
# kernels their shards launch, and each runner's timing turns (the scenario
# sweep's calls take seconds, so it takes one turn of each)
PAR_MPC_C, PAR_MPC_ITERS = 64, 60
PAR_SWEEP_S, PAR_SWEEP_C, PAR_SWEEP_ITERS = 8, 8, 40
PARALLEL_KERNELS = ("rollout", "controlled_rollout", "catalyst_rollout", "beam_search")
PAR_TURNS = {"scenario_sweep": 1}
PF_REPLICAS, PF_ITERS = 256, 192  # examples/portfolio_minimise.py's defaults
# the MPC paths: SQP at north-star config 3's width (candidates, horizon,
# the iterations whose third warms up), run_fused and the D4even solve at
# horizon 32, the reachability prefilter over a glider at every offset
# (candidates, steps, those held to the CPU)
SQP_C, SQP_HORIZON, SQP_ITERS = 64, 32, 100
# [soft] holds the forward to its twin at these candidates: fewer clusters
# than SMs, [sqp]'s, as many candidates as SMs (264 CTAs), the line search's
SOFT_ROLLOUT_C = (SOFT_FEW_C, SQP_C, 132, 3 * SQP_C)
# [update] holds the CG update to its twin at these systems: fewer clusters
# than the card holds, [sqp]'s, systems of 35 elements (not a multiple of
# the kernel's 16-byte pieces, so most start off 16 bytes) and shares longer
# than a CTA's tiles
CG_SHAPES = ((SOFT_FEW_C, SQP_HORIZON, 64, 64), (SQP_C, SQP_HORIZON, 64, 64), (3, 5, 7),
             (SOFT_FEW_C, 2 * SQP_HORIZON, 64, 64))
RECEDING_H32 = SYM_HORIZON = 32
# [cem]: solve_cem's default population and iterations on [sqp]'s problem
CEM_POP, CEM_ITERS = 256, 20
REACH_C, REACH_T, REACH_CPU = 4096, 32, 256
# the C2even problem's draw of tests/test_symmetric_mpc.py on its control
# mask's 72 cells (tests/test_torch_symmetric_mpc.py checks it against JAX)
C2_DRAW = Path(__file__).parent / "tests" / "data" / "c2_symmetric_draw.npy"
EATER = [(24, 21), (24, 22), (25, 21), (25, 23), (26, 23), (27, 23), (27, 24)]


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Independent numpy oracle (dense B3/S23 on the torus)
# ---------------------------------------------------------------------------


def oracle_dense(words):
    """int64 boards [..., 64] -> uint8 cells [..., 64, 64] indexed [x, y]."""
    w = np.ascontiguousarray(words).view(np.uint64)
    return ((w[..., None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)


def oracle_run(words, generations):
    """The cells of int64 boards [..., 64] after ``generations`` steps of
    the examples' numpy Life step."""
    from lifeapi_tpu_torch.examples import life_step_dense

    g = oracle_dense(words)
    for _ in range(generations):
        g = life_step_dense(g)
    return g


def kernel_label(mangled):
    """``beam_kernel<4>`` or ``ntt_conv_kernel<2, 0>`` from an entry
    function's mangled name.  The name is read from its start: ``_ZN``, then
    each enclosing namespace and the function as its length and its letters
    (the anonymous namespace's name holds a hash of the source's path, whose
    digits must not be taken for a length), then integer template arguments
    as ``I`` ``Li<n>E``... ``E``."""
    pos = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") else None
    name = None
    while pos is not None and (length := re.match(r"\d+", mangled[pos:])):
        pos += length.end()
        name = mangled[pos:pos + int(length.group())]
        pos += len(name)
    if name is None or not name.endswith("_kernel"):
        return mangled
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[pos:])
    if not args:
        return name
    return f"{name}<{', '.join(re.findall(r'(\d+)E', args.group(1)))}>"


def ptxas_report(log):
    """(kernel, registers, spill bytes) per entry function in nvcc's
    ``-Xptxas -v`` output."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_label(line.split("'")[1])
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name:
            rows.append((name, int(line.split("Used")[1].split("registers")[0]), spill))
            name = None
    return rows


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_functions(listing):
    """{kernel: [(address, opcode, operands)]} from ``cuobjdump -sass``."""
    funcs, name = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            name = kernel_label(line.split("Function :")[1].strip())
            funcs[name] = []
        elif name and (m := SASS_LINE.search(line)):
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return funcs


def _branch_target(op, args):
    """The address a branch or a reconvergence point (BSSY) names, or None."""
    if op.startswith(("BRA", "BSSY", "JMP", "CALL")):
        m = re.search(r"0x([0-9a-f]+)", args)
        return int(m.group(1), 16) if m else None
    return None


def _shuffles(ops):
    return sum(op.startswith("SHFL") for op in ops)


def loops(code):
    """(shuffles, instructions, first address, last address) of every loop
    of a function's SASS: a backward branch and what it jumps over."""
    found = []
    for addr, op, args in code:
        target = _branch_target(op, args) if op.startswith("BRA") else None
        if target is not None and target <= addr:
            body = [o for a, o, _ in code if target <= a <= addr]
            found.append((_shuffles(body), len(body), target, addr))
    return found


def instructions_per_generation(code, shuffles_per_generation=SHFL_PER_GENERATION):
    """Instructions per generation of the generation loop: of the loops
    that hold shuffles but no other such loop, the one with the most.  Its
    shuffles count its generations, so a body unrolled k times counts k
    (and a loop around the generation loops, a chunk loop, is passed
    over)."""
    shuffling = [lp for lp in loops(code) if lp[0]]
    innermost = [(n_shfl, n) for n_shfl, n, first, last in shuffling
                 if not any(first <= o[2] and o[3] <= last and (o[2], o[3]) != (first, last)
                            for o in shuffling)]
    shuffles, n = max(innermost, default=(0, 0))
    check(shuffles > 0 and shuffles % shuffles_per_generation == 0,
          f"no generation loop found in the SASS ({shuffles} shuffles)")
    return n * shuffles_per_generation / shuffles


def library_sass(lib_path):
    """{kernel: [(address, opcode, operands)]} of the built library, from the
    toolkit's ``cuobjdump -sass``."""
    from lifeapi_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    listing = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], check=True,
                             capture_output=True, text=True, timeout=300).stdout
    return sass_functions(listing)


def round_instructions(code):
    """Warp instructions per round of the peel's round loop: of the loops
    that hold funnel shifts but no other such loop, the one with the most
    rounds (the unrolled body, not its remainder), its instructions over
    its rounds."""
    funnel = [(sum(op.startswith("SHF.L.W") for a, op, _ in code if first <= a <= last),
               n, first, last) for _, n, first, last in loops(code)]
    funnel = [lp for lp in funnel if lp[0]]
    inner = [(shifts // FUNNEL_SHIFTS_PER_ROUND, n) for shifts, n, first, last in funnel
             if shifts % FUNNEL_SHIFTS_PER_ROUND == 0
             and not any(first <= o[2] and o[3] <= last and (o[2], o[3]) != (first, last)
                         for o in funnel)]
    check(inner, "no peel round loop in the SASS")
    rounds, n = max(inner)
    return n / rounds


def peel_sass_counts(funcs):
    """Warp instructions per round of each peel kernel's round loop."""
    return {name: round_instructions(funcs[fn]) for name, fn in PEEL_KERNELS.items()}


def rollout_sass_counts(funcs):
    """Warp instructions per board-generation of each rollout kernel."""
    return {name: instructions_per_generation(funcs[fn], shuffles)
            for name, (fn, shuffles) in ROLLOUT_KERNELS.items()}


def basic_blocks(code):
    """A function's SASS cut into basic blocks: a block ends after a branch,
    exit, return or call, and a new one starts at every address a branch or
    a BSSY names."""
    targets = {t for _, op, args in code if (t := _branch_target(op, args)) is not None}
    blocks, block = [], []
    for addr, op, args in code:
        if addr in targets and block:
            blocks.append(block)
            block = []
        block.append((addr, op, args))
        if op.startswith(("BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL")):
            blocks.append(block)
            block = []
    return blocks + ([block] if block else [])


def loop_instructions(code, shuffles):
    """Instructions per pass of the innermost loop that holds ``shuffles``
    shuffles a pass: of the loops that hold a positive multiple of them,
    the one with the fewest instructions; k times the shuffles count k
    passes."""
    passes = [(size, n) for n, size, _, _ in loops(code) if n and n % shuffles == 0]
    check(passes, f"no loop of {shuffles} shuffles a pass in the SASS")
    size, n = min(passes)
    return size * shuffles / n


def block_instructions(code, shuffles):
    """Instructions of the smallest basic block that holds exactly
    ``shuffles`` shuffles."""
    sizes = [len(b) for b in basic_blocks(code) if _shuffles(op for _, op, _ in b) == shuffles]
    check(sizes, f"no basic block of {shuffles} shuffles in the SASS")
    return min(sizes)


def solver_sass_counts(funcs):
    """{entry: (warp instructions per board-step, per priority board or None)}
    of kernels B, C and D, from their SASS."""
    return {name: (loop_instructions(funcs[fn], STEP_SHUFFLES),
                   None if name == "propagate_fixpoint"
                   else block_instructions(funcs[fn], PRIORITY_SHUFFLES))
            for name, fn in SOLVER_KERNELS.items()}


def ntt_sass_counts(funcs):
    """{instantiation: (HMMA, LDSM, FRND, instructions)} of the NTT kernels
    in the SASS; fail unless each multiplies on the tensor cores (HMMA)."""
    counts = {}
    for name, code in funcs.items():
        if name.startswith(NTT_KERNEL):
            ops = [op for _, op, _ in code]
            counts[name] = tuple(sum(o.startswith(p) for o in ops)
                                 for p in ("HMMA", "LDSM", "FRND")) + (len(ops),)
    check(len(counts) == 4 and all(c[0] > 0 for c in counts.values()),
          f"the NTT kernels' SASS lacks HMMA: {counts}")
    return counts


def issue_peak():
    """(warp instructions per second the card can issue at most, its SMs,
    the SM clock's maximum in MHz): ``utils.roofline.card_issue_peak``."""
    from lifeapi_tpu_torch.utils.roofline import card_issue_peak

    peak = card_issue_peak()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return peak, sms, peak / (sms * SCHEDULERS_PER_SM * 1e6)


def print_occupancy():
    """Resident blocks an SM (the CUDA runtime's occupancy calculator),
    registers and local bytes a thread of every NTT instantiation, of the
    beam kernel at each frontier and of the fixpoint kernels B and C; fail
    if the beam or a fixpoint kernel spills."""
    from lifeapi_tpu_torch.ops import conv_cuda, stable_cuda

    for priorities in (0, 1):
        blocks, regs, local = stable_cuda.fixpoint_kernel_info(priorities)
        print(f"[env] occupancy: fixpoint_kernel<{priorities}>: {blocks} resident blocks of 4 "
              f"warps an SM ({4 * blocks} warps), {regs} registers, {local} local bytes a thread")
        check(local == 0, f"fixpoint_kernel<{priorities}> spills ({local} local bytes a thread)")

    for name, (blocks, regs, local) in conv_cuda.ntt_kernel_info().items():
        print(f"[env] occupancy: {name}: {blocks} resident blocks of 4 warps an SM, "
              f"{regs} registers, {local} local bytes a thread")
    for frontier in (2, 4, 8, 16):
        blocks, regs, local = stable_cuda.beam_kernel_info(frontier)
        print(f"[env] occupancy: beam_kernel<{frontier}>: {blocks} resident blocks of "
              f"{frontier} warps an SM ({blocks * frontier} warps), {regs} registers, "
              f"{local} local bytes a thread")
        check(local == 0, f"beam_kernel<{frontier}> spills ({local} local bytes a thread)")


def max_err(got, want):
    """Largest |got - want|: over the cells for int64 boards (0 or 1), over
    the values otherwise."""
    if got.dtype == torch.int64 and got.shape[-1:] == (64,):
        return float((got != want).any())
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


# ---------------------------------------------------------------------------
# Still-life solver inputs (numpy-seeded, as tests/test_stable_pallas.py)
# ---------------------------------------------------------------------------


def block_instances(n, seed, n_blocks, lo, hi, p_hide, ring2):
    """n partial still lifes made of 2x2 blocks, some cells hidden, with
    the 1- or 2-ring around them unknown; dense numpy (state, unknown)."""
    from lifeapi_tpu_torch.stable import host as H

    rng = np.random.default_rng(seed)
    states, unknowns = [], []
    for _ in range(n):
        truth = np.zeros((64, 64), bool)
        for _ in range(n_blocks):
            x, y = rng.integers(lo, hi, 2)
            truth[x:x + 2, y:y + 2] = True
        hide = (rng.random((64, 64)) < p_hide) & H.zoi(truth)
        ring = H.zoi(H.zoi(truth)) if ring2 else H.zoi(truth)
        states.append(truth & ~hide)
        unknowns.append(hide | (ring & ~truth))
    return np.stack(states), np.stack(unknowns)


def planes_of(states, unknowns, dev):
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.stable import bitplane as BP

    bst = BP.make(state=B.from_dense(torch.from_numpy(states)).to(dev),
                  unknown=B.from_dense(torch.from_numpy(unknowns)).to(dev))
    return BP.to_planes(bst).contiguous()


def eater_problem(dev, hide_cells=((20, 20), (21, 20)), ring2=False):
    """The solver bench's problem: the eater at (20, 20) with the given
    cells hidden and its 1- or 2-ring unknown -> (known ON, unknown)."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import rle

    eater = B.move(rle.parse(EATER_RLE, device=dev), 20, 20)
    hide = B.from_cells(list(hide_cells), device=dev)
    ring = B.zoi(B.zoi(eater)) if ring2 else B.zoi(eater)
    return eater & ~hide, (ring & ~eater) | hide


def kernel_vs_plain(name, args, kwargs, err):
    """Run a solver kernel and its twin on the same card inputs; fail
    unless they agree bit for bit.  Returns the kernel's outputs."""
    from lifeapi_tpu_torch.ops import stable_cuda as SC

    got = getattr(SC, name)(*args, **kwargs)
    want = getattr(SC, f"{name}_plain")(*args, **kwargs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        err[name] = max(err[name], max_err(g, w))
        check(g.dtype == w.dtype and torch.equal(g, w), f"{name} kernel != plain twin")
    return got


def entry_outputs(result):
    """The tensors of a ``propagate_fused`` result, or of a
    ``propagate_fused_beam`` (result, levels) pair."""
    from lifeapi_tpu_torch.stable import bitplane as BP

    res, levels = (result, ()) if isinstance(result, BP.BitPropagateResult) else result
    return (BP.to_planes(res.stable), res.consistent, res.changed, *levels)


def entry_vs_plain(name, bst, kwargs, err):
    """A BitStable entry ([6], [7] or [9]) and its plain version on the same
    card inputs; fail unless they agree bit for bit.  [7]'s error counts as
    propagate_fixpoint's."""
    from lifeapi_tpu_torch.ops import stable_cuda as SC

    got = getattr(SC, name)(bst, **kwargs)
    want = getattr(SC, f"{name}_plain")(bst, **kwargs)
    torch.cuda.synchronize()
    key = ENTRY_COUNTERS[name]
    for g, w in zip(entry_outputs(got), entry_outputs(want), strict=True):
        err[key] = max(err[key], max_err(g, w))
        check(torch.equal(g, w), f"{name} {kwargs} != its plain version")
    return got


def check_one_launch(name, bst):
    """One call of a BitStable entry is one launch of kernel B or C and
    nothing else: no readback (a synchronising call raises under the sync
    debug mode), its counter alone moves, by one, and a profiler trace of a
    call holds one fixpoint_kernel event and no other kernel (no stack, copy
    or fill).  A trace that dropped the launch is taken again."""
    from lifeapi_tpu_torch.ops import stable_cuda as SC

    call = lambda: getattr(SC, name)(bst)
    before = dict(SC.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    added = {k: v - before[k] for k, v in SC.LAUNCHES.items() if v != before[k]}
    check(added == {ENTRY_COUNTERS[name]: 1}, f"{name} is not one launch of B or C: {added}")
    for _ in range(PROFILE_TRIES):
        kernels = {e.key: e.count for e in _trace(call, 1)}
        if kernels:
            break
    check(len(kernels) == 1 and "fixpoint_kernel" in next(iter(kernels))
          and list(kernels.values()) == [1],
          f"a trace of one {name} call holds other kernels: {kernels}")


def check_still_lifes(res, known, unknown, what):
    """Every found board is a still life (one generation leaves it as it
    is), keeps the known ON cells and lies inside known | unknown."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.ops import step_cuda

    f = res.found
    best = res.best[f].contiguous()
    if best.shape[0]:
        check(torch.equal(step_cuda.rollout(best, 1), best), f"{what}: a found board is not a still life")
    check(bool(B.is_empty(known.expand_as(res.best)[f] & ~best).all()),
          f"{what}: a found board lost a known ON cell")
    check(bool(B.is_empty(best & ~(known | unknown).expand_as(res.best)[f]).all()),
          f"{what}: a found board sets a cell that was known OFF")


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def launch_count(counter):
    """The launches counted so far under ``counter`` in the wrappers'
    ``LAUNCHES``.  ``solver_cuda`` is imported for its own counters only:
    ``device_times.py`` reads this with an older tree's package, which may
    not have it."""
    from lifeapi_tpu_torch.ops import calibrate_cuda, conv_cuda, soft_cuda, stable_cuda, step_cuda

    modules = [step_cuda, stable_cuda, conv_cuda, calibrate_cuda, soft_cuda]
    if counter in UPDATE_KERNELS:
        from lifeapi_tpu_torch.ops import solver_cuda

        modules.append(solver_cuda)
    for module in modules:
        if counter in module.LAUNCHES:
            return module.LAUNCHES[counter]
    raise KeyError(counter)


def profiled_device_ms(fn, kernel, counter, n=20, whole_call=False):
    """Mean device milliseconds per call of fn in the kernels whose name
    matches the regular expression ``kernel``, or in every kernel of the
    call when ``whole_call``, from torch.profiler.

    Each kernel event of a trace is one whole launch, but a trace on the
    card may miss some of the launches.  So a kernel's time per call is the
    mean of its recorded launches times its launches per call: its events
    over n, rounded up.  A trace counts if the launches per call of the
    kernels matching ``kernel`` add up to those that one call, made outside
    the profiler, adds to ``LAUNCHES[counter]``, and if each kernel it
    reads kept at least half of its launches; otherwise it is taken again,
    and after PROFILE_TRIES such traces the run fails."""
    torch.cuda.synchronize()
    before = launch_count(counter)
    fn()
    torch.cuda.synchronize()
    per_call = launch_count(counter) - before
    check(per_call > 0, f"a call of {counter} launched no kernel")
    for _ in range(PROFILE_TRIES):
        events = [e for e in _trace(fn, n)
                  if whole_call or re.search(kernel, e.key)]
        launches = {e.key: -(-e.count // n) for e in events}
        matched = sum(c for key, c in launches.items() if re.search(kernel, key))
        short = {e.key[:60]: f"{e.count} of {launches[e.key] * n}" for e in events
                 if e.count < launches[e.key] * n}
        if matched == per_call and all(2 * e.count >= launches[e.key] * n for e in events):
            if short:
                print(f"[time] {counter}: a trace of {n} calls missed launches {short}; "
                      f"their kernels' time is the mean of the launches it holds")
            return sum(e.device_time_total / e.count * launches[e.key] for e in events) / 1e3
        print(f"[time] {counter}: a trace of {n} calls held launches of {per_call} a call "
              f"of {kernel} as {launches}, short {short}; taken again")
    check(False, f"{counter}: no usable trace in {PROFILE_TRIES}")


def _trace(fn, n):
    """The key averages of the kernels (events with device time) of n calls
    of fn in one torch.profiler trace, after one call the profiler does not
    record."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_time_total > 0]


def operator_device_ms(fn, n=20):
    """Mean device milliseconds of the one kernel fn launches (a PyTorch
    operator, which has no launch counter), from a torch.profiler trace; a
    trace that holds another kernel or under half the launches is taken
    again."""
    for _ in range(PROFILE_TRIES):
        events = _trace(fn, n)
        if len(events) == 1 and 2 * events[0].count >= n:
            return events[0].device_time_total / events[0].count / 1e3
        print(f"[time] a trace of {n} calls of one operator held "
              f"{[(e.key[:60], e.count) for e in events]}; taken again")
    check(False, f"no usable trace of one operator in {PROFILE_TRIES}")


def sm_clock_under(fn, seconds=5.0):
    """The SM clock in MHz (nvidia-smi) read while fn runs on the card, call
    after call."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits"],
                            stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while proc.poll() is None and time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return out.split()[0]


def rotation_copies(nbytes):
    """Copies of a call's inputs and outputs, nbytes a call, that together
    pass L2_ROTATED_BYTES."""
    return max(2, -(-L2_ROTATED_BYTES // nbytes))


def rotating_call(fn, inputs):
    """A call of fn(*args) whose args are the next of ``inputs`` (argument
    tuples) in turn, and whose result is kept until len(inputs) calls later:
    with copies that together pass the L2 (rotation_copies), neither what a
    call reads nor what it writes is still in the L2 from the call before."""
    turn = itertools.cycle(inputs)
    kept = collections.deque(maxlen=len(inputs))
    return lambda: kept.append(fn(*next(turn)))


def peel_bytes(n_pairs):
    """Bytes a call of each peel kernel moves at the [conv] shapes, each
    input read once and each output written once: [11] two boards in and one
    out a pair, [12] two in and 13 planes out, the union n_pairs pairs in and
    one board out a query."""
    board = 512
    return {"convolve_sparse_fused": 3 * CONV_B * board,
            "counts_sparse_fused": (2 + 13) * CONV_B * board,
            "union_sparse_fused": (2 * n_pairs + 1) * IO_B * board}


def device_ms_at(fn, kernel, counter, n=20, whole_call=False):
    """(profiled_device_ms, sm_clock_under) of fn."""
    return profiled_device_ms(fn, kernel, counter, n, whole_call), sm_clock_under(fn)


def before_redesign(name, dev_ms):
    """The kernel's device time before its redesign, and this run's speed-up."""
    if name not in DEVICE_MS_BEFORE:
        return ""
    before = DEVICE_MS_BEFORE[name]
    return f"; before the redesign {before:.4f} ms on the device ({before / dev_ms:.3g}x)"


def wall(fn, n):
    """Median host seconds of fn over n calls, each fenced by synchronize."""
    samples = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def paired_ms(kernel_fn, plain_fn, reps, setup=None):
    """Median milliseconds of kernel_fn and plain_fn on the card, timed with
    CUDA events in alternating turns after one warm-up call of each; with
    ``setup``, it runs before each call, outside the timing."""
    setup = setup or (lambda: None)
    for fn in (kernel_fn, plain_fn):
        setup()
        fn()
    times = {kernel_fn: [], plain_fn: []}
    for _ in range(reps):
        for fn in (kernel_fn, plain_fn):
            setup()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[fn].append(start.elapsed_time(end))
    return statistics.median(times[kernel_fn]), statistics.median(times[plain_fn])


# ---------------------------------------------------------------------------
# The MPC paths: SQP, receding horizon, symmetric, reachability
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def spying(module, name):
    """Replace ``module.name`` for the block by a wrapper that calls it and
    keeps each call's arguments, result and host seconds, fenced by
    synchronize.  Yields the list of calls."""
    calls = []
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append(SimpleNamespace(args=args, out=out, seconds=time.perf_counter() - t0))
        return out

    with replaced(module, name, wrapper):
        yield calls


@contextlib.contextmanager
def replaced(module, name, value):
    """``module.name`` set to ``value`` for the block."""
    original = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, original)


def reset_counters():
    from lifeapi_tpu_torch.ops import soft_cuda, solver_cuda, stable_cuda, step_cuda

    torch.cuda.synchronize()
    step_cuda.reset_launches()
    stable_cuda.reset_launches()
    soft_cuda.reset_launches()
    solver_cuda.reset_launches()


def read_counters(path, kernels):
    """The launch counters after a path's run; fails unless every kernel
    named was launched."""
    from lifeapi_tpu_torch.ops import soft_cuda, solver_cuda, stable_cuda, step_cuda

    torch.cuda.synchronize()
    counts = {**step_cuda.LAUNCHES, **stable_cuda.LAUNCHES, **soft_cuda.LAUNCHES,
              **solver_cuda.LAUNCHES}
    counts = {name: n for name, n in counts.items() if n}
    print(f"[{path}] launches {counts}")
    check(all(counts.get(name, 0) > 0 for name in kernels),
          f"[{path}] a kernel of the path was never launched: {counts}")
    return counts


def device_share(fn, n=3):
    """(host ms, device ms, kernels) of one call of fn: the median host
    time fenced by synchronize, and the device time and kernel launches of
    a torch.profiler trace of n calls, each over n.  A trace may drop a
    few launches, so the device time and its share of the host time are
    lower bounds."""
    host_ms = wall(fn, n) * 1e3
    events = _trace(fn, n)
    return (host_ms, sum(e.device_time_total for e in events) / n / 1e3,
            sum(e.count for e in events) / n)


class AtenKernels(TorchDispatchMode):
    """The aten operators a block dispatches that launch a kernel: every one
    but views and allocations."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if not func.is_view and not name.startswith("empty") and name != "lift_fresh":
            self.ops.append(func.__name__)
        return func(*args, **(kwargs or {}))


def launches_of(fn):
    """(launches, aten operators) of one call of fn: the kernel wrappers'
    counters and the aten operators that launch a kernel, counted on the
    host, so no trace can drop any."""
    from lifeapi_tpu_torch.ops import (calibrate_cuda, conv_cuda, soft_cuda, solver_cuda,
                                       stable_cuda, step_cuda)

    counters = [m.LAUNCHES for m in (step_cuda, stable_cuda, conv_cuda, calibrate_cuda,
                                     soft_cuda, solver_cuda)]
    before = [dict(c) for c in counters]
    with AtenKernels() as mode:
        fn()
        torch.cuda.synchronize()
    ours = sum(c[k] - b[k] for c, b in zip(counters, before) for k in c)
    return ours + len(mode.ops), mode.ops


def print_share(path, what, share):
    host_ms, dev_ms, kernels = share
    print(f"[{path}] {what}: {host_ms:.2f} ms on the host clock, at least {dev_ms:.2f} ms "
          f"of it in {kernels:.0f} kernels on the device ({dev_ms / host_ms:.1%} busy)")


def oracle_gate(boards, rolled):
    """The headline rollout (kernel [1]) against the native C oracle on
    every board, as ``bench.py`` gates the JAX package's."""
    from lifeapi_tpu_torch import native

    t0 = time.perf_counter()
    native.load_oracle()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = native.step_packed64(native.to_packed64(boards), HEADLINE_T)
    oracle_s = time.perf_counter() - t0
    same = (native.to_packed64(rolled) == want).all(axis=-1)
    print(f"[oracle] C oracle built in {build_s:.2f} s; B={HEADLINE_B} T={HEADLINE_T}: "
          f"kernel [1] == C oracle on {int(same.sum())} of {same.size} boards "
          f"({oracle_s:.1f} s of host C)")
    check(bool(same.all()), "rollout kernel != C oracle")


def state_phase(dev):
    """A few LifeState calls on the card against the same calls on the CPU:
    parse, step, convolve (the default route and the peel kernels),
    match_live, interaction offsets, strips and patches."""
    from lifeapi_tpu_torch import LifeState
    from lifeapi_tpu_torch.core import board as B

    gen = torch.Generator().manual_seed(7)
    soup = B.random(gen, (64,), p=0.2, device="cpu") & B.solid_rect(10, 10, 30, 30, device="cpu")

    def calls(d):
        g = LifeState.parse("bob$2bo$3o!", 20, 20, device=d)
        e = LifeState.from_cells(EATER, device=d)
        s = LifeState(soup.to(d))
        strip = s.get_strip(21)
        out = [g.stepped(4), g.stepped(), s.stepped(9), s.convolve(g), s.convolve(g, method="sparse"),
               s.match_live(g), e.interaction_offsets(g), s.set_strip(40, strip),
               LifeState(device=d).set_patch((21, 21), 2, g.get_patch((21, 21), 2))]
        return [x.packed.cpu() for x in out] + [strip.cpu()], g
    got, g_card = calls(dev)
    want, _ = calls(torch.device("cpu"))
    check(all(torch.equal(a, b) for a, b in zip(got, want)), "LifeState: card != CPU")
    check(bool(g_card.stepped(4) == g_card.moved(1, 1)), "LifeState: a glider does not glide")
    check(LifeState.parse("bob$2bo$3o!").packed.device.type == "cuda"
          and LifeState().packed.device.type == "cuda",
          "LifeState: a constructor given no device did not build on the card")
    print(f"[state] {len(got)} LifeState results on the card == the CPU's (parse, step, "
          f"convolve by both routes, match_live, interaction offsets, strips, patches)")


def device_phase(dev):
    """The port's one device rule on the card: every constructor given no
    device builds on the card, the headline's boards drawn from a CPU
    generator with no device go through kernel [1] once, and the
    README's eater problem built with no ``device=`` anywhere goes
    through kernel [10] once, every problem found at pop 7."""
    from lifeapi_tpu_torch import convert, history
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import convolve, ntt, rle
    from lifeapi_tpu_torch.examples import bellman_pipeline
    from lifeapi_tpu_torch.native import build as native
    from lifeapi_tpu_torch.ops import stable_cuda, step_cuda
    from lifeapi_tpu_torch.stable import api, bitplane, complete, propagate
    from lifeapi_tpu_torch.symmetry import groups
    from lifeapi_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    packed = np.zeros((64, 2), dtype=np.uint32)
    packed[3, 0] = 0b1011
    dense = np.zeros((64, 64), dtype=bool)
    dense[20:24, 30:33] = True
    stable = SimpleNamespace(state=dense, unknown=~dense, ruled=np.zeros((64, 64), np.uint8))
    problem = SimpleNamespace(
        initial=packed, target=SimpleNamespace(wanted=packed, unwanted=packed), horizon=4,
        control_mask=dense, protected=None, background=None, weights=(1.0, 0.01, 0.0, 0.0),
        tau=1.0)
    built = {
        "board.empty": B.empty((2,)), "board.full": B.full(),
        "board.random": B.random(torch.Generator().manual_seed(1), (3,)),
        "board.from_cells": B.from_cells([(1, 2)]), "board.cell_mask": B.cell_mask(3, 4),
        "board.checkerboard": B.checkerboard(), "board.solid_rect": B.solid_rect(1, 2, 3, 4),
        "board.solid_rect_xy": B.solid_rect_xy(1, 2, 3, 4),
        "board.nzoi_around": B.nzoi_around((10, 20), 3), "board.cell_zoi": B.cell_zoi((10, 20)),
        "rle.parse": rle.parse(EATER_RLE), "convolve.default_corona": convolve.default_corona(),
        "ntt.matrix": ntt.matrix(193, False),
        "LifeHistory.create": tuple(history.LifeHistory.create()),
        "history.parse": tuple(history.parse("AB$2C!")),
        "history.parse_bellman": tuple(history.parse_bellman("C2E$bC3E$!")),
        "groups.fundamental_domain": groups.fundamental_domain(groups.StaticSymmetry.D4),
        "propagate.make": tuple(propagate.make(batch=(2,))),
        "LifeStable()": tuple(api.LifeStable().data),
        "LifeStable.from_boards": tuple(api.LifeStable.from_boards().data),
        "bitplane.make": (lambda b: (b.state, b.unknown, *b.ruled))(bitplane.make(batch=(2,))),
        "complete.draw_offsets": complete.draw_offsets(torch.Generator().manual_seed(9), 8),
        "native.from_packed64": native.from_packed64(np.arange(64, dtype=np.uint64)),
        "prng.KeySequence": torch.rand(2, generator=prng.KeySequence(42)(), device=dev),
        "convert.board_from_packed": convert.board_from_packed(packed),
        "convert.planes_from_packed": tuple(convert.planes_from_packed([packed, packed])),
        "convert.history_from_jax": tuple(convert.history_from_jax([packed] * 4)),
        "convert.target_from_jax": tuple(convert.target_from_jax(problem.target)),
        "convert.dense_mask": convert.dense_mask(dense),
        "convert.problem_from_jax": (lambda q: (q.initial, *q.target, q.control_mask))(
            convert.problem_from_jax(problem)),
        "convert.bitstable_from_jax": (lambda b: (b.state, b.unknown, *b.ruled))(
            convert.bitstable_from_jax(SimpleNamespace(state=packed, unknown=packed,
                                                       ruled=[packed] * 8))),
        "convert.stable_from_jax": tuple(convert.stable_from_jax(stable)),
        "convert.lifestable_from_jax": tuple(
            convert.lifestable_from_jax(SimpleNamespace(data=stable)).data),
        "convert.weld_from_jax": tuple(convert.weld_from_jax([packed] * 4)),
        "convert.lohi_from_jax": convert.lohi_from_jax(np.ones((64, 3), np.uint32),
                                                      np.zeros((64, 3), np.uint32)),
        "bellman_pipeline.build": bellman_pipeline.build(EATER_RLE, 1, 2),
    }
    off_card = [name for name, out in built.items()
                if not all(t.is_cuda for t in (out if isinstance(out, tuple) else (out,)))]
    check(not off_card, f"[device] built off the card with no device: {off_card}")

    # the headline rollout from a CPU generator's draw and no device
    boards = B.random(torch.Generator().manual_seed(0), (HEADLINE_B,))
    reset_counters()
    rolled = step_cuda.rollout(boards, HEADLINE_T)
    torch.cuda.synchronize()
    rollout_launches = step_cuda.LAUNCHES["rollout"]
    check(rollout_launches == 1, f"[device] the rollout launched kernel [1] "
          f"{rollout_launches} times, not once")
    named = B.random(torch.Generator().manual_seed(0), (HEADLINE_B,), device=dev)
    check(boards.is_cuda, "[device] the headline's no-device draw is not on the card")
    check(torch.equal(boards, named)
          and torch.equal(rolled, step_cuda.rollout_plain(named, HEADLINE_T)),
          "[device] the no-device draw's rollout != the device='cuda' draw's")

    # the README's eater problem, no device anywhere
    eater = B.move(rle.parse(EATER_RLE), 20, 20)
    hide = B.from_cells([(20, 20), (21, 20)])
    bst = bitplane.make(state=(eater & ~hide).expand(BEAM_B, 64),
                        unknown=((B.zoi(eater) & ~eater) | hide).expand(BEAM_B, 64))
    reset_counters()
    res = complete.complete_stable_beam(bst, frontier=BEAM_F, iters=BEAM_ITERS, dense=False)
    torch.cuda.synchronize()
    beam_launches = stable_cuda.LAUNCHES["beam_search"]
    check(beam_launches == 1, f"[device] the beam launched kernel [10] {beam_launches} times, "
          f"not once")
    check(bst.state.is_cuda, "[device] the README's eater problem is not on the card")
    check(bool(res.found.all()) and bool((res.best_pop == 7).all()),
          "[device] the README's eater problem was not found at pop 7 on every problem")
    print(f"[device] {len(built)} constructors given no device built on the card; "
          f"B={HEADLINE_B} T={HEADLINE_T} rollout of a CPU generator's draw: kernel [1] "
          f"launched {rollout_launches}x, == the device='cuda' draw's plain rollout; README "
          f"eater x{BEAM_B}: kernel [10] launched {beam_launches}x, all found at pop 7; "
          f"phase {time.perf_counter() - t_phase:.2f} s")


def parallel_phase(dev, card):
    """The seven sharded runners over NCCL at world size 1 on the card, each
    against its unsharded entry on the same inputs, with the kernel
    counters set to 0 just before the runners and read just after; then
    each runner's host-clock time beside its unsharded entry's, in turns;
    then the process group is torn down."""
    import torch.distributed as dist

    from lifeapi_tpu_torch import search
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.examples import portfolio_minimise
    from lifeapi_tpu_torch.mpc import CostWeights, MPCProblem, solver
    from lifeapi_tpu_torch.ops import step_cuda
    from lifeapi_tpu_torch.parallel import destroy, elite, make_mesh
    from lifeapi_tpu_torch.stable import bitplane as BP
    from lifeapi_tpu_torch.stable import complete as C

    t0 = time.perf_counter()
    mesh = make_mesh(device=dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    check(dist.get_backend() == backend and mesh.size() == 1,
          f"the mesh is not {backend} at world size 1")
    print(f"[parallel] mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} over "
          f"{dist.get_backend()} on {mesh.device_type} in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device=dev).manual_seed(0)
    boards = B.random(gen, (HEADLINE_B,), device=dev)
    glider = B.from_cells(GLIDER, device=dev)
    eater = B.from_cells(EATER, device=dev)
    grid = torch.tensor([[dx, dy] for dx in range(64) for dy in range(64)], device=dev)
    bench = bench_problem(dev)
    mask, target = bench.control_mask, bench.target
    logits0 = solver.init_logits(torch.Generator().manual_seed(0), bench, PAR_MPC_C)
    initials = B.random(gen, (PAR_SWEEP_S,), p=0.05, device=dev) & B.solid_rect(
        20, 20, 24, 24, device=dev)
    known, unknown = eater_problem(dev)
    beam_bst = BP.make(state=known.expand(BEAM_B, 64), unknown=unknown.expand(BEAM_B, 64))
    anchors = B.from_cells(portfolio_minimise.ANCHORS, device=dev)
    pf_unknown = B.zoi(B.zoi(anchors)) & ~anchors

    def sweep_gen():
        return torch.Generator().manual_seed(1)

    sharded = {
        "rollout": lambda: elite.sharded_rollout(boards, HEADLINE_T, mesh),
        "catalyst_search": lambda: elite.sharded_catalyst_search(glider, eater, grid, 64, mesh),
        "beam_complete": lambda: elite.sharded_beam_complete(
            beam_bst, mesh, frontier=BEAM_F, iters=BEAM_ITERS),
        "beam_complete_two_phase": lambda: elite.sharded_beam_complete(
            beam_bst, mesh, frontier=BEAM_F, iters=BEAM_ITERS, two_phase=True),
        "portfolio": lambda: elite.sharded_portfolio(
            anchors, pf_unknown, torch.Generator().manual_seed(0), mesh, replicas=PF_REPLICAS,
            frontier=4, iters=PF_ITERS, two_phase=True),
        "candidate_solve": lambda: elite.sharded_candidate_solve(
            bench, logits0, mesh, iters=PAR_MPC_ITERS),
        "scenario_sweep": lambda: elite.sharded_scenario_sweep(
            initials, target, 32, mask, mesh, sweep_gen(),
            candidates_per_scenario=PAR_SWEEP_C, iters=PAR_SWEEP_ITERS),
    }

    def candidate_ref():
        logits, _ = solver.solve_gradient(logits0, bench, iters=PAR_MPC_ITERS, lr=0.15)
        probs = torch.sigmoid(logits) * mask
        return probs, solver.hard_score_batch(probs, bench)[0]

    def sweep_ref():
        first = MPCProblem(initials[0], target, 32, mask, weights=CostWeights())
        lg0 = solver.init_logits(sweep_gen(), first, PAR_SWEEP_S * PAR_SWEEP_C).reshape(
            PAR_SWEEP_S, PAR_SWEEP_C, 32, 64, 64)
        best = []
        for initial, lg in zip(initials, lg0):
            p = MPCProblem(initial, target, 32, mask, weights=CostWeights())
            lg, _ = solver.solve_gradient(lg, p, iters=PAR_SWEEP_ITERS)
            best.append(solver.hard_score_batch(torch.sigmoid(lg) * mask, p)[0].min())
        return torch.stack(best)

    unsharded = {
        "rollout": lambda: step_cuda.rollout(boards, HEADLINE_T),
        "catalyst_search": lambda: search.catalyst_search(glider, eater, grid, 64),
        "beam_complete": lambda: C.complete_stable_beam(
            beam_bst, frontier=BEAM_F, iters=BEAM_ITERS, dense=False),
        "portfolio": lambda: C.complete_stable_portfolio(
            anchors, pf_unknown, torch.Generator().manual_seed(0), replicas=PF_REPLICAS,
            frontier=4, iters=PF_ITERS),
        "candidate_solve": candidate_ref,
        "scenario_sweep": sweep_ref,
    }
    unsharded["beam_complete_two_phase"] = unsharded["beam_complete"]

    reset_counters()
    t0 = time.perf_counter()
    got = {name: fn() for name, fn in sharded.items()}
    torch.cuda.synchronize()
    print(f"[parallel] the seven runners ran in {time.perf_counter() - t0:.2f} s")
    read_counters("parallel", PARALLEL_KERNELS)
    want = {name: fn() for name, fn in unsharded.items() if name != "beam_complete_two_phase"}

    final, pop = got["rollout"]
    check(torch.equal(final, want["rollout"]), "sharded_rollout != rollout")
    check(int(pop) == int(B.population(want["rollout"]).sum()), "sharded_rollout population")
    inter, rec, hits = got["catalyst_search"]
    ref = want["catalyst_search"]
    check(torch.equal(inter, ref.interacted) and torch.equal(rec, ref.recovered),
          "sharded_catalyst_search flags != catalyst_search's")
    answers = (int(hits), int(inter.sum()), int(rec.sum()))
    check(answers == (16, 266, 3846), f"sharded catalyst counts {answers} != 16/266/3846")
    ref = want["beam_complete"]
    for name in ("beam_complete", "beam_complete_two_phase"):
        found, best, bpop, champ, champ_pop = got[name]
        check(torch.equal(found, ref.found) and torch.equal(best, ref.best)
              and torch.equal(bpop, ref.best_pop), f"sharded {name} != complete_stable_beam")
        check(int(champ_pop) == 7 and torch.equal(B.population(champ), champ_pop)
              and torch.equal(step_cuda.rollout(champ[None], 1)[0], champ),
              f"sharded {name}: the champion is not a still life at pop 7")
    pf, pf_ref = got["portfolio"], want["portfolio"]
    pf_dense = B.to_dense(pf.best).cpu().numpy()
    check(pf.found and pf.best_pop == pf_ref.best_pop == PORTFOLIO_MIN_POP
          and torch.equal(step_cuda.rollout(pf.best[None], 1)[0], pf.best)
          and all(pf_dense[x, y] for x, y in portfolio_minimise.ANCHORS),
          f"sharded_portfolio pop {pf.best_pop} != complete_stable_portfolio's "
          f"{pf_ref.best_pop} (the instance's minimum is {PORTFOLIO_MIN_POP})")
    best_cost, best_probs, all_costs = got["candidate_solve"]
    probs, costs = want["candidate_solve"]
    check(torch.equal(all_costs, costs) and float(best_cost) == float(costs.min())
          and torch.equal(best_probs, probs[torch.argmin(costs)]),
          "sharded_candidate_solve != solve_gradient + hard_score_batch")
    per, champ_cost = got["scenario_sweep"]
    check(torch.equal(per, want["scenario_sweep"]) and float(champ_cost) == float(per.min()),
          "sharded_scenario_sweep != solve_gradient + hard_score_batch per scenario")
    print(f"[parallel] every runner == its unsharded entry: rollout B={HEADLINE_B} "
          f"T={HEADLINE_T} (population {int(pop)}); catalyst 4096 offsets: {answers[0]} hits, "
          f"{answers[1]} interacted, {answers[2]} recovered; beam {BEAM_B} problems F={BEAM_F} "
          f"{BEAM_ITERS} rounds, one pass and two-phase, champion pop 7; portfolio {PF_REPLICAS} "
          f"replicas F=4 {PF_ITERS} rounds two-phase, champion pop {pf.best_pop} (unsharded "
          f"{pf_ref.best_pop}); candidate solve {PAR_MPC_C} candidates horizon 32: hard costs "
          f"equal, best {float(best_cost)}; scenario sweep {PAR_SWEEP_S} x {PAR_SWEEP_C} horizon "
          f"32 {PAR_SWEEP_ITERS} iterations: per-scenario hard costs equal, champion "
          f"{float(champ_cost)}")

    # The timings pair each runner with its entry doing the same work: the
    # two-phase beam with two passes of the entry, the second bounded by the
    # champion's population; the portfolio in one pass on both sides (the
    # entry's second pass, seeded over the big ZOI, is other work than the
    # runner's champion-bounded one).
    def beam_two_pass():
        res = unsharded["beam_complete"]()
        key = torch.where(res.found, res.best_pop.to(torch.int64).clamp(max=elite.SENTINEL),
                          elite.SENTINEL)
        return C.complete_stable_beam(beam_bst, frontier=BEAM_F, iters=BEAM_ITERS, dense=False,
                                      init_bound=key.min().reshape(1))

    timed = dict(sharded)
    timed["portfolio"] = lambda: elite.sharded_portfolio(
        anchors, pf_unknown, torch.Generator().manual_seed(0), mesh, replicas=PF_REPLICAS,
        frontier=4, iters=PF_ITERS, two_phase=False)
    unsharded["beam_complete_two_phase"] = beam_two_pass
    unsharded["portfolio"] = lambda: C.complete_stable_portfolio(
        anchors, pf_unknown, torch.Generator().manual_seed(0), replicas=PF_REPLICAS,
        frontier=4, iters=PF_ITERS, reminimise=False)
    one, one_ref = timed["portfolio"](), unsharded["portfolio"]()
    check(one.found and one.best_pop == one_ref.best_pop and torch.equal(one.best, one_ref.best),
          f"one-pass sharded_portfolio pop {one.best_pop} != complete_stable_portfolio's "
          f"(reminimise=False) {one_ref.best_pop}")
    print(f"[parallel] one-pass portfolio: sharded champion == unsharded (pop {one.best_pop})")

    print(f"[parallel] host-clock seconds, sharded at world size 1 / unsharded entry on the "
          f"same work (two-phase beam: two passes of the entry; portfolio: one pass each), in "
          f"turns (unsharded, sharded, sharded, unsharded) ({card}):")
    for name, fn in timed.items():
        times = {"sharded": [], "unsharded": []}
        turns = PAR_TURNS.get(name, 2)
        for which in ("unsharded", "sharded", "sharded", "unsharded")[:2 * turns]:
            times[which].append(wall(fn if which == "sharded" else unsharded[name], 1))
        sh, un = statistics.median(times["sharded"]), statistics.median(times["unsharded"])
        print(f"[parallel]   {name}: {sh:.4f} s / {un:.4f} s ({sh / un:.3f}x, "
              f"{turns} turn{'s' if turns > 1 else ''} each)")
    # what the exchange is made of: one all-reduce of a key, one gather of
    # the beam's boards (the one-pass beam runner does 3 of each)
    key = torch.zeros(1, dtype=torch.int64, device=dev)
    best = want["beam_complete"].best
    reduce_ms = wall(lambda: elite._reduce(key, dist.ReduceOp.MIN), 20) * 1e3
    gather_ms = wall(lambda: elite._gather(best), 20) * 1e3
    print(f"[parallel] host clock, median of 20, fenced: one all-reduce of int64[1] "
          f"{reduce_ms:.4f} ms, one gather of int64[{BEAM_B}, 64] {gather_ms:.4f} ms")
    destroy()
    check(not dist.is_initialized(), "the process group outlived the phase")


def bench_problem(dev):
    """The MPC bench problem (bench.py): steer the empty board to a block
    at (31, 31) in 32 generations through toggles in ``[20:44, 20:44]``."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import rle
    from lifeapi_tpu_torch.mpc import CostWeights, MPCProblem
    from lifeapi_tpu_torch.target import LifeTarget

    mask = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    mask[20:44, 20:44] = True
    target = LifeTarget.from_state(B.move(rle.parse("2o$2o!", device=dev), 31, 31))
    return MPCProblem(initial=B.empty(device=dev), target=target, horizon=32,
                      control_mask=mask, weights=CostWeights())


def roofline_phase(sass, dev_ms, card):
    """The plain circuits' lane-op counts (``utils.roofline``), before and
    after CSE, traced on CPU tensors and on CUDA tensors (equal, and no
    more after CSE than before); beside each, the SASS of the kernel that
    runs the circuit and the kernel's rate in the circuit's lane-ops, from
    its device time, as a share of the card's 32-bit lane-op peak."""
    from lifeapi_tpu_torch.utils import roofline as R

    counters = {"step": R.step_lane_ops_per_board,
                "fixpoint step": R.fixpoint_step_lane_ops_per_board,
                "simple step": R.simple_step_lane_ops_per_board}
    reset_counters()
    t0 = time.perf_counter()
    counts = {}
    for name, fn in counters.items():
        got = {(dev, post): fn(post_cse=post, device=dev)
               for dev in ("cpu", "cuda") for post in (False, True)}
        check(got["cpu", False] == got["cuda", False] and got["cpu", True] == got["cuda", True],
              f"[roofline] {name}: the counts on the CPU and on the card differ: {got}")
        check(got["cpu", True] <= got["cpu", False],
              f"[roofline] {name}: more lane-ops after CSE than before: {got}")
        counts[name] = got["cpu", False], got["cpu", True]
    seconds = time.perf_counter() - t0
    read_counters("roofline", ())
    peak = R.card_issue_peak() * R.LANES
    print(f"[roofline] lane-ops a board of the plain circuits (32-bit lane-ops, an int64 "
          f"element 2), traced on the CPU and on the card, equal, in {seconds:.2f} s; before "
          f"/ after CSE: " + "; ".join(f"{k} {a} / {b}" for k, (a, b) in counts.items()))
    print(f"[roofline] the card's 32-bit lane-op peak {peak:.6g}/s (SMs x 4 x 32 x "
          f"clocks.max.sm; {card})")
    work = {"rollout": ("step", HEADLINE_B * HEADLINE_T, "a board-generation"),
            "rollout_lohi": ("step", HEADLINE_B * HEADLINE_T, "a board-generation"),
            "propagate_step": ("fixpoint step", FIX_B, "a board")}
    for kernel, (circuit, units, per) in work.items():
        d, mhz = dev_ms[kernel]
        ops = counts[circuit][1]
        rate = ops * units / (d * 1e-3)
        print(f"[roofline] {kernel}: the plain circuit's count, not the kernel's: {ops} "
              f"lane-ops {per} after CSE; the kernel's SASS {sass[kernel]:g} warp "
              f"instructions {per} ({32 * sass[kernel]:g} thread instructions); on the device "
              f"{d:.4f} ms ({mhz} MHz) for {units} of them: {rate:.6g} circuit lane-ops/s, "
              f"{R.pct_of_peak(rate, peak):.1f}% of the lane-op peak")


def entry_phase(dev, card):
    """``graft_entry``'s forward step on the card at the entry's own shape
    (4 candidates, horizon 8) and at the MPC bench's width (64 candidates,
    horizon 32), each with the counters set to 0 just before: the soft
    costs against the same call on the CPU (rtol 1e-4), the hard costs and
    finals of kernel [2] against ``controlled_rollout_plain`` and the
    finals against the numpy step of the toggles (exactly); then each
    forward's host time and the device's busy share."""
    from lifeapi_tpu_torch import graft_entry
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.examples import life_step_dense
    from lifeapi_tpu_torch.mpc import solver
    from lifeapi_tpu_torch.ops import step_cuda

    fn, (logits,) = graft_entry.entry()
    check(logits.device.type == "cuda", "entry() given no device did not build on the card")
    bench = bench_problem(dev)
    shapes = {
        "entry (4 candidates, horizon 8)": (
            fn, graft_entry.forward_step(graft_entry.flagship_problem("cpu")),
            graft_entry.flagship_problem(dev), logits),
        "MPC bench width (64 candidates, horizon 32)": (
            graft_entry.forward_step(bench),
            graft_entry.forward_step(bench_problem(torch.device("cpu"))), bench,
            solver.init_logits(torch.Generator().manual_seed(0), bench, 64)),
    }
    t_phase = time.perf_counter()
    for what, (forward, forward_cpu, problem, lg) in shapes.items():
        reset_counters()
        soft, hard, finals = forward(lg)
        read_counters("entry", ("controlled_rollout",))
        soft_cpu = forward_cpu(lg.cpu())[0]
        check(torch.allclose(soft.cpu(), soft_cpu, rtol=1e-4, atol=0),
              f"[entry] {what}: soft costs on the card {soft.tolist()} != the CPU's "
              f"{soft_cpu.tolist()}")
        toggles = solver.candidate_toggles(torch.sigmoid(lg) * problem.control_mask, problem)
        starts = problem.initial.expand(toggles.shape[1], 64).contiguous()
        finals_p = step_cuda.controlled_rollout_plain(starts, toggles)
        check(torch.equal(finals, finals_p)
              and torch.equal(hard, solver.hard_cost(finals_p, toggles, problem)),
              f"[entry] {what}: kernel [2]'s finals or hard costs != the plain version's")
        cells = B.to_dense(starts).cpu().numpy()
        for tog in B.to_dense(toggles).cpu().numpy():
            cells = life_step_dense(cells ^ tog)
        check((cells == B.to_dense(finals).cpu().numpy()).all(),
              f"[entry] {what}: the finals leave the numpy step of the toggles")
        print(f"[entry] {what}: soft costs = the CPU's at rtol 1e-4 (max relative "
              f"{float(((soft.cpu() - soft_cpu).abs() / soft_cpu.abs()).max()):.3g}); hard "
              f"costs and finals = controlled_rollout_plain and the numpy step; best hard "
              f"cost {float(hard.min())}")
        print_share("entry", f"forward, {what}, median of 3 ({card})",
                    device_share(lambda: forward(lg)))
    print(f"[entry] phase {time.perf_counter() - t_phase:.2f} s")


def dryrun_phase(card):
    """``graft_entry.dryrun_multichip`` over every card of the machine
    (NCCL), with the counters set to 0 just before; one card runs it in
    this process, whose counters must show [1], [2], [3] and [10]."""
    import torch.distributed as dist

    from lifeapi_tpu_torch import graft_entry

    check(not dist.is_initialized(), "[dryrun] a process group outlived [parallel]")
    n = torch.cuda.device_count()
    reset_counters()
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(n)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if n == 1:
        read_counters("dryrun", PARALLEL_KERNELS)
    check(not dist.is_initialized(), "[dryrun] the dry run left a process group")
    print(f"[dryrun] dryrun_multichip({n}) over NCCL, world size {n}: every assertion held "
          f"against the one-rank mesh in {seconds:.2f} s ({card})")


def adversarial_phase(dev, card, err):
    """The 224-instance beam-vs-DFS sweep of ``tests/test_beam_adversarial.py``
    (``tests/torch_beam_sweep.py``) through kernel [10] at F = 8, 96 rounds,
    with the counters set to 0 just before: the four properties against the
    host DFS, then the kernel against its plain version on the same planes,
    bit for bit."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_beam_sweep as S
    from lifeapi_tpu_torch.stable import bitplane as BP
    from lifeapi_tpu_torch.stable import complete as C
    from lifeapi_tpu_torch.stable import propagate as P

    states, unknowns = S.sweep_instances()
    st = P.make(state=torch.from_numpy(states).to(dev), unknown=torch.from_numpy(unknowns).to(dev))
    kw = dict(frontier=S.FRONTIER, iters=S.ITERS, minimise=False)
    reset_counters()
    t0 = time.perf_counter()
    res = C.complete_stable_beam(st, **kw)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    read_counters("adversarial", ("beam_search",))
    t0 = time.perf_counter()
    dfs = S.dfs_verdicts(states, unknowns)
    dfs_s = time.perf_counter() - t0
    n_found, n_proved = S.check_sweep(
        states, unknowns, res.found.cpu().numpy(), res.best.cpu().numpy(),
        res.proved_inconsistent.cpu().numpy(), dfs)
    planes = BP.to_planes(BP.from_dense_stable(st)).contiguous()
    t0 = time.perf_counter()
    kernel_vs_plain("beam_search", (planes,), kw, err)
    compare_s = time.perf_counter() - t0
    print(f"[adversarial] {S.N_INSTANCES} instances (seed {S.SEED}), F={S.FRONTIER}, "
          f"{S.ITERS} rounds: {n_found} finds, {n_proved} proofs, each find a still life "
          f"keeping its knowns, each proof DFS-inconsistent, no DFS completion proved "
          f"inconsistent; kernel [10] == beam_search_plain ({compare_s:.3f} s for both); the "
          f"beam {beam_s:.3f} s on the card (the first call, host clock), the host DFS "
          f"{dfs_s:.3f} s ({card})")


def sqp_problem(dev, horizon):
    """North-star config 3's shape: steer to a block at (40, 40) while a
    protected block at (10, 10) (its ZOI) stays (tests/test_mpc.py
    ``test_stable_background_constraint``)."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import rle
    from lifeapi_tpu_torch.mpc import CostWeights, MPCProblem
    from lifeapi_tpu_torch.target import LifeTarget

    block = B.move(rle.parse("2o$2o!", device=dev), 10, 10)
    mask = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    mask[36:46, 36:46] = True
    target = LifeTarget.from_state(B.move(rle.parse("2o$2o!", device=dev), 40, 40))
    return MPCProblem(initial=block, target=target, horizon=horizon, control_mask=mask,
                      protected=B.to_dense(B.zoi(block)), background=block,
                      weights=CostWeights(target=1.0, control=0.01, stable=5.0))


def sqp_phase(dev, card):
    """``solve(method="sqp")`` at config 3's full width (64 candidates,
    horizon 32), its seconds split by stage, then its checks, kernel [2]
    against its plain version on every candidate, and the toy problem's
    known answer."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.examples import mpc_demo
    from lifeapi_tpu_torch.mpc import solver
    from lifeapi_tpu_torch.ops import step_cuda
    from lifeapi_tpu_torch.target import hamming_cost

    problem = sqp_problem(dev, SQP_HORIZON)
    hvps = []  # host seconds of each Hessian-vector product, fenced
    cg = solver.conjugate_gradients

    def timed_cg(matvec, b, maxiter):
        def timed(v):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = matvec(v)
            torch.cuda.synchronize()
            hvps.append(time.perf_counter() - t0)
            return out

        return cg(timed, b, maxiter)

    with spying(solver, "solve_gradient") as warm, spying(solver, "solve_sqp") as sqp, \
            spying(solver, "rescore_and_select") as rescore, \
            replaced(solver, "conjugate_gradients", timed_cg):
        reset_counters()
        t0 = time.perf_counter()
        sol = solver.solve(problem, torch.Generator().manual_seed(0), n_candidates=SQP_C,
                           method="sqp", iters=SQP_ITERS)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    sqp_counts = read_counters("sqp", ("controlled_rollout", *OBJECTIVE_KERNELS,
                                       *UPDATE_KERNELS))
    print(f"[sqp] card: {card}")
    print(f"[sqp] config 3 ({SQP_C} candidates, horizon {SQP_HORIZON}, warm-up "
          f"{max(SQP_ITERS // 3, 10)} adam iterations, 8 Newton steps of 12 CG iterations): "
          f"{total:.3f} s: warm-up {warm[0].seconds:.3f} s, Newton steps "
          f"{sqp[0].seconds:.3f} s (of it {len(hvps)} HVPs {sum(hvps):.3f} s, "
          f"{statistics.median(hvps) * 1e3:.1f} ms each, median), rescoring "
          f"{rescore[0].seconds:.4f} s")

    with torch.no_grad():
        before = solver.soft_objective(warm[0].out[0], problem)
        after = solver.soft_objective(sqp[0].out, problem)
    print(f"[sqp] best soft objective: warm-up {float(before.min()):.4f}, after SQP "
          f"{float(after.min()):.4f}; {int((after < before).sum())}/{SQP_C} candidates improved")
    check(float(after.min()) <= float(before.min()), "SQP raised the best soft objective")
    check(bool((after <= before).all()), "SQP raised a candidate's soft objective")

    probs = torch.sigmoid(rescore[0].args[0]) * problem.control_mask
    toggles = solver.candidate_toggles(probs, problem)
    starts = problem.initial.expand(SQP_C, 64).contiguous()
    finals_k = step_cuda.controlled_rollout(starts, toggles)
    finals_p = step_cuda.controlled_rollout_plain(starts, toggles)
    costs_k = solver.hard_cost(finals_k, toggles, problem)
    check(torch.equal(finals_k, finals_p), "[sqp] controlled kernel != plain twin")
    check(torch.equal(costs_k, solver.hard_cost(finals_p, toggles, problem)),
          "[sqp] hard costs: kernel != plain twin")
    check(torch.equal(costs_k, sol.all_costs), "[sqp] rescoring is not reproducible")
    protected = B.from_dense(problem.protected)
    moved = B.population((finals_k ^ problem.background) & protected)
    kept = B.contains(finals_k, problem.background)
    check(bool((kept | (costs_k >= problem.weights.stable * moved)).all()),
          "[sqp] a final board lost the background and its cost does not count it")
    print(f"[sqp] {SQP_C} hard costs kernel == plain; best {float(sol.cost)}, Hamming "
          f"{int(hamming_cost(sol.final_board, problem.target))}; "
          f"{int(kept.sum())}/{SQP_C} final boards keep the background block")

    # where a Newton step's time goes: one HVP, one gradient of the
    # objective, one CG iteration and its update, at the solve's final logits
    launches = sqp_launches(problem, sqp[0].out, "sqp")
    check(launches["gradient"] <= GRADIENT_LAUNCHES and launches["hvp"] <= HVP_LAUNCHES
          and launches["cg_iteration"] - launches["hvp"] <= CG_UPDATE_LAUNCHES,
          f"[sqp] launches {launches} over ({GRADIENT_LAUNCHES}, {HVP_LAUNCHES}, "
          f"{CG_UPDATE_LAUNCHES}) a gradient, an HVP and a CG iteration's update")

    # known answer: tests/test_mpc.py test_sqp_solver_improves
    toy = mpc_demo.problem(dev, horizon=6)
    logits0 = solver.init_logits(torch.Generator().manual_seed(2), toy, 4)
    start = solver.soft_objective(logits0, toy)
    logits, _ = solver.solve_gradient(logits0, toy, iters=30)
    logits = solver.solve_sqp(logits, toy, iters=3, cg_iters=8)
    end = solver.soft_objective(logits, toy)
    check(float(end.min()) < float(start.min()), "SQP toy problem: no improvement")
    print(f"[sqp] toy problem: best soft objective {float(start.min()):.4f} -> "
          f"{float(end.min()):.4f}")
    return total, sqp_counts


def sqp_launches(problem, logits, path):
    """Print the host and device milliseconds and the kernels (torch.profiler)
    of one gradient of ``solver.soft_objective`` as an adam iteration takes
    it, one HVP, one CG update and one CG iteration (its matvec, the damping
    and the update, from a 12-iteration solve) at ``logits``; return the
    kernels of each."""
    from lifeapi_tpu_torch.mpc import solver
    from lifeapi_tpu_torch.ops import solver_cuda

    def objective(x):
        return solver.soft_objective(x, problem)

    _, g, hvp = solver.grad_and_hvp(objective, logits)
    direction = torch.randn(logits.shape, generator=torch.Generator(device=logits.device)
                            .manual_seed(1), device=logits.device)
    x = torch.zeros(g.shape, device=g.device)
    r, p = (-g).contiguous(), (-g).contiguous()
    gamma = solver_cuda.batch_dot(r, r)
    stop = solver.CG_TOL ** 2 * gamma
    calls = {"gradient": (lambda: solver.value_and_grad(objective, logits), 1,
                          "one gradient of the objective (an adam iteration's autograd)"),
             "hvp": (lambda: hvp(direction), 1, f"one HVP of the {logits.shape[0]} candidates"),
             "cg_update": (lambda: solver_cuda.cg_update(x, r, p, direction, gamma, stop), 1,
                           "one CG iteration's update"),
             "cg_iteration": (lambda: solver.conjugate_gradients(
                 lambda v: torch.add(hvp(v), v, alpha=0.5), -g, 12), 12,
                 "one CG iteration, its matvec with the damping's add (a solve of 12)")}
    launches = {}
    for name, (fn, per, what) in calls.items():
        n, ops = launches_of(fn)
        launches[name] = n / per
        host_ms, dev_ms, kernels = device_share(fn, n=3 if per == 1 else 1)
        print(f"[{path}] {what}: {n / per:.2f} launches (aten {ops[:8]}{'...' if len(ops) > 8 else ''}); "
              f"{host_ms / per:.3f} ms on the host clock, at least {dev_ms / per:.3f} ms on the "
              f"device in the {kernels / per:.2f} kernels a trace kept "
              f"({dev_ms / host_ms:.1%} busy)")
    del hvp
    return launches


def candidate_errs(got, want):
    """Each candidate's relative error over its cells, candidates on dim 1
    of generation-major ``[T, C, 64, 64]`` tensors, in float64."""
    got, want = got.double(), want.double()
    diff = (got - want).movedim(1, 0).flatten(1).norm(dim=1)
    return diff / want.movedim(1, 0).flatten(1).norm(dim=1)


def soft_inputs(dev, problem, cands, seed=0):
    """The soft objective's rollout inputs at the [sqp] shapes: the start
    board, and the controls of ``init_logits``'s draw as ``soft_objective``
    hands them over (a ``movedim`` view)."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.mpc import solver

    logits = solver.init_logits(torch.Generator().manual_seed(seed), problem, cands)
    controls = (torch.sigmoid(logits) * problem.control_mask).movedim(-3, 0)
    return B.to_dense(problem.initial).to(torch.float32), controls


def soft_phase(dev, card, ms, plain_ms, dev_ms):
    """The soft-Life sweeps at the [sqp] shapes (64 candidates, horizon 32)
    against their plain twins on the same inputs: the forward bit for bit at
    SOFT_ROLLOUT_C candidates (among them the line search's 192); the three
    sweeps' launch shapes (``soft_sweeps_report``), then the VJP on the
    cost's own cotangent of the trajectory and the HVP sweep along a
    direction in the control window at 8, 64 and 192 candidates
    (``soft_adjoint_checks``); then each sweep's call and device time beside
    its bound at 64, and the forward's at 192.  Fills ``ms``, ``plain_ms``
    and ``dev_ms``; returns (max_abs_err, bounds) by kernel."""
    from lifeapi_tpu_torch.ops import soft_cuda

    problem = sqp_problem(dev, SQP_HORIZON)
    tau = problem.tau
    p0, controls = soft_inputs(dev, problem, SQP_C)
    err = {"soft_rollout": 0.0}
    for seed, cands in enumerate(SOFT_ROLLOUT_C):
        p_c, c_c = (p0, controls) if cands == SQP_C else soft_inputs(dev, problem, cands, seed)
        before = soft_cuda.LAUNCHES["soft_rollout"]
        traj = soft_cuda.rollout(p_c, c_c, tau)
        check(soft_cuda.LAUNCHES["soft_rollout"] == before + 1,
              f"[soft] forward sweep at {cands} candidates: not one launch")
        want = soft_cuda.rollout_plain(p_c, c_c, tau)
        err["soft_rollout"] = max(err["soft_rollout"], max_err(traj, want))
        check(torch.equal(traj, want), f"[soft] forward sweep != its plain twin at {cands} "
              f"candidates")
    print(f"[soft] forward sweep == plain twin bit for bit at {SOFT_ROLLOUT_C} candidates, "
          f"horizon {SQP_HORIZON}, one launch each (controls read through the movedim view's "
          f"strides {tuple(controls.stride())})")

    soft_sweeps_report(card)
    err["soft_rollout_vjp"] = err["soft_rollout_hvp"] = 0.0
    for cands in (SOFT_FEW_C, SQP_C, 3 * SQP_C):
        p_c, c_c = (p0, controls) if cands == SQP_C else soft_inputs(dev, problem, cands, seed=2)
        inputs, errs = soft_adjoint_checks(problem, p_c, c_c, card)
        for name, e in errs.items():
            err[name] = max(err[name], e)
        if cands == SQP_C:
            traj, g_traj, w, vjp = inputs

    calls = {"soft_rollout": (lambda: soft_cuda.rollout(p0, controls, tau),
                              lambda: soft_cuda.rollout_plain(p0, controls, tau)),
             "soft_rollout_vjp": (lambda: soft_cuda.rollout_vjp(p0, controls, traj, g_traj, tau),
                                  lambda: soft_cuda.rollout_vjp_plain(p0, controls, traj,
                                                                      g_traj, tau, False)),
             "soft_rollout_hvp": (lambda: soft_cuda.rollout_hvp(p0, controls, traj, vjp[2], w,
                                                                None, tau),
                                  lambda: soft_cuda.rollout_hvp_plain(p0, controls, traj, vjp[2],
                                                                      w, None, tau, False))}
    cells = controls.shape[0] * SQP_C * 4096
    bounds = {}
    for name, (kernel_fn, plain_fn) in calls.items():
        ms[name], plain_ms[name] = paired_ms(kernel_fn, plain_fn, reps=10)
        dev_ms[name] = device_ms_at(kernel_fn, SOFT_KERNELS[name], name)
        by_bytes = SOFT_BOARDS_MOVED[name] * cells * 4 / HBM_BYTES_PER_S * 1e3
        by_ops = SOFT_FLOP_PER_CELL[name] * cells / FP32_FLOP_PER_S * 1e3
        bounds[name] = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
        d, mhz = dev_ms[name]
        print(f"[soft] {name} ({SOFT_KERNELS[name]}), {SQP_C} candidates x horizon "
              f"{SQP_HORIZON}: call {ms[name]:.4f} ms, on the device {d:.4f} ms (SM clock "
              f"{mhz} MHz), bound {by_bytes:.4f} ms by bytes ({SOFT_BOARDS_MOVED[name]} boards "
              f"a cell-generation, {SOFT_BOARDS_MOVED[name] * cells * 4 / 1e6:.1f} MB) and "
              f"{by_ops:.4f} ms by float32 operations, so {d / bounds[name][0]:.3g}x its bound; "
              f"plain twin {plain_ms[name]:.3f} ms ({card})")
    # the forward at the line search's candidates, for the record only
    p_ls, c_ls = soft_inputs(dev, problem, 3 * SQP_C, seed=1)
    kernel_fn = lambda: soft_cuda.rollout(p_ls, c_ls, tau)  # noqa: E731
    call, plain = paired_ms(kernel_fn, lambda: soft_cuda.rollout_plain(p_ls, c_ls, tau), reps=10)
    d, mhz = device_ms_at(kernel_fn, SOFT_KERNELS["soft_rollout"], "soft_rollout")
    by_bytes = SOFT_BOARDS_MOVED["soft_rollout"] * 3 * cells * 4 / HBM_BYTES_PER_S * 1e3
    print(f"[soft] soft_rollout ({SOFT_KERNELS['soft_rollout']}), {3 * SQP_C} candidates x "
          f"horizon {SQP_HORIZON}: call {call:.4f} ms, on the device {d:.4f} ms (SM clock "
          f"{mhz} MHz), bound {by_bytes:.4f} ms by bytes, so {d / by_bytes:.3g}x its bound; "
          f"plain twin {plain:.3f} ms ({card})")
    return err, bounds


def soft_sweeps_report(card):
    """The sweeps' launch shapes on this card, in both modes: ptxas's
    registers and spill bytes of each, and the threads, dynamic shared memory
    and residency of its clusters of two CTAs.  Fails if a sweep spills."""
    from lifeapi_tpu_torch.ops import _build, soft_cuda

    sweeps = {*SOFT_KERNELS.values(), *OBJECTIVE_KERNELS.values()}
    rows = [(name, regs, spill) for name, regs, spill in
            ptxas_report(_build.library_path().with_suffix(".log").read_text())
            if name in sweeps]
    for name, regs, spill in rows:
        print(f"[soft] ptxas: {name}: {regs} registers, {spill} bytes spill stores")
    check(len(rows) == len(sweeps), f"[soft] expected the six sweeps, got {rows}")
    check(all(spill == 0 for _, _, spill in rows), f"[soft] a sweep spills: {rows}")
    for name in soft_cuda.SWEEP_KERNELS:
        info = soft_cuda.sweep_info(name)
        print(f"[soft] {name}: clusters of 2 CTAs a candidate, {info['threads']} threads and "
              f"{info['shared']} bytes of dynamic shared memory a CTA, {info['ctas_per_sm']} "
              f"CTA(s) an SM, {info['clusters']} clusters resident at once ({card})")


def soft_adjoint_checks(problem, p0, controls, card):
    """The VJP on the cost's own cotangent of the trajectory and the HVP
    sweep along a direction in the control window, each launched once and
    held to its float32 twin within SOFT_TWIN_TOL and to its float64 twin
    within SOFT_F64_RATIO of the float32 twin, at ``controls``' candidates.
    Returns ((traj, g_traj, w, the VJP's outputs), max_abs_err by kernel)."""
    from lifeapi_tpu_torch.mpc import cost as cost_mod
    from lifeapi_tpu_torch.ops import soft_cuda

    tau, dev = problem.tau, controls.device
    cands = controls.shape[1]
    traj = soft_cuda.rollout(p0, controls, tau)
    leaf = traj.detach().requires_grad_(True)
    with torch.enable_grad():
        total = cost_mod.soft_total(leaf[-1], leaf, controls, problem.target, problem.protected,
                                    problem.weights)
        (g_traj,) = torch.autograd.grad(total.sum(), leaf)
    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn(controls.shape, generator=gen, device=dev) * problem.control_mask
    launches = dict(soft_cuda.LAUNCHES)
    vjp = soft_cuda.rollout_vjp(p0, controls, traj, g_traj, tau)
    vjp_p = soft_cuda.rollout_vjp_plain(p0, controls, traj, g_traj, tau, False)
    vjp_64 = soft_cuda.rollout_vjp_plain(*(t.double() for t in (p0, controls, traj, g_traj)),
                                         tau, False)
    hvp = soft_cuda.rollout_hvp(p0, controls, traj, vjp_p[2], w, None, tau)
    hvp_p = soft_cuda.rollout_hvp_plain(p0, controls, traj, vjp_p[2], w, None, tau, False)
    hvp_64 = soft_cuda.rollout_hvp_plain(*(t.double() for t in (p0, controls, traj, vjp_p[2], w)),
                                         None, tau, False)
    torch.cuda.synchronize()
    for name in ("soft_rollout_vjp", "soft_rollout_hvp"):
        check(soft_cuda.LAUNCHES[name] == launches[name] + 1,
              f"[soft] {name} at {cands} candidates: not one launch")
    print(f"[soft] VJP and HVP sweeps at {cands} candidates x horizon {controls.shape[0]}: "
          f"2 CTAs a candidate, {cands * 2} CTAs ({card})")
    err = {}
    for name, pairs in (("soft_rollout_vjp", (("g_u", 0), ("lam", 2))),
                        ("soft_rollout_hvp", (("jw", 0), ("pu", 1), ("px", 2)))):
        got, plain, plain64 = (vjp, vjp_p, vjp_64) if name == "soft_rollout_vjp" else \
            (hvp, hvp_p, hvp_64)
        err[name] = max(max_err(got[i], plain[i]) for _, i in pairs)
        for what, i in pairs:
            errs = candidate_errs(got[i], plain[i])
            own = candidate_errs(got[i].double(), plain64[i])
            twin = candidate_errs(plain[i].double(), plain64[i])
            print(f"[soft] {name} {what} at {cands}: a candidate's relative error, kernel against "
                  f"the float32 twin median {float(errs.median()):.3g} largest "
                  f"{float(errs.max()):.3g} (max_abs_err {max_err(got[i], plain[i]):.3g}); against "
                  f"the float64 twin, kernel median {float(own.median()):.3g} largest "
                  f"{float(own.max()):.3g}, float32 twin median {float(twin.median()):.3g} largest "
                  f"{float(twin.max()):.3g}")
            check(float(errs.max()) <= SOFT_TWIN_TOL,
                  f"[soft] {name} {what} at {cands}: kernel != float32 twin within {SOFT_TWIN_TOL}")
            check(all(float(f(own)) <= SOFT_F64_RATIO * float(f(twin)) + 1e-6
                      for f in (torch.median, torch.max)),
                  f"[soft] {name} {what} at {cands}: kernel further from float64 than "
                  f"{SOFT_F64_RATIO}x the float32 twin")
    return (traj, g_traj, w, vjp), err


def objective_inputs(dev, problem, cands, seed=0):
    """The objective's inputs at [sqp]'s shapes: ``init_logits``' draw and
    the problem as the objective's sweeps read it."""
    from lifeapi_tpu_torch.mpc import solver

    logits = solver.init_logits(torch.Generator().manual_seed(seed), problem, cands)
    return logits, solver.objective_inputs(problem)


def by_candidate_errs(got, want):
    """``candidate_errs`` of ``[C, T, 64, 64]`` arrays."""
    return candidate_errs(got.movedim(0, 1), want.movedim(0, 1))


def check_as_accurate(name, got, want32, want64, tol=SOFT_TWIN_TOL):
    """Each candidate's relative error within ``tol`` of the float32 twin,
    and no further from the float64 twin than SOFT_F64_RATIO times the
    float32 twin is (plus 1e-6); prints both.  Returns max_abs_err against
    the float32 twin."""
    errs, own, twin = (by_candidate_errs(a, b) for a, b in
                       ((got, want32), (got.double(), want64), (want32.double(), want64)))
    print(f"[update] {name}: a candidate's relative error against the float32 twin median "
          f"{float(errs.median()):.3g} largest {float(errs.max()):.3g}; against the float64 "
          f"twin, kernel median {float(own.median()):.3g} largest {float(own.max()):.3g}, "
          f"float32 twin median {float(twin.median()):.3g} largest {float(twin.max()):.3g}")
    check(float(errs.max()) <= tol, f"[update] {name}: kernel != float32 twin within {tol}")
    check(all(float(f(own)) <= SOFT_F64_RATIO * float(f(twin)) + 1e-6
              for f in (torch.median, torch.max)),
          f"[update] {name}: kernel further from float64 than {SOFT_F64_RATIO}x the twin")
    return max_err(got, want32)


def one_launch(counter, fn):
    """fn's result; fails unless it launched ``counter``'s kernel once."""
    before = launch_count(counter)
    out = fn()
    torch.cuda.synchronize()
    check(launch_count(counter) == before + 1, f"[update] {counter}: not one launch")
    return out


def objective_checks(dev, problem, cands, seed):
    """The objective's three sweeps at ``cands`` candidates against their
    twins, each one launch: the forward's trajectory bit for bit and its
    values, the adjoint on a values' cotangent other than 1, the HVP sweep
    and the adjoint on its state partials.  Returns (the inputs and
    outputs at these candidates, max_abs_err by kernel)."""
    from lifeapi_tpu_torch.ops import soft_cuda

    logits, ob = objective_inputs(dev, problem, cands, seed)
    tau = problem.tau
    value, traj = one_launch("soft_objective", lambda: soft_cuda.objective(logits, ob, tau))
    value32, traj32 = soft_cuda.objective_plain(logits, ob, tau)
    value64, _ = soft_cuda.objective_plain(logits.double(), ob, tau)
    check(torch.equal(traj, traj32), f"[update] objective's trajectory != twin at {cands}")
    err = {"soft_objective": max_err(value, value32)}
    rel = float(((value - value32).abs() / value32.abs()).max())
    own = float(((value.double() - value64).abs() / value64.abs()).max())
    twin = float(((value32.double() - value64).abs() / value64.abs()).max())
    print(f"[update] soft_objective at {cands}: trajectory == twin bit for bit; values' "
          f"largest relative error {rel:.3g} against the float32 twin, {own:.3g} against the "
          f"float64 twin (the float32 twin {twin:.3g})")
    check(rel <= SOFT_TWIN_TOL and own <= SOFT_F64_RATIO * twin + 1e-6,
          f"[update] objective's values at {cands}: {rel}, {own} against {twin}")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g_vals = torch.rand(cands, generator=gen, device=dev) + 0.5
    args = (logits, traj, None, g_vals, None, ob, tau, True)
    grad, lam = one_launch("soft_objective_vjp", lambda: soft_cuda.objective_vjp(*args))
    want32 = soft_cuda.objective_vjp_plain(*args)
    want64 = soft_cuda.objective_vjp_plain(logits.double(), traj.double(), None,
                                           g_vals.double(), None, ob, tau, True)
    err["soft_objective_vjp"] = max(
        check_as_accurate(f"soft_objective_vjp {what} at {cands}", got, w32, w64)
        for what, got, w32, w64 in zip(("gradient", "adjoints"), (grad, lam), want32, want64))
    v = torch.randn(logits.shape, generator=gen, device=dev) * problem.control_mask
    args = (logits, traj, want32[1], want32[0], v, ob, tau)
    pu, px = one_launch("soft_objective_hvp", lambda: soft_cuda.objective_hvp(*args))
    hvp32 = soft_cuda.objective_hvp_plain(*args)
    hvp64 = soft_cuda.objective_hvp_plain(*(t.double() for t in args[:5]), ob, tau)
    err["soft_objective_hvp"] = max(
        check_as_accurate(f"soft_objective_hvp {what} at {cands}", got, w32, w64)
        for what, got, w32, w64 in zip(("pu", "px"), (pu, px), hvp32, hvp64))
    args = (logits, traj, hvp32[1], None, hvp32[0], ob, tau, False)
    hv, _ = one_launch("soft_objective_vjp", lambda: soft_cuda.objective_vjp(*args))
    hv32, _ = soft_cuda.objective_vjp_plain(*args)
    hv64, _ = soft_cuda.objective_vjp_plain(logits.double(), traj.double(), hvp32[1].double(),
                                            None, hvp32[0].double(), ob, tau, False)
    err["soft_objective_vjp"] = max(err["soft_objective_vjp"], check_as_accurate(
        f"soft_objective_vjp on the HVP's partials at {cands}", hv, hv32, hv64))
    return (logits, ob, traj, want32, v), err


def cg_state(dev, shape, seed, frozen=(0,)):
    """Seeded x, r, p, an A p near 2 p, gamma = <r, r> and a stopping level
    that freezes the systems ``frozen`` (twice their gamma)."""
    from lifeapi_tpu_torch.ops import solver_cuda

    gen = torch.Generator(device=dev).manual_seed(seed)
    x, r, p = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
    ap = 2 * p + 0.1 * torch.randn(shape, generator=gen, device=dev)
    gamma = solver_cuda.batch_dot(r, r)
    stop = torch.zeros_like(gamma)
    stop[list(frozen)] = 2 * gamma[list(frozen)]
    return x, r, p, ap, gamma, stop


def cg_checks(dev, shape, seed):
    """The CG update on seeded systems of ``shape`` against its twins, one
    launch each with ``ap`` apart and ``ap = p``, systems 0 and
    ``shape[0] // 2`` frozen (kept bit for bit), then two launches on the
    same inputs bit-equal.  Returns max_abs_err against the float32 twin."""
    from lifeapi_tpu_torch.ops import solver_cuda

    frozen = sorted({0, shape[0] // 2})
    x0, r0, p0, ap, gamma0, stop = cg_state(dev, shape, seed, frozen)
    active = [k for k in range(shape[0]) if k not in frozen]
    err = 0.0
    for alias in (False, True):
        state, twin = ([t.clone() for t in (x0, r0, p0, gamma0)] for _ in range(2))
        twin64 = [t.double() for t in (x0, r0, p0, gamma0)]
        one_launch("cg_update", lambda: solver_cuda.cg_update(
            *state[:3], state[2] if alias else ap, state[3], stop))
        solver_cuda.cg_update_plain(*twin[:3], twin[2] if alias else ap, twin[3], stop)
        solver_cuda.cg_update_plain(*twin64[:3], twin64[2] if alias else ap.double(), twin64[3],
                                    stop.double())
        for what, got, w32, w64 in zip("xrpg", state, twin, twin64):
            check(torch.equal(got[frozen], w32[frozen]),
                  f"[update] cg_update moved a frozen system's {what} at {shape}")
            if what != "g":
                err = max(err, check_as_accurate(
                    f"cg_update {what} at {shape}{' (ap = p)' if alias else ''}", got[active],
                    w32[active], w64[active], CG_TWIN_TOL))
        rel = float(((state[3] - twin[3]).abs() / twin[3].abs()).max())
        check(rel <= CG_TWIN_TOL, f"[update] cg_update gamma off its twin by {rel} at {shape}")
    runs = [[t.clone() for t in (x0, r0, p0, gamma0)] for _ in range(2)]
    for state in runs:
        solver_cuda.cg_update(*state[:3], ap, state[3], stop)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"[update] two launches of cg_update on the same inputs differ at {shape}")
    return err


def cg_shape_report():
    """The CG kernel's registers and spills (it fails on a spill) and its
    launch shape at [sqp]'s systems: a cluster a system, its CTAs' shared
    memory, the clusters resident at once and the waves of SQP_C systems."""
    from lifeapi_tpu_torch.ops import _build, solver_cuda

    regs, spill = next((regs, spill) for name, regs, spill in ptxas_report(
        _build.library_path().with_suffix(".log").read_text()) if name == "cg_update_kernel")
    info = solver_cuda.cg_update_info(SQP_HORIZON * 4096)
    sms = info["clusters"] * info["ctas"] // info["ctas_per_sm"]
    print(f"[update] cg_update_kernel: {regs} registers, {spill} bytes spill stores; a system "
          f"of {SQP_HORIZON * 4096} elements on a cluster of {info['ctas']} CTAs of "
          f"{info['threads']} threads, {info['shared']} bytes of shared memory a CTA (tiles of "
          f"{info['tile']} 16-byte pieces of p and of A p), {info['ctas_per_sm']} CTA(s) an SM, "
          f"{info['clusters']} clusters resident at once on {sms} SMs, so {SQP_C} systems are "
          f"{SQP_C / info['clusters']:.3g} waves")
    check(spill == 0, f"[update] cg_update_kernel spills {spill} bytes")


def update_phase(dev, card, ms, plain_ms, lib_ms, dev_ms):
    """The objective's sweeps (``objective_checks``: [sqp]'s 64 candidates,
    8 and the line search's 192), the CG update (``cg_checks`` at
    CG_SHAPES, then its registers and launch shape) and the adam step (bit
    for bit) at [sqp]'s shapes against their twins, then each one's call and
    device time beside its bound (the CG update's with system 0 frozen),
    the twin's time and, for adam, ``torch._fused_adam_``'s.  Fills ``ms``, ``plain_ms``, ``lib_ms``
    and ``dev_ms``; returns (max_abs_err, bounds) by kernel."""
    from lifeapi_tpu_torch.mpc import solver
    from lifeapi_tpu_torch.ops import soft_cuda, solver_cuda

    problem = sqp_problem(dev, SQP_HORIZON)
    tau = problem.tau
    err = dict.fromkeys((*OBJECTIVE_KERNELS, *UPDATE_KERNELS), 0.0)
    for seed, cands in enumerate((SOFT_FEW_C, SQP_C, 3 * SQP_C)):
        inputs, errs = objective_checks(dev, problem, cands, seed)
        err.update({k: max(err[k], e) for k, e in errs.items()})
        if cands == SQP_C:
            logits, ob, traj, (grad, lam), v = inputs

    for seed, shape in enumerate(CG_SHAPES):
        err["cg_update"] = max(err["cg_update"], cg_checks(dev, shape, seed))
    cg_shape_report()

    shape = logits.shape
    x0, r0, p0, ap, gamma0, stop = cg_state(dev, shape, 9)
    gen = torch.Generator(device=dev).manual_seed(10)

    count, lr = 3, 0.15
    grads = 1e-2 * torch.randn(shape, generator=gen, device=dev)
    mu, nu = 0.1 * grads, grads * grads
    adam = (logits, grads, mu, nu, count, lr, solver.ADAM_B1, solver.ADAM_B2, solver.ADAM_EPS)
    got = one_launch("adam_update", lambda: solver_cuda.adam_update(*adam))
    want = solver_cuda.adam_update_plain(*adam)
    check(all(torch.equal(a, b) for a, b in zip(got, want)), "[update] adam kernel != its twin")
    print(f"[update] cg_update == twin within {CG_TWIN_TOL} at {CG_SHAPES} (frozen systems "
          f"bit for bit, ap apart and ap = p, two launches bit-equal); adam_update == twin bit "
          f"for bit at {tuple(shape)}")

    state = [t.clone() for t in (x0, r0, p0, gamma0)]

    def restore():
        for t, t0 in zip(state, (x0, r0, p0, gamma0)):
            t.copy_(t0)

    fused = [torch.empty_like(t) for t in (logits, grads, mu, nu)]
    step = [torch.tensor(float(count), device=dev)]

    def restore_adam():
        for t, t0 in zip(fused, (logits, grads, mu, nu)):
            t.copy_(t0)

    def fused_adam():
        torch._fused_adam_([fused[0]], [fused[1]], [fused[2]], [fused[3]], [], step, lr=lr,
                           beta1=solver.ADAM_B1, beta2=solver.ADAM_B2, weight_decay=0.0,
                           eps=solver.ADAM_EPS, amsgrad=False, maximize=False)

    ones = torch.ones(SQP_C, device=dev)
    calls = {
        "soft_objective": (lambda: soft_cuda.objective(logits, ob, tau),
                           lambda: soft_cuda.objective_plain(logits, ob, tau), None),
        "soft_objective_vjp": (
            lambda: soft_cuda.objective_vjp(logits, traj, None, ones, None, ob, tau, True),
            lambda: soft_cuda.objective_vjp_plain(logits, traj, None, ones, None, ob, tau, True),
            None),
        "soft_objective_hvp": (
            lambda: soft_cuda.objective_hvp(logits, traj, lam, grad, v, ob, tau),
            lambda: soft_cuda.objective_hvp_plain(logits, traj, lam, grad, v, ob, tau), None),
        "cg_update": (lambda: solver_cuda.cg_update(*state[:3], ap, state[3], stop),
                      lambda: solver_cuda.cg_update_plain(*state[:3], ap, state[3], stop),
                      restore),
        "adam_update": (lambda: solver_cuda.adam_update(*adam),
                        lambda: solver_cuda.adam_update_plain(*adam), None)}
    cells = shape[0] * shape[1] * 4096
    bounds = {}
    for name, (kernel_fn, plain_fn, setup) in calls.items():
        ms[name], plain_ms[name] = paired_ms(kernel_fn, plain_fn, reps=10, setup=setup)
        kernel = OBJECTIVE_KERNELS.get(name) or UPDATE_KERNELS[name]
        timed = kernel_fn if setup is None else (lambda f=kernel_fn, s=setup: (s(), f()))
        dev_ms[name] = device_ms_at(timed, kernel, name)
        # the frozen system moves nothing
        active = cells - (shape[1] * 4096 if name == "cg_update" else 0)
        by_bytes = UPDATE_BOARDS_MOVED[name] * active * 4 / HBM_BYTES_PER_S * 1e3
        by_ops = UPDATE_FLOP_PER_CELL[name] * active / FP32_FLOP_PER_S * 1e3
        bounds[name] = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
        d, mhz = dev_ms[name]
        print(f"[update] {name} ({kernel}), {SQP_C} candidates x horizon {SQP_HORIZON}: call "
              f"{ms[name]:.4f} ms, on the device {d:.4f} ms (SM clock {mhz} MHz), bound "
              f"{by_bytes:.4f} ms by bytes ({UPDATE_BOARDS_MOVED[name]} boards a cell-generation)"
              f" and {by_ops:.4f} ms by float32 operations, so {d / bounds[name][0]:.3g}x its "
              f"bound; plain twin {plain_ms[name]:.3f} ms{before_redesign(name, d)} ({card})")
    lib_ms["adam_update"] = paired_ms(fused_adam, lambda: None, reps=10, setup=restore_adam)[0]
    print(f"[update] adam_update beside torch._fused_adam_ on the same tensors, in place on "
          f"copies made before each call: {lib_ms['adam_update']:.4f} ms ({card})")
    return err, bounds


def composed_phase(dev, card):
    """The public ``soft.soft_rollout``'s autograd Functions, the plain sweeps,
    as ``solver.composed_objective`` drives them (on the CPU and under a
    replaced map it is the objective): three adam iterations and a Newton
    step of [sqp]'s width with ``solver.soft_objective`` replaced by it, the
    counters at 0 just before; then its launches and times a gradient and an
    HVP beside the fused objective's, on the same logits.  Returns the
    counters."""
    from lifeapi_tpu_torch.mpc import solver

    problem = sqp_problem(dev, SQP_HORIZON)
    logits = solver.init_logits(torch.Generator().manual_seed(4), problem, SQP_C)
    with replaced(solver, "soft_objective", solver.composed_objective):
        reset_counters()
        logits, _ = solver.solve_gradient(logits, problem, iters=3)
        logits = solver.solve_sqp(logits, problem, iters=1)
        counts = read_counters("composed", SOFT_KERNELS)
        sqp_launches(problem, logits, "composed")
    sqp_launches(problem, logits, "fused")
    print(f"[composed] the plain sweeps through the composed objective, and the fused "
          f"objective on the same logits ({card})")
    return counts


def cem_phase(dev, card):
    """``solve_cem`` on the card at [sqp]'s problem and horizon, CEM_POP
    samples an iteration over CEM_ITERS iterations from a card generator,
    the counters reset just before: kernel [2] launched once an iteration
    (each iteration's exact scoring), the best cost equal to the exact cost
    of the best controls recomputed, by [2] and by its plain twin, and to
    the least of the history, no toggle outside the control mask.  Returns
    the solve's seconds."""
    from lifeapi_tpu_torch.mpc import solver
    from lifeapi_tpu_torch.ops import step_cuda

    problem = sqp_problem(dev, SQP_HORIZON)
    gen = torch.Generator(device=dev).manual_seed(0)
    reset_counters()
    t0 = time.perf_counter()
    mean, best_cost, best, history = solver.solve_cem(problem, gen, pop=CEM_POP, iters=CEM_ITERS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counters("cem", ("controlled_rollout",))
    check(counts == {"controlled_rollout": CEM_ITERS},
          f"[cem] launches {counts}, not [2] once in each of {CEM_ITERS} iterations")
    check(all(t.device.type == dev.type for t in (mean, best_cost, best, history)),
          "[cem] a result off the card")
    check(tuple(history.shape) == (CEM_ITERS,) and bool(torch.isfinite(history).all()),
          f"[cem] history {tuple(history.shape)} not {CEM_ITERS} finite costs")
    outside = int((best & ~problem.control_mask).sum())
    check(outside == 0, f"[cem] {outside} toggles outside the control mask")
    cost, _ = solver.hard_score(best.to(torch.float32), problem)
    toggles = solver.candidate_toggles(best[None].to(torch.float32), problem)
    starts = problem.initial.expand(1, 64).contiguous()
    plain = solver.hard_cost(step_cuda.controlled_rollout_plain(starts, toggles), toggles, problem)
    check(float(best_cost) == float(cost) == float(plain[0]),
          f"[cem] best cost {float(best_cost)}, recomputed {float(cost)} by [2] and "
          f"{float(plain[0])} by its twin")
    check(float(best_cost) == float(history.min()),
          f"[cem] best cost {float(best_cost)} is not the least of the history "
          f"{float(history.min())}")
    print(f"[cem] solve_cem on config 3 (horizon {SQP_HORIZON}, pop {CEM_POP}, {CEM_ITERS} "
          f"iterations, card generator): {seconds:.3f} s; best cost {float(best_cost)} (= its "
          f"controls' exact cost by [2] and by the twin, = the history's least), history "
          f"{float(history[0]):.2f} -> {float(history[-1]):.2f}, {int(best.sum())} toggles, none "
          f"outside the mask ({card})")
    return seconds


def receding_phase(dev, card):
    """The receding example through ``run`` and ``run_fused``, then
    ``run_fused`` at horizon 32 under sync-debug mode "error"."""
    from lifeapi_tpu_torch.examples import life_step_dense, receding_mpc
    from lifeapi_tpu_torch.mpc import receding
    from lifeapi_tpu_torch.core import board as B

    reset_counters()
    t0 = time.perf_counter()
    host = receding_mpc.run(dev)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = receding_mpc.run(dev, fused=True)
    t_fused = time.perf_counter() - t0
    p32 = receding_mpc.problem(dev, horizon=RECEDING_H32)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        long = receding.run_fused(p32, gen, steps=8, apply_horizon=2, n_candidates=16,
                                  solve_iters=80)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t_queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_long = time.perf_counter() - t0
    read_counters("receding", ("controlled_rollout",))

    check(host["hamming"] == 0, f"receding run: final Hamming {host['hamming']}")
    check(host["exact_dynamics"] and fused["exact_dynamics"],
          "receding example: a trajectory leaves the exact dynamics")
    boards = B.to_dense(long.boards).cpu().numpy()
    applied = B.to_dense(long.applied).cpu().numpy()
    check(long.boards.shape == (9, 64) and long.costs.shape == (4,),
          "run_fused at horizon 32: wrong shapes")
    check(all((life_step_dense(boards[i] ^ applied[i]) == boards[i + 1]).all()
              for i in range(8)), "run_fused at horizon 32 leaves the exact dynamics")
    print(f"[receding] card: {card}")
    print(f"[receding] example (horizon 4, 8 steps, replan every 2, 8 candidates, 80 "
          f"iterations): run {t_host:.3f} s, final Hamming {host['hamming']}, costs "
          f"{host['run'].costs.tolist()}; run_fused {t_fused:.3f} s, final Hamming "
          f"{fused['hamming']}; both follow the numpy step")
    print(f"[receding] run_fused at horizon {RECEDING_H32} (8 steps, replan every 2, 16 "
          f"candidates, 80 iterations), no host sync in its loop: {t_long:.3f} s, "
          f"{t_long / 4:.3f} s a replan round ({t_queued:.3f} s to queue it), final "
          f"Hamming {int(receding.final_error(long, p32.target))}, costs "
          f"{long.costs.tolist()}")
    return t_long / 4


def symmetric_phase(dev, card):
    """JAX's C2 problem, then D4even at horizon 32 with a stable region;
    kernel B's consistency flags against ``bitplane.propagate`` on every
    final board, and ``stable_consistency`` as one launch of B."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import rle
    from lifeapi_tpu_torch.mpc import CostWeights, MPCProblem, solver, symmetric
    from lifeapi_tpu_torch.ops import stable_cuda
    from lifeapi_tpu_torch.symmetry import groups, transforms
    from lifeapi_tpu_torch.target import LifeTarget, hamming_cost

    def orbit(board, sym):
        out = board
        for t in groups.GROUPS[sym]:
            out = out | transforms.transform(board, t)
        return out

    def orbit_problem(sym, horizon, lo, hi, initial):
        """Blocks on the orbit of one at (20, 20) from the orbit of
        ``initial``, toggles allowed on the orbit of [lo, hi)^2."""
        blk = B.move(rle.parse("2o$2o!", device=dev), 20, 20)
        box = torch.zeros((64, 64), device=dev)
        box[lo:hi, lo:hi] = 1.0
        return MPCProblem(initial=orbit(initial, sym),
                          target=LifeTarget.from_state(orbit(blk, sym)), horizon=horizon,
                          control_mask=symmetric.orbit_symmetrize(box, sym) > 0,
                          weights=CostWeights(target=1.0, control=0.01))

    def symmetric_toggles(sol, sym):
        on = sol.control_probs > 0.5
        return all(torch.equal(transforms.transform_dense(on, t), on)
                   for t in groups.GROUPS[sym])

    c2, d4 = groups.StaticSymmetry.C2even, groups.StaticSymmetry.D4even
    p_c2 = orbit_problem(c2, 3, 18, 24, B.empty(device=dev))
    # four blinkers: the solves end on boards of every kind, most of them
    # no still life in the region
    p_d4 = orbit_problem(d4, SYM_HORIZON, 17, 25,
                         B.move(rle.parse("3o!", device=dev), 19, 20))
    region = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    region[16:48, 16:48] = True
    # the JAX test's own draw (jax.random.key(0)) on the mask's cells, the
    # only ones that reach the objective or the toggles; from a draw at
    # seed 0 of the port's generator no candidate reaches the target, in
    # either package (tests/test_torch_symmetric_mpc.py)
    c2_draw = torch.full((8, 3, 64, 64), -3.0, device=dev)
    c2_draw[:, :, p_c2.control_mask] = torch.from_numpy(np.load(C2_DRAW)).to(dev)
    reset_counters()
    t0 = time.perf_counter()
    with replaced(solver, "init_logits", lambda *args, **kwargs: c2_draw):
        sol_c2 = symmetric.solve_symmetric(p_c2, torch.Generator(), c2, n_candidates=8,
                                           iters=120)
    torch.cuda.synchronize()
    t_c2 = time.perf_counter() - t0
    with spying(symmetric, "stable_consistency") as consistency:
        t0 = time.perf_counter()
        sol_d4 = symmetric.solve_symmetric(p_d4, torch.Generator().manual_seed(0), d4,
                                           n_candidates=16, iters=120, stable_region=region)
        torch.cuda.synchronize()
        t_d4 = time.perf_counter() - t0
    read_counters("symmetric", ("controlled_rollout", "propagate_fused"))

    ham_c2 = int(hamming_cost(sol_c2.final_board, p_c2.target))
    check(ham_c2 == 0, f"C2 symmetric solve: Hamming {ham_c2}")
    check(symmetric_toggles(sol_c2, c2), "C2 symmetric solve: toggles not C2even-symmetric")
    check(symmetric_toggles(sol_d4, d4), "D4 symmetric solve: toggles not D4even-symmetric")
    finals = consistency[0].args[0]
    flags = consistency[0].out
    plain = symmetric.stable_consistency_plain(finals, region)
    check(torch.equal(flags, plain), "stable_consistency: kernel B != bitplane.propagate")
    check(bool((sol_d4.all_costs[~flags] >= 1e4).all()),
          "D4 symmetric solve: an inconsistent candidate was not penalized")

    # one launch of kernel B, with no host sync; the known answers
    stable_cuda.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = symmetric.stable_consistency(finals, region)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launched = {k: v for k, v in stable_cuda.LAUNCHES.items() if v}
    check(launched == {"propagate_fused": 1},
          f"stable_consistency is not one launch of kernel B: {launched}")
    check(torch.equal(again, flags), "stable_consistency is not reproducible")
    known = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    known[28:34, 28:34] = True
    blk = B.move(rle.parse("2o$2o!", device=dev), 30, 30)
    lone = B.from_cells([(30, 30)], device=dev)
    answers = symmetric.stable_consistency(torch.stack([blk, lone]), known).tolist()
    check(answers == [True, False], f"stable_consistency known answers: {answers}")

    print(f"[symmetric] card: {card}")
    print(f"[symmetric] C2even (horizon 3, 8 candidates, 120 iterations, from the JAX "
          f"test's draw): Hamming {ham_c2}, "
          f"{int((sol_c2.all_costs < 1).sum())}/8 candidates at Hamming 0, toggles "
          f"symmetric; {t_c2:.3f} s")
    print(f"[symmetric] D4even (four blinkers to four blocks, horizon {SYM_HORIZON}, 16 "
          f"candidates, 120 iterations, stable region [16, 48)^2): best cost "
          f"{float(sol_d4.cost)}, Hamming {int(hamming_cost(sol_d4.final_board, p_d4.target))}, "
          f"{len(set(map(tuple, finals.tolist())))} distinct final boards, "
          f"{int(flags.sum())}/16 consistent (kernel B == bitplane.propagate), toggles "
          f"symmetric; "
          f"{t_d4:.3f} s; stable_consistency is one launch of B; block consistent, lone "
          f"cell not")
    return t_d4


def reach_phase(dev, card):
    """The reachability prefilter: the eater fixture's known answer, then a
    glider at each of the 4096 offsets over two propagated eater
    backgrounds, 32 steps: the fixture's (one hidden cell, which
    propagation determines) and the eater with its 2-ring unknown (40 cells
    stay unknown).  The card against the CPU on 256 candidates and the
    bounds against kernel [1]'s exact rollout of the completed boards."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import rle
    from lifeapi_tpu_torch.mpc import reachability as RC
    from lifeapi_tpu_torch.ops import step_cuda
    from lifeapi_tpu_torch.stable import bitplane as BP
    from lifeapi_tpu_torch.target import LifeTarget, hamming_cost

    eater = B.move(rle.parse(EATER_RLE, device=dev), 20, 20)
    target = LifeTarget.from_state(eater)

    def background(known, unknown):
        res = BP.propagate(BP.make(state=known[None], unknown=unknown[None]))
        check(bool(res.consistent[0]), "reach: an eater background is inconsistent")
        return BP.BitStable(res.stable.state[0], res.stable.unknown[0],
                            tuple(r[0] for r in res.stable.ruled))

    hidden = B.from_cells([(22, 20)], device=dev)
    backgrounds = {"one hidden cell": background(eater & ~hidden, hidden),
                   "2-ring unknown": background(*eater_problem(dev, hide_cells=(), ring2=True))}
    glider = rle.parse("bob$2bo$3o!", device=dev)
    shift = torch.arange(REACH_C, device=dev)
    gliders = B.move_dyn(glider, shift % 64, shift // 64)

    reset_counters()
    t0 = time.perf_counter()
    fixture = backgrounds["one hidden cell"]
    smash = fixture.state | B.from_cells([(20, 21), (20, 22), (21, 21), (21, 22)], device=dev)
    keep_f, _, upper_f = RC.prune_candidates(torch.stack([fixture.state, smash]), fixture,
                                             target, steps=4, max_cost=0)
    runs = {}
    for name, stable in backgrounds.items():
        initials = stable.state | gliders
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bounds = RC.prune_candidates(initials, stable, target, steps=REACH_T, max_cost=0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        # the completed boards (the eater plus the glider), exactly, by kernel [1]
        glider_cells = initials & ~stable.state
        exact = hamming_cost(step_cuda.rollout(eater | glider_cells, REACH_T), target)
        runs[name] = (stable, initials, bounds, seconds, exact,
                      B.is_empty(glider_cells & stable.unknown))
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    read_counters("reach", ("rollout",))

    check(keep_f.tolist() == [True, False] and int(upper_f[0]) == 0,
          f"reach fixture: keep {keep_f.tolist()}, upper {upper_f.tolist()}")
    print(f"[reach] card: {card}")
    print("[reach] eater fixture: quiet candidate kept with upper 0, smashed one pruned")
    sub = slice(0, REACH_C, REACH_C // REACH_CPU)  # spread over the offsets
    cpu_target = LifeTarget(target.wanted.cpu(), target.unwanted.cpu())
    for name, (stable, initials, (keep, lower, upper), seconds, exact, clear) in runs.items():
        n_unknown = int(B.population(stable.unknown))
        check(bool((lower <= upper).all()), f"reach, {name}: a lower bound above its upper")
        check(bool(((lower <= exact) & (exact <= upper))[clear].all()),
              f"reach, {name}: an exact Hamming outside its bounds")
        cpu_stable = BP.BitStable(stable.state.cpu(), stable.unknown.cpu(),
                                  tuple(r.cpu() for r in stable.ruled))
        want = RC.prune_candidates(initials[sub].cpu(), cpu_stable, cpu_target,
                                   steps=REACH_T, max_cost=0)
        for g, w in zip((keep, lower, upper), want):
            check(torch.equal(g[sub].cpu(), w), f"reach, {name}: card != CPU")
        planes = RC.refined_rollout(initials[sub], stable.unknown.expand(REACH_CPU, 64),
                                    stable, REACH_T)
        cpu_planes = RC.refined_rollout(initials[sub].cpu(),
                                        cpu_stable.unknown.expand(REACH_CPU, 64),
                                        cpu_stable, REACH_T)
        for g, w in zip(planes, cpu_planes):
            check(torch.equal(g.cpu(), w), f"reach, {name}: refined_rollout card != CPU")
        print(f"[reach] {REACH_C} gliders over the eater with its {name} ({n_unknown} "
              f"cells unknown after propagation), {REACH_T} steps, max cost 0: "
              f"{int((~keep).sum())} pruned, {int(keep.sum())} kept; lower "
              f"{int(lower.min())}-{int(lower.max())}, upper {int(upper.min())}-"
              f"{int(upper.max())}; card == CPU on {REACH_CPU} (bounds and planes); lower "
              f"<= exact <= upper on the {int(clear.sum())} candidates whose glider misses "
              f"the unknown cells ({REACH_C - int(clear.sum())} skipped), exact by kernel "
              f"[1]; prune_candidates {seconds:.4f} s, {REACH_C / seconds:.4g} candidates/s, "
              f"{int((~keep).sum()) / seconds:.4g} pruned/s")
    ring = backgrounds["2-ring unknown"]
    print_share("reach", f"one prune of {REACH_C} candidates, {REACH_T} steps",
                device_share(lambda: RC.prune_candidates(ring.state | gliders, ring, target,
                                                          steps=REACH_T, max_cost=0), n=2))
    print(f"[reach] phase {t_all:.3f} s")
    return REACH_C / runs["2-ring unknown"][3]


# ---------------------------------------------------------------------------
# The still-life solver's path
# ---------------------------------------------------------------------------


def stable_phase(dev):
    """Drive the solver's path with its counters set to 0 just before,
    then check every solver kernel against its twin and the known answers.
    Returns (launches, errors, the inputs the timings reuse)."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.ops import stable_cuda as SC
    from lifeapi_tpu_torch.stable import bitplane as BP
    from lifeapi_tpu_torch.stable import complete as C

    known, unknown = eater_problem(dev)
    beam_bst = BP.make(state=known.expand(BEAM_B, 64), unknown=unknown.expand(BEAM_B, 64))
    # the queue: the bench problem at every torus offset in turn
    n_queued = QUEUED_CHUNKS * BEAM_B
    shift = torch.arange(n_queued, device=dev)
    q_known = B.move_dyn(known, shift % 64, (shift // 64) % 64)
    q_unknown = B.move_dyn(unknown, shift % 64, (shift // 64) % 64)
    queue_bst = BP.make(state=q_known, unknown=q_unknown)
    fix_known, fix_unknown = eater_problem(dev, hide_cells=(), ring2=True)
    fix_bst = BP.make(state=fix_known.expand(FIX_B, 64), unknown=fix_unknown.expand(FIX_B, 64))

    torch.cuda.synchronize()
    SC.reset_launches()
    t0 = time.perf_counter()
    beam = C.complete_stable_beam(beam_bst, frontier=BEAM_F, iters=BEAM_ITERS,
                                  minimise=True, dense=False)
    queued = C.complete_stable_beam_queued(queue_bst, chunk=BEAM_B, frontier=BEAM_F,
                                           iters=BEAM_ITERS)
    fix = SC.propagate_fused_inkernel(fix_bst)
    fix_loop = SC.propagate_fused(fix_bst)
    fix_prio, levels = SC.propagate_fused_beam(fix_bst)
    prio_planes = SC.propagate_fixpoint_priorities(BP.to_planes(fix_bst).contiguous())
    one_step = SC.propagate_step(BP.to_planes(fix_bst).contiguous())
    torch.cuda.synchronize()
    launches = dict(SC.LAUNCHES)
    print(f"[stable] solver path ran in {time.perf_counter() - t0:.2f} s; launches {launches}")
    check(all(launches[name] > 0 for name in STABLE_REPLACES),
          f"a solver kernel was never launched: {launches}")
    err = dict.fromkeys(STABLE_REPLACES, 0.0)

    # known answers of the path
    check(bool(beam.found.all()) and bool((beam.best_pop == 7).all()),
          "bench beam: not every problem found the pop-7 eater")
    check(not beam.proved_inconsistent.any(), "bench beam: a problem proved inconsistent")
    check_still_lifes(beam, known, unknown, "bench beam")
    check(bool(queued.found.all()) and bool((queued.best_pop == 7).all()),
          "queued beam: not every problem found a pop-7 completion")
    beam_kw = dict(frontier=BEAM_F, iters=BEAM_ITERS, minimise=True)
    for k in (0, QUEUED_CHUNKS // 2, QUEUED_CHUNKS - 1):
        part = slice(k * BEAM_B, (k + 1) * BEAM_B)
        chunk = BP.BitStable(queue_bst.state[part], queue_bst.unknown[part],
                             tuple(r[part] for r in queue_bst.ruled))
        ref = C.complete_stable_beam(chunk, frontier=BEAM_F, iters=BEAM_ITERS,
                                     return_boards=False)
        _, p_pop, p_found, p_complete, p_exhausted = SC.beam_search_plain(
            BP.to_planes(chunk).contiguous(), **beam_kw)
        plain = dict(found=p_found, best_pop=p_pop,
                     proved_inconsistent=p_exhausted & p_complete & ~p_found)
        for key in ("found", "best_pop", "proved_inconsistent"):
            got = getattr(queued, key)[part]
            check(torch.equal(got, getattr(ref, key)),
                  f"queued beam {key} != the per-chunk call on chunk {k}")
            err["beam_search"] = max(err["beam_search"], max_err(got, plain[key]))
            check(torch.equal(got, plain[key]),
                  f"queued beam {key} != the plain twin on chunk {k}")
    check(bool(fix.consistent.all()), "fixpoint: a bench board came back inconsistent")
    unk_before = int(B.population(fix_unknown))
    unk_after = B.population(fix.stable.unknown)
    check(unk_before == 49 and bool((unk_after == 40).all()),
          f"fixpoint: unknowns {unk_before} -> {unk_after.unique().tolist()}, not 49 -> 40")
    for other in (fix_loop, fix_prio):
        check(torch.equal(BP.to_planes(other.stable), BP.to_planes(fix.stable))
              and torch.equal(other.consistent, fix.consistent),
              "the three fixpoint entries disagree")
    check(torch.equal(prio_planes[0], BP.to_planes(fix_prio.stable))
          and torch.equal(prio_planes[3], torch.stack(levels, dim=-2)),
          "propagate_fixpoint_priorities != propagate_fused_beam")
    check(bool((~B.is_empty(one_step[1])).all()) and bool(B.is_empty(one_step[2]).all()),
          "one propagation step of the fixpoint boards changed nothing or aborted")
    # [6], [7] and [9] on a BitStable are one launch of B or C each, with no
    # readback and no other kernel
    for name in ENTRY_COUNTERS:
        check_one_launch(name, fix_bst)
    print(f"[stable] bench beam B={BEAM_B} F={BEAM_F} iters={BEAM_ITERS}: found "
          f"{int(beam.found.sum())}/{BEAM_B}, best_pop {beam.best_pop.unique().tolist()}, "
          f"every board a still life; queued {n_queued}: found {int(queued.found.sum())}, "
          f"== per-chunk calls on 3 chunks; fixpoint B={FIX_B}: unknowns "
          f"{unk_before} -> {unk_after.unique().tolist()}, consistent, the four entries "
          f"equal; propagate_fused, propagate_fused_inkernel and propagate_fused_beam "
          f"one launch of kernel B or C each, no readback, no other kernel in a trace")

    # every kernel against its twin, first at the shapes of the path; the
    # three BitStable entries against their plain versions on separate
    # planes (board stride 64) and on views of the stacked planes (640)
    fix_planes = BP.to_planes(fix_bst).contiguous()
    for name in ENTRY_COUNTERS:
        for bst in (fix_bst, BP.from_planes(fix_planes)):
            entry_vs_plain(name, bst, {}, err)
    for name in ("propagate_step", "propagate_fixpoint", "propagate_fixpoint_priorities"):
        kernel_vs_plain(name, (fix_planes,), {}, err)
    bench_planes = BP.to_planes(beam_bst).contiguous()
    kernel_vs_plain("beam_search", (bench_planes,), beam_kw, err)
    rand = planes_of(*block_instances(1024, 0, 5, 4, 56, 0.3, ring2=True), dev)
    _, _, abort = kernel_vs_plain("propagate_step", (rand,), {}, err)
    _, consistent, _, _ = kernel_vs_plain("propagate_fixpoint_priorities", (rand,), {}, err)
    # kernels B and C through the planes API and the three BitStable entries
    # against their plain versions ([6]'s the host loop over A's twin),
    # inconsistent boards included, at two step caps and the default
    for cap in ({"max_iters": 1}, {"max_iters": 2}, {"max_iters": SC.MAX_ITERS}):
        kernel_vs_plain("propagate_fixpoint", (rand,), cap, err)
        kernel_vs_plain("propagate_fixpoint_priorities", (rand,), cap, err)
        for name in ENTRY_COUNTERS:
            entry_vs_plain(name, BP.from_planes(rand), cap, err)
    n_abort = int((~B.is_empty(abort)).sum())
    n_incons = int((~consistent).sum())
    check(n_abort > 0 and n_incons > 0, "the random instances gave no inconsistent board")
    beam_rand = planes_of(*block_instances(1024, 2, 3, 8, 52, 0.35, ring2=False), dev)
    for minimise in (True, False):
        kernel_vs_plain("beam_search", (beam_rand,),
                        dict(frontier=8, iters=12, minimise=minimise), err)
    s_known, s_unknown = eater_problem(dev, hide_cells=((20, 20), (21, 20), (22, 21)),
                                       ring2=True)
    seeded = BP.to_planes(BP.make(state=s_known.expand(64, 64),
                                  unknown=s_unknown.expand(64, 64))).contiguous()
    kernel_vs_plain("beam_search", (seeded,),
                    dict(beam_kw, seed=s_known.expand(64, 64).contiguous()), err)
    bounded = bench_planes[:64]
    for bound in (7, 8):
        b = torch.full((bounded.shape[0],), bound, dtype=torch.int32, device=dev)
        _, best_pop, found, _, _ = kernel_vs_plain(
            "beam_search", (bounded,), dict(beam_kw, bound=b), err)
        check(bool(found.all()) is (bound == 8) and bool(found.any()) is (bound == 8)
              and bool((best_pop == 7).all()), f"init_bound {bound}: wrong answer")
    lone = BP.make(state=B.from_cells([(40, 40)], batch=(2,), device=dev))
    lone_res = C.complete_stable_beam(lone, frontier=8, iters=16, minimise=False)
    check(bool(lone_res.proved_inconsistent.all()), "a lone ON cell was not proved inconsistent")
    kernel_vs_plain("beam_search", (BP.to_planes(lone).contiguous(),),
                    dict(frontier=8, iters=16, minimise=False), err)
    # slots whose fixpoints differ by up to 12 steps in a round, most problems
    # dropping ok children (complete false) at F=2, at every frontier
    uneven = planes_of(*block_instances(256, 11, 8, 4, 56, 0.5, ring2=True), dev)
    for frontier, iters in ((2, 8), (4, 12), (8, 12), (16, 6)):
        _, _, _, complete, _ = kernel_vs_plain(
            "beam_search", (uneven,), dict(frontier=frontier, iters=iters, minimise=True), err)
        if frontier == 2:
            n_dropped = int((~complete).sum())
    check(n_dropped > 0, "F=2 on the uneven set dropped no child")
    print(f"[stable] kernels == plain twins: step, fixpoint and priorities on the "
          f"{FIX_B} fixpoint boards and on 1024 random instances ({n_abort} abort "
          f"their first step, {n_incons} inconsistent); B and C through the planes API "
          f"and [6], [7], [9] through their BitStable entries (separate planes and views) "
          f"on both, on the random ones at caps 1, 2 and {SC.MAX_ITERS}; beam on all {BEAM_B} "
          f"bench "
          f"problems, the queued results on 3 chunks of {BEAM_B}, 1024 random "
          f"instances at F=8 (both minimise values), seeded and bounded (7: nothing "
          f"found, 8: pop 7) at B=64, the lone cell (proved inconsistent), 256 uneven "
          f"instances at F=2, 4, 8, 16 (F=2: {n_dropped} drop an ok child)")
    print(f"[counters] {launches}")
    return launches, err, (beam_bst, queue_bst, fix_bst)


def stable_timings(inputs, ms, plain_ms, dev_ms, card):
    """Kernel against twin at the bench shapes, in turns, the device times,
    and the solver's end-to-end rates."""
    from lifeapi_tpu_torch.ops import stable_cuda as SC
    from lifeapi_tpu_torch.stable import bitplane as BP
    from lifeapi_tpu_torch.stable import complete as C

    beam_bst, queue_bst, fix_bst = inputs
    fix_planes = BP.to_planes(fix_bst).contiguous()
    beam_planes = BP.to_planes(beam_bst).contiguous()
    for name, reps in (("propagate_step", 10), ("propagate_fixpoint", 5),
                       ("propagate_fixpoint_priorities", 5)):
        ms[name], plain_ms[name] = paired_ms(
            lambda: getattr(SC, name)(fix_planes),
            lambda: getattr(SC, f"{name}_plain")(fix_planes), reps=reps)
    for name in ENTRY_COUNTERS:
        ms[name], plain_ms[name] = paired_ms(
            lambda: getattr(SC, name)(fix_bst),
            lambda: getattr(SC, f"{name}_plain")(fix_bst), reps=5)
    kw = dict(frontier=BEAM_F, iters=BEAM_ITERS, minimise=True)
    ms["beam_search"], plain_ms["beam_search"] = paired_ms(
        lambda: SC.beam_search(beam_planes, **kw),
        lambda: SC.beam_search_plain(beam_planes, **kw), reps=2)
    # the BitStable entries: every kernel of the call, so that a stack or
    # copy that comes back is timed too
    dev_ms.update({
        "propagate_step": device_ms_at(lambda: SC.propagate_step(fix_planes), "step_kernel",
                                       "propagate_step"),
        "propagate_fused": device_ms_at(lambda: SC.propagate_fused(fix_bst), "fixpoint_kernel",
                                        "propagate_fused", whole_call=True),
        "propagate_fixpoint": device_ms_at(lambda: SC.propagate_fixpoint(fix_planes),
                                           "fixpoint_kernel", "propagate_fixpoint"),
        "propagate_fused_inkernel": device_ms_at(
            lambda: SC.propagate_fused_inkernel(fix_bst), "fixpoint_kernel",
            "propagate_fixpoint", whole_call=True),
        "propagate_fixpoint_priorities": device_ms_at(
            lambda: SC.propagate_fixpoint_priorities(fix_planes), "fixpoint_kernel",
            "propagate_fixpoint_priorities"),
        "propagate_fused_beam": device_ms_at(lambda: SC.propagate_fused_beam(fix_bst),
                                             "fixpoint_kernel", "propagate_fused_beam",
                                             whole_call=True),
        "beam_search": device_ms_at(lambda: SC.beam_search(beam_planes, **kw), "beam_kernel",
                                    "beam_search"),
    })
    fused_ms, inkernel_ms = paired_ms(lambda: SC.propagate_fused(fix_bst),
                                      lambda: SC.propagate_fused_inkernel(fix_bst), reps=10)
    print(f"[time] card: {card}")
    for name, shape in (("propagate_step", f"B={FIX_B}"),
                        ("propagate_fused", f"B={FIX_B}, the whole call"),
                        ("propagate_fixpoint", f"B={FIX_B}"),
                        ("propagate_fused_inkernel", f"B={FIX_B}, the whole call ([7]'s entry)"),
                        ("propagate_fixpoint_priorities", f"B={FIX_B}"),
                        ("propagate_fused_beam", f"B={FIX_B}, the whole call"),
                        ("beam_search", f"B={BEAM_B} F={BEAM_F} iters={BEAM_ITERS}")):
        d, mhz = dev_ms[name]
        print(f"[time] {name} {shape}: kernel {ms[name]:.4f} ms a call "
              f"({d:.4f} ms of it on the device, profiler, SM clock {mhz} MHz), "
              f"plain {plain_ms[name]:.4f} ms{before_redesign(name, d)}")
    print(f"[time] propagate_fused against propagate_fused_inkernel, B={FIX_B}, medians "
          f"of 10 calls each in turns: {fused_ms:.4f} ms and {inkernel_ms:.4f} ms "
          f"({fused_ms / inkernel_ms:.3g}x)")
    # [5]-[9] again with each call's inputs and outputs one of copies that
    # together pass the L2 (one call moves 42-50 MB, under its 50 MB)
    for name, x in (("propagate_step", fix_planes), ("propagate_fused", fix_bst),
                    ("propagate_fixpoint", fix_planes),
                    ("propagate_fixpoint_priorities", fix_planes),
                    ("propagate_fused_beam", fix_bst)):
        nbytes = step_bytes() if name == "propagate_step" else fixpoint_bytes(name)
        copies = [(x.clone() if isinstance(x, torch.Tensor) else
                   BP.BitStable(x.state.clone(), x.unknown.clone(),
                                tuple(r.clone() for r in x.ruled)),)
                  for _ in range(rotation_copies(nbytes))]
        rotated = profiled_device_ms(
            rotating_call(getattr(SC, name), copies),
            "step_kernel" if name == "propagate_step" else "fixpoint_kernel", name,
            whole_call=name in ENTRY_COUNTERS)
        first = dev_ms[name][0]
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[time] {name} B={FIX_B}: {first:.4f} ms on the device on one input "
              f"({first / by_bytes:.3g}x its bytes bound, {by_bytes:.4f} ms), {rotated:.4f} ms "
              f"({rotated / by_bytes:.3g}x) with inputs and outputs rotated over "
              f"{len(copies)} copies ({len(copies) * nbytes / 1e6:.0f} MB)")

    beam_call = lambda: C.complete_stable_beam(beam_bst, frontier=BEAM_F, iters=BEAM_ITERS,
                                               dense=False)
    beam_s = wall(beam_call, 5)
    busy = (profiled_device_ms(beam_call, "beam_kernel", "beam_search", n=20, whole_call=True)
            / (wall(beam_call, 5) * 1e3))
    queued_s = wall(lambda: C.complete_stable_beam_queued(
        queue_bst, chunk=BEAM_B, frontier=BEAM_F, iters=BEAM_ITERS), 3)
    n_queued = queue_bst.state.shape[0]
    chunks = [BP.BitStable(queue_bst.state[lo:lo + BEAM_B], queue_bst.unknown[lo:lo + BEAM_B],
                           tuple(r[lo:lo + BEAM_B] for r in queue_bst.ruled))
              for lo in range(0, n_queued, BEAM_B)]
    chunked_s = wall(lambda: [C.complete_stable_beam(c, frontier=BEAM_F, iters=BEAM_ITERS,
                                                     return_boards=False)
                              for c in chunks], 3)
    fix_s = wall(lambda: SC.propagate_fused_inkernel(fix_bst), 10)
    print(f"[time] complete_stable_beam end to end, {BEAM_B} problems: median "
          f"{beam_s * 1e3:.3f} ms ({BEAM_B / beam_s:.6g} solves/s) over 5; the device "
          f"is busy {busy:.1%} of a call (profiler)")
    print(f"[time] complete_stable_beam_queued end to end, {n_queued} problems: median "
          f"{queued_s * 1e3:.3f} ms ({n_queued / queued_s:.6g} solves/s) over 3; "
          f"{len(chunks)} complete_stable_beam calls of {BEAM_B} on the same problems: "
          f"median {chunked_s * 1e3:.3f} ms ({n_queued / chunked_s:.6g} solves/s) over 3")
    print(f"[time] propagate_fused_inkernel end to end, {FIX_B} boards: median "
          f"{fix_s * 1e3:.4f} ms ({FIX_B / fix_s:.6g} fixpoints/s) over 10")


# ---------------------------------------------------------------------------
# The convolution layer's path
# ---------------------------------------------------------------------------


class ConvInputs:
    """The [conv] phase's inputs on the card, from numpy seeds, at the JAX
    package's bench shapes."""

    def __init__(self, dev):
        from lifeapi_tpu_torch.core import board as B

        rng = np.random.default_rng(0)

        def on_card(dense):
            return torch.from_numpy(dense).to(dev)

        def sparse(n, k):  # k random cells in [20, 28)^2 per board
            d = np.zeros((n, 64, 64), bool)
            for i in range(n):
                d[i, rng.integers(20, 28, k), rng.integers(20, 28, k)] = True
            return B.from_dense(on_card(d))

        def distinct(n, lo, hi):  # lo..hi-1 distinct random cells per board
            d = np.zeros((n, 64 * 64), bool)
            for i in range(n):
                d[i, rng.choice(4096, int(rng.integers(lo, hi)), replace=False)] = True
            return d.reshape(n, 64, 64)

        self.io_a, self.io_b = sparse(IO_B, 7), sparse(IO_B, 7)
        self.tr_a, self.tr_b = sparse(CONV_B, 7), sparse(CONV_B, 7)
        self.p01 = B.from_dense(on_card(rng.random((CONV_B, 64, 64)) < 0.1))
        self.pattern7 = B.from_cells([tuple(map(int, c)) for c in rng.integers(20, 28, (7, 2))],
                                     device=dev)
        self.dense_a = on_card(rng.random((CONV_B, 64, 64)) < 0.5)
        self.dense_b = on_card(rng.random((CONV_B, 64, 64)) < 0.5)
        self.a, self.b = B.from_dense(self.dense_a), B.from_dense(self.dense_b)
        self.pattern100 = B.from_dense(on_card(distinct(1, 100, 101)[0]))
        self.mid_b = B.from_dense(on_card(distinct(CONV_B, 49, 193)))
        self.orbit_boards = on_card(rng.integers(-2**63, 2**63, (CONV_B, 64), dtype=np.int64))
        self.calib = [on_card(rng.integers(-2**63, 2**63, (CALIB_ROWS, 64), dtype=np.int64))
                      for _ in range(2)]


def orbit_sweep(boards):
    """All 16 transforms of every board and their fingerprints, folded into
    one key per board (bench.py:571-618)."""
    from lifeapi_tpu_torch.symmetry import orbits
    from lifeapi_tpu_torch.symmetry.transforms import ALL_TRANSFORMS, transform

    h = torch.zeros(boards.shape[:-1], dtype=torch.int64, device=boards.device)
    for t in ALL_TRANSFORMS:
        fa, fb = orbits.fingerprint(transform(boards, t))
        h = h ^ fa ^ fb
    return h


def conv_vs_plain(module, name, args, kwargs, err):
    """Run a conv or calibration kernel and its twin on the same card
    inputs; fail unless they agree exactly.  Returns the kernel's output."""
    got = getattr(module, name)(*args, **kwargs)
    want = getattr(module, f"{name}_plain")(*args, **kwargs)
    torch.cuda.synchronize()
    if name == "calibrate":
        got = got[0]
    for g, w in zip(*(x if isinstance(x, list) else [x] for x in (got, want))):
        err[name] = max(err[name], max_err(g, w))
        check(g.dtype == w.dtype and torch.equal(g, w), f"{name} kernel != plain twin")
    return got


def conv_phase(dev):
    """Drive the convolution layer's path with its counters set to 0 just
    before: catalyst search over the pruned offsets and every orientation,
    interaction offsets, the convolve/counts/match routes, the orbit sweep
    and the calibration.  Then check the known answers, the routes against
    one another and every kernel against its twin.  Returns (launches,
    errors, inputs)."""
    from lifeapi_tpu_torch import search
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import convolve as CV
    from lifeapi_tpu_torch.ops import calibrate_cuda as CAL
    from lifeapi_tpu_torch.ops import conv_cuda as CC
    from lifeapi_tpu_torch.ops import step_cuda

    x = ConvInputs(dev)
    glider, eater = B.from_cells(GLIDER, device=dev), B.from_cells(EATER, device=dev)
    torch.cuda.synchronize()
    CC.reset_launches()
    CAL.reset_launches()
    step_cuda.reset_launches()
    t0 = time.perf_counter()
    offsets = search.candidate_offsets(glider, eater)
    pruned = search.catalyst_search(glider, eater, offsets, 64)
    oriented = search.catalyst_search_all_orientations(glider, eater, offsets, 64)
    io_sparse = CV.interaction_offsets(x.io_a, x.io_b, method="sparse")
    io_dense = CV.interaction_offsets(x.io_a, x.io_b, method="ntt_fused")
    io_pair = CV.interaction_offsets(glider, eater, method="sparse")
    conv_traced = CV.convolve(x.tr_a, x.tr_b, method="sparse")
    conv_host = CV.convolve(x.p01, x.pattern7)
    counts_sparse = CV.convolve_counts(x.a, x.tr_b, method="sparse")
    counts_auto = CV.convolve_counts(x.a, x.tr_b)
    counts_dense = CV.convolve_counts(x.a, x.b, method="ntt_fused")
    corr = CV.correlate_counts(x.a, x.pattern100)
    matched = CV.match_live(x.a, x.pattern100)
    small_conv = CV.convolve(x.a, x.mid_b)
    orbit_keys = orbit_sweep(x.orbit_boards)
    calib = {mix: CAL.calibrate(*x.calib, CALIB_ITERS, mix)[0] for mix in CAL.MIXES}
    torch.cuda.synchronize()
    launches = {**CC.LAUNCHES, **CAL.LAUNCHES}
    print(f"[conv] path ran in {time.perf_counter() - t0:.2f} s; launches {launches}, "
          f"catalyst rollouts {step_cuda.LAUNCHES['catalyst_rollout']}")
    check(all(launches[name] > 0 for name in (*CONV_REPLACES, *CALIBRATE_REPLACES)),
          f"a conv or calibration kernel was never launched: {launches}")
    err = dict.fromkeys((*CONV_REPLACES, *CALIBRATE_REPLACES), 0.0)

    # known answers of the path
    hits = int(search.successful_catalysts(pruned).sum())
    counts = (int(pruned.interacted.sum()), int(pruned.recovered.sum()), hits)
    per_t = [(int(t), int(search.successful_catalysts(r).sum())) for t, r in oriented]
    print(f"[conv] candidate_offsets: {offsets.shape[0]}; catalyst search over them, horizon "
          f"64: {counts[0]} interacted, {counts[1]} recovered, {hits} hits; hits per "
          f"orientation {per_t}")
    check(offsets.shape[0] == CANDIDATES, f"candidate_offsets gave {offsets.shape[0]}")
    check(counts == PRUNED_COUNTS, f"pruned catalyst counts {counts}, not {PRUNED_COUNTS}")
    check(per_t == ORIENTATION_HITS, f"hits per orientation {per_t}")
    check(torch.equal(io_sparse, io_dense), "interaction_offsets: sparse != dense route")
    check(int(B.population(io_pair)) == IO_POP
          and torch.equal(io_pair, CV.interaction_offsets(glider, eater)),
          "interaction_offsets(glider, eater): not the 71 offsets of every route")
    check(torch.equal(conv_host, CV.convolve(x.p01, x.pattern7.expand(CONV_B, 64),
                                             method="sparse")),
          "convolve: host shift-OR != peel kernel")
    x.io_pairs = CV.interaction_pairs(x.io_a, x.io_b)
    conv_vs_plain(CC, "union_sparse_fused", (x.io_pairs,), {}, err)
    union_pair = conv_vs_plain(CC, "union_sparse_fused", (CV.interaction_pairs(glider, eater),),
                               {}, err)
    check(int(B.population(union_pair)) == IO_POP and torch.equal(union_pair, io_pair),
          "union peel on the glider and eater's masks: not the 71 offsets")

    # the routes against one another: two independent exact algorithms
    exact = CC.conv_counts_fused(x.dense_a, x.dense_b)
    check(torch.equal(exact, counts_dense), "convolve_counts ntt_fused != conv_counts_fused")
    peeled = CC.counts_sparse_fused(x.a, x.b, n_planes=13)
    check(torch.equal(sum(B.to_dense(p).to(torch.int32) << i for i, p in enumerate(peeled)),
                      exact), "[13] dense counts != [12] peel at 13 planes")
    check(int(exact.max()) > 257, "the p=0.5 counts never pass 257")
    check(torch.equal(counts_sparse, counts_auto)
          and torch.equal(counts_sparse, CV.convolve_counts(x.a, x.tr_b, method="ntt_fused")),
          "convolve_counts: sparse, default and dense routes disagree")
    check(torch.equal(CC.conv_small_fused(x.dense_a, x.dense_b, out_or=False), exact % 193)
          and torch.equal(CC.conv_small_fused(x.dense_a, x.dense_b),
                          (exact % 193 != 0).to(torch.int8)),
          "[14] != [13] mod 193")
    check(torch.equal(CC.conv_small_packed(x.a, x.b), B.from_dense(exact % 193 != 0)),
          "[15] != ([13] mod 193) != 0")
    mirrored = B.mirrored(x.pattern100)
    check(torch.equal(corr, CV.convolve_counts(x.a, mirrored, method="ntt_fused")),
          "correlate_counts (single-prime) != dense counts")
    check(torch.equal(matched, B.from_dense(
        CV.convolve_counts(~x.a, mirrored, method="ntt_fused") == 0)),
          "match_live != its dense counts")
    check(torch.equal(small_conv, CV.convolve(x.a, x.mid_b, method="ntt_fused")),
          "convolve (packed single-prime) != dense route")
    check(torch.equal(orbit_keys[:256].cpu(), orbit_sweep(x.orbit_boards[:256].cpu())),
          "orbit sweep: card != CPU on 256 boards")
    print(f"[conv] interaction_offsets B={IO_B}: sparse (union peel) == dense route, "
          f"union peel == its plain version on the {IO_B} pairs' 7 mask pairs, glider/eater "
          f"pop {IO_POP} by both; [13] == [12] at 13 planes on {CONV_B} p=0.5 pairs (max count "
          f"{int(exact.max())}); [14] == [13] % 193, [15] == ([13] % 193) != 0; "
          f"host shift-OR == peel; correlate/match/convolve == dense routes")

    # every kernel against its twin at the path's shapes
    conv_vs_plain(CC, "convolve_sparse_fused", (x.tr_a, x.tr_b), {}, err)
    conv_vs_plain(CC, "convolve_sparse_fused", (x.p01, x.pattern7), {}, err)
    conv_vs_plain(CC, "counts_sparse_fused", (x.a, x.tr_b), dict(n_planes=13), err)
    conv_vs_plain(CC, "conv_counts_fused", (x.dense_a, x.dense_b), {}, err)
    corr_in = (x.dense_a, B.to_dense(mirrored).expand(CONV_B, 64, 64).contiguous())
    for out_or in (False, True):
        conv_vs_plain(CC, "conv_small_fused", corr_in, dict(out_or=out_or), err)
        conv_vs_plain(CC, "conv_small_fused", (x.dense_a, x.dense_b), dict(out_or=out_or), err)
    conv_vs_plain(CC, "conv_small_packed", (x.a, x.mid_b), {}, err)
    conv_vs_plain(CC, "conv_small_packed", (x.a, x.b), {}, err)
    for mix in CAL.MIXES:
        conv_vs_plain(CAL, "calibrate", (*x.calib, CALIB_ITERS), dict(mix=mix), err)
    check(not torch.equal(calib["elemwise"], calib["rolls"]), "the two mixes agree")
    print(f"[conv] kernels == plain twins at the path's shapes: peel on {CONV_B} 7-cell "
          f"pairs and on the p=0.1 boards with the 7-cell pattern, counts at 13 planes, "
          f"dense counts and both single-prime epilogues on {CONV_B} p=0.5 pairs and the "
          f"100-cell correlation, packed on {CONV_B} pairs; calibration on all "
          f"{CALIB_ROWS} rows, both mixes")
    print(f"[counters] {launches}")
    return launches, err, x


# ---------------------------------------------------------------------------
# The weld / dense-stable path
# ---------------------------------------------------------------------------


def catxeater(dev):
    """benches/weld_bench.py's catalyst x eater fixture: both welds, the
    displacement window [-20, 23]^2 (other placements pre-marked good) and
    the placements a call tests."""
    from lifeapi_tpu_torch import weld as W
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import rle

    def weld(pair):
        state = B.move(rle.parse(pair[0], device=dev), 20, 20)
        return W.from_required(state, B.move(rle.parse(pair[1], device=dev), 19, 19))

    a, b = weld(WELD_CATALYST), weld(WELD_EATER)
    ax = (torch.arange(64, device=dev) + 20) % 64 < 44
    window = ax[:, None] & ax[None, :]
    tested = window & ~B.to_dense(W.interaction_offsets(a, b))
    return a, b, B.from_dense(~window), tested


def verify_backgrounds(backgrounds, glider):
    """Step every background with the glider HORIZON generations by the
    port's step_n, kernel [1], kernel [4] (through the half-word layout)
    and the numpy oracle; all four must agree, and every background must
    recover.  Returns the number verified."""
    from lifeapi_tpu_torch.core import step as S
    from lifeapi_tpu_torch.ops import step_cuda

    start = (backgrounds | glider).contiguous()
    by_step_n = S.step_n(start, WELD_HORIZON)
    by_rollout = step_cuda.rollout(start, WELD_HORIZON)
    by_lohi = step_cuda.from_kernel_layout(
        *step_cuda.rollout_lohi(*step_cuda.to_kernel_layout(start), WELD_HORIZON))
    g = oracle_run(start.cpu().numpy(), WELD_HORIZON)
    check(torch.equal(by_rollout, by_step_n) and torch.equal(by_lohi, by_step_n),
          "pipeline backgrounds: step_n, kernel [1] and kernel [4] disagree")
    check((oracle_dense(by_step_n.cpu().numpy()) == g).all(),
          "pipeline backgrounds: the numpy oracle disagrees")
    return int((by_step_n == backgrounds).all(dim=-1).sum())


def weld_phase(dev):
    """Drive the weld / dense-stable path with every counter set to 0 just
    before: the Bellman pipeline (catalyst search, weld, reaction replay,
    host DFS, batched beam of every recovering placement, backgrounds
    verified by step_n, [1], [4] and the oracle), UnweldableMask on the
    catalyst x eater fixture (tier 1, then escalated), the portfolio and
    the dense propagate of the welded problems against kernel B.  Then the
    known answers and the checks.  Returns (launches, errors, run)."""
    from lifeapi_tpu_torch import weld as W
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.examples import bellman_pipeline, portfolio_minimise
    from lifeapi_tpu_torch.ops import conv_cuda as CC
    from lifeapi_tpu_torch.ops import stable_cuda as SC
    from lifeapi_tpu_torch.ops import step_cuda
    from lifeapi_tpu_torch.stable import bitplane as BP
    from lifeapi_tpu_torch.stable import complete as C
    from lifeapi_tpu_torch.stable import propagate as P

    r = SimpleNamespace()  # what the phase drove, for its checks and timings
    a, b, good, tested = catxeater(dev)
    xy = tested.nonzero()
    unweld_kw = dict(starting_good=good, engine="beam", batch_size=4096, beam_iters=24,
                     return_stats=True)
    tier3_marks = []
    tier3 = W._tier3

    def recording_tier3(residue, build, bad_dense, *args):
        before = bad_dense.copy()
        tier3(residue, build, bad_dense, *args)
        tier3_marks.extend((int(x), int(y)) for x, y in np.argwhere(bad_dense & ~before))

    torch.cuda.synchronize()
    for module in (step_cuda, SC, CC):
        module.reset_launches()
    t0 = time.perf_counter()
    r.pipe = bellman_pipeline.run(dev)
    found = r.pipe["beam"].found
    r.backgrounds = r.pipe["beam"].best[found]
    r.n_recovered = verify_backgrounds(r.backgrounds, r.pipe["glider"])
    t1 = time.perf_counter()
    r.tier1_mask, r.tier1_stats = W.unweldable_mask(a, b, escalate=False, **unweld_kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    W._tier3 = recording_tier3
    try:
        r.esc_mask, r.esc_stats = W.unweldable_mask(
            a, b, escalate=True, escalate_frontier=8, escalate_dfs_wall_budget=4.0,
            **unweld_kw)
    finally:
        W._tier3 = tier3
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    r.portfolio = portfolio_minimise.run(dev)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    r.problems = W._build_placements(a, b, xy)
    r.dense = P.propagate(r.problems)
    r.fused = SC.propagate_fused_inkernel(BP.from_dense_stable(r.problems))
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    launches = {**step_cuda.LAUNCHES, **SC.LAUNCHES, **CC.LAUNCHES}
    r.e2e_s = {"pipeline": t1 - t0, "unweldable tier 1": t2 - t1,
               "unweldable escalated": t3 - t2, "portfolio": t4 - t3,
               "dense propagate + kernel B": t5 - t4}
    print(f"[weld] path ran in {t5 - t0:.2f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(all(launches[name] > 0 for name in WELD_PATH_KERNELS),
          f"a kernel of the weld path was never launched: {launches}")
    err = {"rollout_lohi": 0.0}

    # the Bellman pipeline's known answers (CPU rehearsal = the JAX package)
    pipe = r.pipe
    got = (pipe["candidates"], pipe["hits"], pipe["offset"], pipe["stripped"],
           pipe["background_pop"], pipe["batched_found"], pipe["batched_verified"])
    print(f"[weld] pipeline: {pipe['candidates']} candidates, {pipe['hits']} hits, offset "
          f"{pipe['offset']}, {pipe['stripped']} stator cells stripped, DFS "
          f"{pipe['dfs_result'].name} pop {pipe['background_pop']}, verified "
          f"{pipe['verified']}; batched beam of all {pipe['hits']}: found "
          f"{pipe['batched_found']}, verified {pipe['batched_verified']}; step_n == [1] == "
          f"[4] == oracle on all {r.backgrounds.shape[0]} found, {r.n_recovered} recover")
    check(got == PIPELINE_ANSWERS, f"pipeline answers {got}, not {PIPELINE_ANSWERS}")
    check(pipe["dfs_result"] == C.CompletionResult.COMPLETED and pipe["verified"],
          "pipeline: the DFS background does not complete or recover")
    dfs_bg = pipe["background"]
    check(torch.equal(step_cuda.rollout(dfs_bg[None], 1)[0], dfs_bg)
          and verify_backgrounds(dfs_bg[None], pipe["glider"]) == 1,
          "pipeline: the DFS background is not a still life that recovers")
    check(r.n_recovered == pipe["batched_found"] == pipe["batched_verified"],
          "pipeline: a found background does not recover")

    # UnweldableMask: tier 1 against the beam's plain twin, the JAX count,
    # and the escalated tiers' soundness
    beam = SC.beam_search
    SC.beam_search = SC.beam_search_plain
    try:
        plain_mask, plain_stats = W.unweldable_mask(a, b, escalate=False, **unweld_kw)
    finally:
        SC.beam_search = beam
    proved = B.to_dense(r.tier1_mask) & tested
    r.n_tested, r.n_proved = int(tested.sum()), int(proved.sum())
    print(f"[weld] unweldable_mask catxeater: {r.n_tested} placements tested; tier 1 "
          f"(F=4, 24 iters) proved {r.n_proved}, stats {r.tier1_stats}; escalated stats "
          f"{r.esc_stats}; {len(tier3_marks)} tier-3 marks")
    check(r.tier1_stats["placements"] == r.n_tested == WELD_TESTED,
          f"unweldable_mask tested {r.n_tested}, not {WELD_TESTED}")
    check(torch.equal(r.tier1_mask, plain_mask) and plain_stats == r.tier1_stats,
          "unweldable_mask tier 1: kernel != the beam's plain twin")
    check(sorted(map(tuple, proved.nonzero().tolist())) == sorted(WELD_TIER1_MARKS),
          f"unweldable_mask tier 1 proved {r.n_proved}, not the JAX package's "
          f"{len(WELD_TIER1_MARKS)} placements")
    esc = B.to_dense(r.esc_mask)
    check(bool((esc | ~proved).all()), "escalated mask dropped a tier-1 mark")
    check(r.esc_stats["tier1_residue"] == r.tier1_stats["tier1_residue"],
          "escalated tier-1 residue != tier 1's")
    check(int((esc & tested).sum()) == r.n_proved + r.esc_stats["tier2_proved"]
          + len(tier3_marks), "escalated marks != tier 1 + tier 2 + tier 3")
    if tier3_marks:
        problems = W._build_placements(a, b, torch.tensor(tier3_marks, device=dev))
        for host_st in W._host_problems(problems):
            result, _ = C.complete_stable(host_st, timeout=5.0, minimise=False, strict=True)
            check(result == C.CompletionResult.INCONSISTENT,
                  "a tier-3 mark is not a strict DFS refutation")

    # the portfolio
    res = r.portfolio["result"]
    print(f"[weld] portfolio, two anchors, 256 replicas, F=4, 192 iters: found {res.found}, "
          f"pop {res.best_pop}, found fraction {res.found_fraction:.4f}, still life "
          f"{r.portfolio['still_life']}, anchors {r.portfolio['anchors_on']}")
    check(res.found and r.portfolio["still_life"] and r.portfolio["anchors_on"]
          and r.portfolio["inside_area"] and res.best_pop == PORTFOLIO_MIN_POP,
          "portfolio: the champion is not a still life of pop 6 on both anchors")

    # the dense propagate (plain torch on the card) against kernel B
    ok = r.dense.consistent
    check(torch.equal(ok, r.fused.consistent), "dense propagate != kernel B: consistent flags")
    back = BP.to_dense_stable(r.fused.stable)
    for name in ("state", "unknown", "ruled"):
        check(torch.equal(getattr(back, name)[ok], getattr(r.dense.stable, name)[ok]),
              f"dense propagate != kernel B: {name} of a consistent board")
    print(f"[weld] dense propagate == kernel B on {xy.shape[0]} welded problems "
          f"({int(ok.sum())} consistent)")

    # kernel [4] against its twin and kernel [1], at the headline and a ragged shape
    gen = torch.Generator(device=dev).manual_seed(4)
    for batch, steps in ((HEADLINE_B, HEADLINE_T), (1000, 37)):
        boards = B.random(gen, (batch,), device=dev)
        lo, hi = step_cuda.to_kernel_layout(boards)
        got = step_cuda.rollout_lohi(lo, hi, steps)
        want = step_cuda.rollout_lohi_plain(lo, hi, steps)
        via_rollout = step_cuda.to_kernel_layout(step_cuda.rollout(boards, steps))
        torch.cuda.synchronize()
        for g, w, v in zip(got, want, via_rollout):
            err["rollout_lohi"] = max(err["rollout_lohi"], max_err(g, w))
            check(torch.equal(g, w) and torch.equal(g, v),
                  f"rollout_lohi B={batch} T={steps}: kernel != plain twin or kernel [1]")
    r.lohi_boards = boards
    print(f"[weld] rollout_lohi == plain twin == kernel [1] at B={HEADLINE_B} "
          f"T={HEADLINE_T} and B=1000 T=37")
    print(f"[counters] {launches}")
    return launches, err, r


def weld_timings(r, ms, plain_ms, dev_ms, card):
    """Kernel [4] against its twin, its and [1]'s device times, and the weld
    path's end to end times."""
    from lifeapi_tpu_torch import weld as W
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.examples import bellman_pipeline, portfolio_minimise
    from lifeapi_tpu_torch.ops import stable_cuda as SC
    from lifeapi_tpu_torch.ops import step_cuda
    from lifeapi_tpu_torch.stable import bitplane as BP
    from lifeapi_tpu_torch.stable import propagate as P

    dev = r.lohi_boards.device
    gen = torch.Generator(device=dev).manual_seed(0)
    lo, hi = step_cuda.to_kernel_layout(B.random(gen, (HEADLINE_B,), device=dev))
    ms["rollout_lohi"], plain_ms["rollout_lohi"] = paired_ms(
        lambda: step_cuda.rollout_lohi(lo, hi, HEADLINE_T),
        lambda: step_cuda.rollout_lohi_plain(lo, hi, HEADLINE_T), reps=5)
    boards = step_cuda.from_kernel_layout(lo, hi)
    dev_ms["rollout_lohi"] = device_ms_at(lambda: step_cuda.rollout_lohi(lo, hi, HEADLINE_T),
                                          "rollout_lohi_kernel", "rollout_lohi", n=20)
    dev_ms["rollout"] = device_ms_at(lambda: step_cuda.rollout(boards, HEADLINE_T),
                                     "rollout_kernel", "rollout", n=20)
    (d, mhz), (d_1, mhz_1) = dev_ms["rollout_lohi"], dev_ms["rollout"]
    print(f"[time] card: {card}")
    print(f"[time] rollout_lohi B={HEADLINE_B} T={HEADLINE_T}: kernel "
          f"{ms['rollout_lohi']:.4f} ms a call ({d:.4f} ms of it on the device, "
          f"profiler, SM clock {mhz} MHz), plain {plain_ms['rollout_lohi']:.4f} ms; kernel "
          f"[1] on the same boards {d_1:.4f} ms on the device at {mhz_1} MHz "
          f"([4] / [1]: {d / d_1:.4f})")
    runs = [bellman_pipeline.run(dev) for _ in range(3)]
    e2e = [sum(x["stages"].values()) for x in runs]
    stages = {k: statistics.median(x["stages"][k] for x in runs) for k in runs[0]["stages"]}
    print(f"[time] Bellman pipeline end to end: median {statistics.median(e2e) * 1e3:.3f} ms "
          f"over 3 (first, counted run {r.e2e_s['pipeline'] * 1e3:.3f} ms with the "
          f"four-way background check); stages: "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in stages.items()))
    a, b, good, _ = catxeater(dev)
    unweld_kw = dict(starting_good=good, engine="beam", batch_size=4096, beam_iters=24)
    tier1_s = wall(lambda: W.unweldable_mask(a, b, escalate=False, **unweld_kw), 3)
    tier3 = W._tier3
    W._tier3 = lambda *args: None  # tiers 1 and 2 only
    try:
        tiers12_s = wall(lambda: W.unweldable_mask(a, b, escalate=True, escalate_frontier=8,
                                                   **unweld_kw), 3)
    finally:
        W._tier3 = tier3
    print(f"[time] unweldable_mask catxeater, {r.n_tested} placements: tier 1 median "
          f"{tier1_s * 1e3:.3f} ms over 3 ({r.n_tested / tier1_s:.6g} placements/s); "
          f"tiers 1 and 2 (F=8, 512 iters on the {r.tier1_stats['tier1_residue']}-placement "
          f"residue) median {tiers12_s * 1e3:.3f} ms over 3, so tier 2 "
          f"{(tiers12_s - tier1_s) * 1e3:.3f} ms; escalated with tier 3 (DFS wall budget 4 s) "
          f"{r.e2e_s['unweldable escalated']:.3f} s, one run")
    portfolio_s = wall(lambda: portfolio_minimise.run(dev), 3)
    print(f"[time] portfolio end to end: median {portfolio_s * 1e3:.3f} ms over 3 (first, "
          f"counted run {r.e2e_s['portfolio'] * 1e3:.3f} ms)")
    dense_s = wall(lambda: P.propagate(r.problems), 3)
    bst = BP.from_dense_stable(r.problems)
    fused_s = wall(lambda: SC.propagate_fused_inkernel(bst), 5)
    n = r.problems.state.shape[0]
    print(f"[time] propagate of {n} welded problems: dense plain torch median "
          f"{dense_s * 1e3:.3f} ms over 3, kernel B (packed input) median "
          f"{fused_s * 1e3:.4f} ms over 5 ({dense_s / fused_s:.4g}x)")


def event_ms(fn, reps):
    """Median CUDA-event milliseconds of fn after one warm-up call."""
    fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def fft_counts(da, db):
    """The library yardstick for the dense counts: float32 FFT convolution,
    rounded (timed only; the port never calls it)."""
    fa = torch.fft.rfft2(da.to(torch.float32))
    fb = torch.fft.rfft2(db.to(torch.float32))
    return torch.round(torch.fft.irfft2(fa * fb, s=(64, 64)))


def fft_packed_mask(a, b):
    """The library yardstick of [15]: the torch.fft counts of the boards'
    cells, mod 193, != 0, packed (timed only; the port never calls it)."""
    from lifeapi_tpu_torch.core import board as B

    return B.from_dense(fft_counts(B.to_dense(a), B.to_dense(b)) % 193 != 0)


def fft_mask(a, b):
    """The library yardstick of [11]: the torch.fft counts of the boards'
    cells, > 0, packed (timed only; the port never calls it)."""
    from lifeapi_tpu_torch.core import board as B

    return B.from_dense(fft_counts(B.to_dense(a), B.to_dense(b)) > 0)


def fft_planes(a, b, n_planes=13):
    """The library yardstick of [12]: the torch.fft counts as n_planes
    packed bit planes (timed only)."""
    from lifeapi_tpu_torch.core import board as B

    counts = fft_counts(B.to_dense(a), B.to_dense(b)).to(torch.int64)
    return [B.from_dense((counts >> i) & 1 != 0) for i in range(n_planes)]


def fft_union(pairs):
    """The library yardstick of the union peel: the torch.fft counts of the
    stacked pairs, > 0 on any pair, packed (timed only)."""
    from lifeapi_tpu_torch.core import board as B

    lefts = B.to_dense(torch.stack(torch.broadcast_tensors(*[l for l, _ in pairs])))
    rights = B.to_dense(torch.stack(torch.broadcast_tensors(*[r for _, r in pairs])))
    return B.from_dense((fft_counts(lefts, rights) > 0).any(dim=0))


def conv_timings(x, ms, plain_ms, lib_ms, dev_ms, card):
    """Each conv kernel against its twin at the path's shapes, in turns, its
    device time, the FFT yardstick, torch.bitwise_or on [11]'s operands
    (``x.or_floor_ms``), the peels' and bitwise_or's device times with
    inputs and outputs rotated past the L2 (``x.rotated_ms``,
    ``x.or_floor_rotated_ms``), the calibration ceilings, the path's end-to-end
    rates and the routing probes' host cost.  Returns the ceilings
    (word-ops/s by mix)."""
    from lifeapi_tpu_torch import search
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import convolve as CV
    from lifeapi_tpu_torch.ops import calibrate_cuda as CAL
    from lifeapi_tpu_torch.ops import conv_cuda as CC

    corr_in = (x.dense_a, B.to_dense(B.mirrored(x.pattern100)).expand(CONV_B, 64, 64)
               .contiguous())
    cases = {
        "convolve_sparse_fused": ((x.tr_a, x.tr_b), {}, 10),
        "counts_sparse_fused": ((x.a, x.tr_b), dict(n_planes=13), 10),
        "union_sparse_fused": ((x.io_pairs,), {}, 10),
        "conv_counts_fused": ((x.dense_a, x.dense_b), {}, 5),
        "conv_small_fused": (corr_in, dict(out_or=False), 5),
        "conv_small_packed": ((x.a, x.mid_b), {}, 5),
    }
    for name, (args, kw, reps) in cases.items():
        ms[name], plain_ms[name] = paired_ms(
            lambda: getattr(CC, name)(*args, **kw),
            lambda: getattr(CC, f"{name}_plain")(*args, **kw), reps=reps)
    kernel_names = {"convolve_sparse_fused": "conv_sparse_kernel",
                    "counts_sparse_fused": "counts_sparse_kernel",
                    "union_sparse_fused": "union_sparse_kernel",
                    "conv_counts_fused": NTT_KERNEL, "conv_small_fused": NTT_KERNEL,
                    "conv_small_packed": NTT_KERNEL}
    dev_ms.update({name: device_ms_at(lambda: getattr(CC, name)(*args, **kw),
                                      kernel_names[name], name)
                   for name, (args, kw, _) in cases.items()})
    or_out = torch.empty_like(x.tr_a)
    x.or_floor_ms = operator_device_ms(lambda: torch.bitwise_or(x.tr_a, x.tr_b, out=or_out))
    # the same again from device memory: inputs and outputs rotated past the L2
    nbytes = peel_bytes(len(x.io_pairs))
    copies = {name: rotation_copies(n) for name, n in nbytes.items()}
    rotated = {
        "convolve_sparse_fused": (CC.convolve_sparse_fused,
                                  [(x.tr_a.clone(), x.tr_b.clone())
                                   for _ in range(copies["convolve_sparse_fused"])]),
        "counts_sparse_fused": (lambda a, b: CC.counts_sparse_fused(a, b, n_planes=13),
                                [(x.a.clone(), x.tr_b.clone())
                                 for _ in range(copies["counts_sparse_fused"])]),
        "union_sparse_fused": (CC.union_sparse_fused,
                               [(CV.interaction_pairs(x.io_a.clone(), x.io_b.clone()),)
                                for _ in range(copies["union_sparse_fused"])]),
    }
    x.rotated_ms = {name: (profiled_device_ms(rotating_call(fn, inputs), kernel_names[name],
                                              name), len(inputs), len(inputs) * nbytes[name])
                    for name, (fn, inputs) in rotated.items()}
    or_inputs = [(x.tr_a.clone(), x.tr_b.clone(), torch.empty_like(x.tr_a))
                 for _ in range(copies["convolve_sparse_fused"])]
    x.or_floor_rotated_ms = operator_device_ms(rotating_call(
        lambda a, b, out: torch.bitwise_or(a, b, out=out), or_inputs))
    lib_ms["convolve_sparse_fused"] = event_ms(lambda: fft_mask(x.tr_a, x.tr_b), 5)
    lib_ms["counts_sparse_fused"] = event_ms(lambda: fft_planes(x.a, x.tr_b), 5)
    lib_ms["union_sparse_fused"] = event_ms(lambda: fft_union(x.io_pairs), 5)
    lib_ms["conv_counts_fused"] = event_ms(lambda: fft_counts(x.dense_a, x.dense_b), 5)
    lib_ms["conv_small_fused"] = event_ms(lambda: fft_counts(*corr_in), 5)
    lib_ms["conv_small_packed"] = event_ms(lambda: fft_packed_mask(x.a, x.mid_b), 5)
    ceilings = {}
    for mix in CAL.MIXES:
        t = event_ms(lambda: CAL.calibrate(*x.calib, CALIB_ITERS, mix), 5)
        ceilings[mix] = CAL.calibrate(*x.calib, CALIB_ITERS, mix)[1] / (t / 1e3)
        if mix == "elemwise":
            ms["calibrate"] = t
            plain_ms["calibrate"] = event_ms(
                lambda: CAL.calibrate_plain(*x.calib, CALIB_ITERS, mix), 1)
            dev_ms["calibrate"] = device_ms_at(
                lambda: CAL.calibrate(*x.calib, CALIB_ITERS, mix), "calibrate_kernel",
                "calibrate", n=20)
    print(f"[time] card: {card}")
    for name, (args, _, _) in cases.items():
        lib = f", torch.fft yardstick {lib_ms[name]:.4f} ms" if name in lib_ms else ""
        d, mhz = dev_ms[name]
        batch = len(args[0]) if name != "union_sparse_fused" else f"{IO_B} x 7 pairs"
        print(f"[time] {name} B={batch}: kernel {ms[name]:.4f} ms a call "
              f"({d:.4f} ms of it on the device, profiler, SM clock {mhz} MHz), plain "
              f"{plain_ms[name]:.4f} ms{lib}{before_redesign(name, d)}")
    print(f"[time] torch.bitwise_or on convolve_sparse_fused's {CONV_B} pairs (the same "
          f"bytes, no work): {x.or_floor_ms:.4f} ms on the device, profiler; "
          f"{x.or_floor_rotated_ms:.4f} ms with inputs and outputs rotated past the L2")
    for name, (d, n, total) in x.rotated_ms.items():
        print(f"[time] {name}: {d:.4f} ms on the device with inputs and outputs rotated "
              f"over {n} copies ({total / 1e6:.0f} MB), against {dev_ms[name][0]:.4f} ms on "
              f"one set")
    for mix, rate in ceilings.items():
        print(f"[time] calibrate {mix}, {CALIB_ROWS} rows x {CALIB_ITERS} iterations: "
              f"{rate:.6g} 64-bit word-ops/s")
    d, mhz = dev_ms["calibrate"]
    print(f"[time] calibrate elemwise: kernel {ms['calibrate']:.4f} ms ({d:.4f} ms on the "
          f"device, profiler, SM clock {mhz} MHz), plain {plain_ms['calibrate']:.4f} ms")

    glider, eater = (B.from_cells(c, device=x.a.device) for c in (GLIDER, EATER))
    offsets = search.candidate_offsets(glider, eater)
    e2e = {
        "candidate_offsets": (lambda: search.candidate_offsets(glider, eater), 1),
        "catalyst_search, 4025 offsets": (
            lambda: search.catalyst_search(glider, eater, offsets, 64), 4025),
        "catalyst_search_all_orientations": (
            lambda: search.catalyst_search_all_orientations(glider, eater, offsets, 64),
            8 * 4025),
        f"interaction_offsets sparse, {IO_B} pairs": (
            lambda: CV.interaction_offsets(x.io_a, x.io_b, method="sparse"), IO_B),
        f"interaction_offsets ntt_fused, {IO_B} pairs": (
            lambda: CV.interaction_offsets(x.io_a, x.io_b, method="ntt_fused"), IO_B),
        f"convolve sparse, {CONV_B} traced 7-cell pairs": (
            lambda: CV.convolve(x.tr_a, x.tr_b, method="sparse"), CONV_B),
        f"convolve host shift-OR, {CONV_B} boards x 7-cell pattern": (
            lambda: CV.convolve(x.p01, x.pattern7), CONV_B),
        f"match_live, {CONV_B} states x 100-cell pattern": (
            lambda: CV.match_live(x.a, x.pattern100), CONV_B),
        f"convolve default route (packed single-prime), {CONV_B} pairs of 49-192 cells": (
            lambda: CV.convolve(x.a, x.mid_b), CONV_B),
        f"orbit sweep, {CONV_B} boards": (lambda: orbit_sweep(x.orbit_boards), CONV_B),
    }
    for what, (fn, n) in e2e.items():
        fn()
        t = wall(fn, 5) * 1e3
        print(f"[time] {what} end to end: median {t:.4f} ms ({n / t * 1e3:.6g}/s) over 5")
    probes = {
        "_max_pop (batched)": lambda: CV._max_pop(x.tr_b),
        "_host_cells (one board)": lambda: CV._host_cells(x.pattern7),
        "_auto_small": lambda: CV._auto_small(x.pattern100),
    }
    for what, fn in probes.items():
        print(f"[time] routing probe {what}: median {wall(fn, 20) * 1e3:.4f} ms on the host")
    return ceilings


def solver_work(stable_inputs):
    """The data-dependent work of the solver kernels on the fixpoint and
    beam inputs: (fixpoint board-steps, beam board-steps, beam priority
    boards).  A board-step is one propagation step of one alive board; a
    priority board is one ok slot of one round.  The
    plain twins run with their masked fixpoint split into single steps, so
    the boards each step keeps alive can be counted; their results are
    checked against the kernels', which do the same work."""
    from lifeapi_tpu_torch.ops import stable_cuda as SC
    from lifeapi_tpu_torch.stable import bitplane as BP

    beam_bst, _, fix_bst = stable_inputs
    work = {"board_steps": 0, "priority_boards": 0}
    fixpoint, slot_priorities = SC._fixpoint, SC._slot_priorities

    def counted(planes, max_iters, alive=None):
        alive = (torch.ones(planes.shape[:-2], dtype=torch.bool, device=planes.device)
                 if alive is None else alive)
        aborted, changed = torch.zeros_like(alive), torch.zeros_like(alive)
        for _ in range(max_iters):
            if not bool(alive.any()):
                break
            work["board_steps"] += int(alive.sum())
            planes, ab, ch = fixpoint(planes, 1, alive)
            aborted, changed = aborted | ab, changed | ch
            alive = alive & ~ab & ch
        return planes, aborted, changed

    def counted_priorities(planes, ok):  # a beam round: the ok slots' priorities
        work["priority_boards"] += int(ok.sum())
        return slot_priorities(planes, ok)

    fix_planes = BP.to_planes(fix_bst).contiguous()
    beam_planes = BP.to_planes(beam_bst).contiguous()
    kw = dict(frontier=BEAM_F, iters=BEAM_ITERS, minimise=True)
    SC._fixpoint, SC._slot_priorities = counted, counted_priorities
    try:
        fix = SC.propagate_fixpoint_plain(fix_planes)
        fix_steps = work["board_steps"]
        work["board_steps"] = 0
        beam = SC.beam_search_plain(beam_planes, **kw)
    finally:
        SC._fixpoint, SC._slot_priorities = fixpoint, slot_priorities
    for got, want in ((fix, SC.propagate_fixpoint(fix_planes)),
                      (beam, SC.beam_search(beam_planes, **kw))):
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              "the step-counting twins != the kernels")
    return fix_steps, work["board_steps"], work["priority_boards"]


def step_bytes():
    """The bytes kernel A ([5]) must move on the FIX_B fixpoint boards: 10
    planes in and out, and the changed and abort boards out."""
    return FIX_B * (2 * 10 * 512 + 2 * 512)


def fixpoint_bytes(name):
    """The bytes kernel B ([6], [7]) or C ([8], [9]) must move on the
    FIX_B fixpoint boards: 10 planes in and out, two flags, and C's 4
    levels."""
    planes, levels = FIX_B * 10 * 512, FIX_B * 4 * 512
    priorities = name in ("propagate_fixpoint_priorities", "propagate_fused_beam")
    return 2 * planes + 2 * FIX_B + (levels if priorities else 0)


def kernel_bounds(ceilings, stable_inputs, x, ms, dev_ms, lib_path):
    """(bound_ms and bound_by of every kernel at the shapes timed above,
    the SASS warp instructions a board-generation of [1] and [4] and a board
    of [5]).  A bound is the larger of its bytes (each input read once,
    each output written once) over the memory rate and its operations over
    the card's rate for them: the rollout, solver and peel kernels' SASS
    over the issue peak, the calibration's word-ops over its calibrated
    ceiling, the dense counts' NTT FLOP over the bf16 tensor-core peak.
    Data-dependent work is what this run's inputs need: the fixpoint steps
    and priorities of solver_work, the cells each peel takes (the union:
    the smaller side of each pair)."""
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.ops.calibrate_cuda import ops_per_iter
    from lifeapi_tpu_torch.stable import bitplane as BP

    def on_device(name, bound_ms):
        if name not in dev_ms:
            return ""
        d, mhz = dev_ms[name]
        return f"; on the device {d:.4f} ms ({mhz} MHz), {d / bound_ms:.3g}x it"

    fix_steps, beam_steps, beam_prio = solver_work(stable_inputs)
    funcs = library_sass(lib_path)
    sass = rollout_sass_counts(funcs)
    solver = solver_sass_counts(funcs)
    peel = peel_sass_counts(funcs)
    step_a = block_instructions(funcs["step_kernel"], STEP_SHUFFLES)
    issue, sms, mhz = issue_peak()
    print(f"[bound] issue peak {issue:.6g} warp instructions/s ({sms} SMs x "
          f"{SCHEDULERS_PER_SM} schedulers x {mhz:g} MHz); SASS warp instructions per "
          f"board-generation: " + ", ".join(f"{k} {v:g}" for k, v in sass.items()))
    print(f"[bound] SASS of step_kernel (propagate_step): {step_a} warp instructions a "
          f"board (the step's block); of the peel's round loop, a cell: "
          + ", ".join(f"{PEEL_KERNELS[k]} {v:g}" for k, v in peel.items()))
    for name, (step, prio) in solver.items():
        print(f"[bound] SASS of {SOLVER_KERNELS[name]} ({name}): {step:g} warp instructions "
              f"per board-step (fixpoint loop)"
              + (f", {prio} per priority board (priority block)" if prio else ""))
    for name, (hmma, ldsm, frnd, n) in ntt_sass_counts(funcs).items():
        print(f"[bound] SASS of {name}: {hmma} HMMA (tensor cores), {ldsm} LDSM, "
              f"{frnd} FRND (one per mod reduction), {n} instructions")
    peeled = int(B.population(x.tr_b).sum())
    union_cells = sum(int(torch.minimum(B.population(l), B.population(r)).sum())
                      for l, r in x.io_pairs)
    board, words, solver_board = 512, 64, BP.N_PLANES * 512  # bytes, words of one board
    peel_moves = peel_bytes(len(x.io_pairs))
    step_ops = words * STABLE_STEP_OPS
    prio_ops = words * PRIORITY_OPS
    rates = {**ceilings, "bf16 tensor-core FLOP": BF16_FLOP_PER_S, "issue": issue}
    fix_c = fix_steps * solver["propagate_fixpoint_priorities"][0] \
        + FIX_B * solver["propagate_fixpoint_priorities"][1]
    work = {  # name: (bytes, operations, the rate they run at)
        "rollout": (2 * HEADLINE_B * board,
                    HEADLINE_B * HEADLINE_T * sass["rollout"], "issue"),
        # the same board-steps; the half-words read and written once
        "rollout_lohi": (4 * 64 * HEADLINE_B * 4,
                         HEADLINE_B * HEADLINE_T * sass["rollout_lohi"], "issue"),
        "controlled_rollout": ((2 + 32) * 64 * board, 64 * 32 * sass["controlled_rollout"],
                               "issue"),
        "catalyst_rollout": (4 * 4096 * board + 64 * board + 4096,
                             4096 * 64 * sass["catalyst_rollout"], "issue"),
        "propagate_step": (step_bytes(), FIX_B * step_a, "issue"),
        # [6] is one launch of kernel B, so its work is B's
        "propagate_fused": (fixpoint_bytes("propagate_fused"),
                            fix_steps * solver["propagate_fixpoint"][0], "issue"),
        "propagate_fixpoint": (fixpoint_bytes("propagate_fixpoint"),
                               fix_steps * solver["propagate_fixpoint"][0], "issue"),
        "propagate_fixpoint_priorities": (fixpoint_bytes("propagate_fixpoint_priorities"),
                                          fix_c, "issue"),
        "propagate_fused_beam": (fixpoint_bytes("propagate_fused_beam"), fix_c, "issue"),
        "beam_search": (BEAM_B * (solver_board + board + 4 + 3),
                        beam_steps * solver["beam_search"][0]
                        + beam_prio * solver["beam_search"][1], "issue"),
        "convolve_sparse_fused": (peel_moves["convolve_sparse_fused"],
                                  peeled * peel["convolve_sparse_fused"], "issue"),
        "counts_sparse_fused": (peel_moves["counts_sparse_fused"],
                                peeled * peel["counts_sparse_fused"], "issue"),
        "union_sparse_fused": (peel_moves["union_sparse_fused"],
                               union_cells * peel["union_sparse_fused"], "issue"),
        "conv_counts_fused": (CONV_B * 4096 * (1 + 1 + 4), CONV_B * 2 * NTT_FLOP_PER_PRIME,
                              "bf16 tensor-core FLOP"),
        "conv_small_fused": (CONV_B * 4096 * (1 + 1 + 4), CONV_B * NTT_FLOP_PER_PRIME,
                             "bf16 tensor-core FLOP"),
        "conv_small_packed": (3 * CONV_B * board, CONV_B * NTT_FLOP_PER_PRIME,
                              "bf16 tensor-core FLOP"),
        "calibrate": (3 * CALIB_ROWS * board,
                      CALIB_ROWS * words * CALIB_ITERS * ops_per_iter("elemwise"), "elemwise"),
    }
    print(f"[bound] data-dependent work: fixpoint {fix_steps} board-steps over {FIX_B} "
          f"boards; beam {beam_steps} board-steps and {beam_prio} priority boards (ok "
          f"slots) over {BEAM_B} problems; peel {peeled} cells over {CONV_B} boards; union "
          f"peel {union_cells} cells over {IO_B} queries")
    bounds = {}
    for name, (nbytes, ops, rate) in work.items():
        ops = int(ops)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = ops / rates[rate] * 1e3
        bounds[name] = (max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations")
        unit = ("FLOP" if "FLOP" in rate else "warp instructions (SASS), issue peak"
                if rate == "issue" else f"word-ops, {rate}")
        print(f"[bound] {name}: {nbytes} bytes ({by_bytes:.4f} ms), {ops} {unit} "
              f"({by_ops:.4f} ms): bound {bounds[name][0]:.4f} ms by "
              f"{bounds[name][1]}; the kernel's call {ms[name]:.4f} ms is "
              f"{ms[name] / bounds[name][0]:.3g}x it{on_device(name, bounds[name][0])}")
    d_or, d_or_rot = x.or_floor_ms, x.or_floor_rotated_ms
    by_bytes = peel_moves["convolve_sparse_fused"] / HBM_BYTES_PER_S * 1e3
    print(f"[bound] convolve_sparse_fused beside torch.bitwise_or on its operands (the same "
          f"bytes, no work): {d_or:.4f} ms on the device ({d_or / by_bytes:.3g}x the bytes "
          f"bound), {d_or_rot:.4f} ms ({d_or_rot / by_bytes:.3g}x) rotated past the L2"
          + (f"; the kernel's device time is {dev_ms['convolve_sparse_fused'][0] / d_or:.3g}x "
             f"and {x.rotated_ms['convolve_sparse_fused'][0] / d_or_rot:.3g}x it"
             if "convolve_sparse_fused" in dev_ms else ""))
    for name, (rot, n, total) in x.rotated_ms.items():
        by_bytes = peel_moves[name] / HBM_BYTES_PER_S * 1e3
        first = dev_ms[name][0]
        print(f"[bound] {name}: bytes bound {by_bytes:.4f} ms; on the device {first:.4f} ms "
              f"({first / by_bytes:.3g}x) on one set of inputs, {rot:.4f} ms "
              f"({rot / by_bytes:.3g}x) with inputs and outputs rotated over {n} copies "
              f"({total / 1e6:.0f} MB, past the L2)")
    hand = {"propagate_step": FIX_B * step_ops, "propagate_fixpoint": fix_steps * step_ops,
            "propagate_fixpoint_priorities": fix_steps * step_ops + FIX_B * prio_ops,
            "propagate_fused_beam": fix_steps * step_ops + FIX_B * prio_ops,
            "beam_search": beam_steps * step_ops + beam_prio * prio_ops}
    # [2]'s batch is too small to fill the card: the least time one warp
    # takes to step one board, its T generations of the loop's instructions
    # at one a clock, is a second bound beside the bytes
    one_warp_ms = 32 * sass["controlled_rollout"] / (mhz * 1e6) * 1e3
    print(f"[bound] controlled_rollout, second bound: one warp's 32 generations x "
          f"{sass['controlled_rollout']:g} instructions at one a clock, {mhz:g} MHz "
          f"({one_warp_ms:.4f} ms); the kernel's call {ms['controlled_rollout']:.4f} ms is "
          f"{ms['controlled_rollout'] / one_warp_ms:.3g}x it"
          f"{on_device('controlled_rollout', one_warp_ms)}")
    for name, ops in hand.items():
        hand_ms = ops / ceilings["rolls"] * 1e3
        print(f"[bound] {name}, hand count (not the bound): {ops} word-ops at the rolls "
              f"ceiling ({hand_ms:.4f} ms); the kernel's call {ms[name]:.4f} ms is "
              f"{ms[name] / hand_ms:.3g}x it{on_device(name, hand_ms)}")
    for name, primes in (("conv_counts_fused", 2), ("conv_small_fused", 1),
                         ("conv_small_packed", 1)):
        reductions = CONV_B * (primes * MOD_REDUCTIONS_PER_PRIME + (primes - 1) * 4096)
        warp_instructions = reductions * MOD_INSTRUCTIONS // 32
        mod_ms = warp_instructions / issue * 1e3
        print(f"[bound] {name}, second bound: {reductions} mod reductions x "
              f"{MOD_INSTRUCTIONS} instructions = {warp_instructions} warp instructions "
              f"over the issue peak ({mod_ms:.4f} ms); the kernel's call {ms[name]:.4f} ms is "
              f"{ms[name] / mod_ms:.3g}x it{on_device(name, mod_ms)}")
    return bounds, {"rollout": sass["rollout"], "rollout_lohi": sass["rollout_lohi"],
                    "propagate_step": step_a}


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1

    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import rle
    from lifeapi_tpu_torch.mpc import CostWeights, MPCProblem, solver
    from lifeapi_tpu_torch.ops import _build, soft_cuda, solver_cuda, step_cuda
    from lifeapi_tpu_torch import search
    from lifeapi_tpu_torch.target import LifeTarget, hamming_cost

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # -- 1. environment ------------------------------------------------------
    print(f"[env] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.library()
    print(f"[env] built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for name, regs, spill in ptxas_report(lib_path.with_suffix(".log").read_text()):
        print(f"[env] ptxas: {name}: {regs} registers, {spill} bytes spill stores")
    print_occupancy()

    # -- inputs of the main path ----------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    boards = B.random(gen, (HEADLINE_B,), device=dev)

    def block_target():
        return LifeTarget.from_state(B.move(rle.parse("2o$2o!", device=dev), 31, 31))

    def mask(lo, hi):
        m = torch.zeros((64, 64), dtype=torch.bool, device=dev)
        m[lo:hi, lo:hi] = True
        return m

    demo = MPCProblem(initial=B.empty(device=dev), target=block_target(),
                      horizon=8, control_mask=mask(24, 40),
                      weights=CostWeights(target=1.0, control=0.01))
    bench = bench_problem(dev)
    glider = B.from_cells(GLIDER, device=dev)
    eater = B.from_cells(EATER, device=dev)
    full_grid = torch.tensor([[dx, dy] for dx in range(64) for dy in range(64)],
                             device=dev)
    example_grid = torch.tensor(
        [[dx, dy] for dx in range(-8, 9) for dy in range(-8, 9)], device=dev)

    # -- 2. the main path -----------------------------------------------------
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    rolled = step_cuda.rollout(boards, HEADLINE_T)
    demo_sol = solver.solve(demo, torch.Generator().manual_seed(0),
                            n_candidates=16, iters=150)
    bench_logits0 = solver.init_logits(torch.Generator().manual_seed(0), bench, 64)
    bench_logits, _ = solver.solve_gradient(bench_logits0, bench, iters=100)
    bench_sol = solver.rescore_and_select(bench_logits, bench)
    full = search.catalyst_search(glider, eater, full_grid, 64)
    example = search.catalyst_search(glider, eater, example_grid, 100)
    torch.cuda.synchronize()
    launches = dict(step_cuda.LAUNCHES)
    print(f"[path] main path ran in {time.perf_counter() - t0:.2f} s; "
          f"launches {launches}")
    check(all(launches[name] > 0 for name in MAIN_PATH_KERNELS),
          f"a kernel of the main path was never launched: {launches}")
    print(f"[path] soft-Life sweeps of the main path's gradient solves: {soft_cuda.LAUNCHES}, "
          f"their updates {solver_cuda.LAUNCHES}")
    check(soft_cuda.LAUNCHES["soft_objective"] > 0 and soft_cuda.LAUNCHES["soft_objective_vjp"] > 0
          and solver_cuda.LAUNCHES["adam_update"] > 0,
          f"the main path's solves never launched the objective's sweeps or adam's kernel: "
          f"{soft_cuda.LAUNCHES} {solver_cuda.LAUNCHES}")
    err = dict.fromkeys(MAIN_PATH_KERNELS, 0.0)

    # -- 3a. rollout ----------------------------------------------------------
    plain = step_cuda.rollout_plain(boards, HEADLINE_T)
    err["rollout"] = max_err(rolled, plain)
    check(torch.equal(rolled, plain), "rollout kernel != plain twin")
    g = oracle_run(boards[:64].cpu().numpy(), HEADLINE_T)
    check((oracle_dense(rolled[:64].cpu().numpy()) == g).all(),
          "rollout kernel != numpy oracle")
    ragged = B.random(gen, (1000,), device=dev)
    got, want = step_cuda.rollout(ragged, 37), step_cuda.rollout_plain(ragged, 37)
    err["rollout"] = max(err["rollout"], max_err(got, want))
    check(torch.equal(got, want), "ragged rollout kernel != plain twin")
    print(f"[rollout] B={HEADLINE_B} T={HEADLINE_T}: kernel == plain on all "
          f"boards, == numpy oracle on 64; ragged B=1000 T=37 kernel == plain")
    oracle_gate(boards, rolled)

    # -- 3b. MPC ----------------------------------------------------------------
    demo_ham = int(hamming_cost(demo_sol.final_board, demo.target))
    print(f"[mpc] demo: cost {float(demo_sol.cost)}, Hamming {demo_ham}, "
          f"{int((demo_sol.all_costs < 1).sum())}/16 candidates below 1")
    check(demo_ham == 0, f"MPC demo config missed the target: Hamming {demo_ham}")
    probs = torch.sigmoid(bench_logits) * bench.control_mask
    toggles = solver.candidate_toggles(probs, bench)
    starts = bench.initial.expand(64, 64).contiguous()
    finals_k = step_cuda.controlled_rollout(starts, toggles)
    finals_p = step_cuda.controlled_rollout_plain(starts, toggles)
    costs_k = solver.hard_cost(finals_k, toggles, bench)
    costs_p = solver.hard_cost(finals_p, toggles, bench)
    err["controlled_rollout"] = max_err(finals_k, finals_p)
    check(torch.equal(finals_k, finals_p), "controlled kernel != plain twin")
    check(torch.equal(costs_k, costs_p), "MPC hard costs: kernel != plain twin")
    check(torch.equal(costs_k, bench_sol.all_costs), "MPC rescoring is not reproducible")
    print(f"[mpc] bench: 64 hard costs kernel == plain; best {float(bench_sol.cost)}, "
          f"Hamming {int(hamming_cost(bench_sol.final_board, bench.target))}")

    # -- 3c. catalyst search ------------------------------------------------------
    full_cpu = search.catalyst_search(glider.cpu(), eater.cpu(), full_grid.cpu(), 64)
    for field in ("interacted", "recovered", "reaction_changed", "final"):
        check(torch.equal(getattr(full, field).cpu(), getattr(full_cpu, field)),
              f"catalyst search {field}: kernel != plain twin")
    inputs = search.rollout_inputs(glider, eater, full_grid, 64)
    final_k, inter_k = step_cuda.catalyst_rollout(*inputs)
    final_p, inter_p = step_cuda.catalyst_rollout_plain(*inputs)
    err["catalyst_rollout"] = max(max_err(final_k, final_p),
                                  float((inter_k != inter_p).any()))
    check(torch.equal(final_k, final_p) and torch.equal(inter_k, inter_p),
          "catalyst kernel != plain twin on the card")
    hits = int(search.successful_catalysts(full).sum())
    n_inter, n_rec = int(full.interacted.sum()), int(full.recovered.sum())
    example_hits = int(search.successful_catalysts(example).sum())
    print(f"[catalyst] 4096 offsets, horizon 64: {hits} hits, {n_inter} interacted, "
          f"{n_rec} recovered (kernel == plain); example grid, horizon 100: "
          f"{example_hits} hits")
    check((hits, n_inter, n_rec) == (16, 266, 3846), "catalyst counts differ from 16/266/3846")
    check(example_hits == 13, "example grid did not give 13 hits")
    print(f"[counters] {launches}")

    # -- 3d. LifeState on the card against the CPU ----------------------------------
    state_phase(dev)

    # -- 3e. the one device rule: no device means the card ---------------------------
    device_phase(dev)

    # -- 4. the still-life solver ------------------------------------------------
    stable_launches, stable_err, stable_inputs = stable_phase(dev)

    # -- 5. the convolution layer, matching, symmetry and calibration --------------
    conv_launches, conv_err, conv_inputs = conv_phase(dev)

    # -- 6. the weld / dense-stable path; kernel [4] ---------------------------------
    weld_launches, weld_err, weld_run = weld_phase(dev)
    launches["rollout_lohi"] = weld_launches["rollout_lohi"]
    err["rollout_lohi"] = weld_err["rollout_lohi"]

    # -- 7. timings ---------------------------------------------------------------
    ms, plain_ms, lib_ms, dev_ms = {}, {}, {}, {}
    ms["rollout"], plain_ms["rollout"] = paired_ms(
        lambda: step_cuda.rollout(boards, HEADLINE_T),
        lambda: step_cuda.rollout_plain(boards, HEADLINE_T), reps=5)
    ms["controlled_rollout"], plain_ms["controlled_rollout"] = paired_ms(
        lambda: step_cuda.controlled_rollout(starts, toggles),
        lambda: step_cuda.controlled_rollout_plain(starts, toggles), reps=10)
    ms["catalyst_rollout"], plain_ms["catalyst_rollout"] = paired_ms(
        lambda: step_cuda.catalyst_rollout(*inputs),
        lambda: step_cuda.catalyst_rollout_plain(*inputs), reps=10)
    dev_ms["controlled_rollout"] = device_ms_at(
        lambda: step_cuda.controlled_rollout(starts, toggles), "controlled_kernel",
        "controlled_rollout")
    dev_ms["catalyst_rollout"] = device_ms_at(lambda: step_cuda.catalyst_rollout(*inputs),
                                              "catalyst_kernel", "catalyst_rollout")
    steps = HEADLINE_B * HEADLINE_T
    print(f"[time] card: {card}")
    print(f"[time] rollout B={HEADLINE_B} T={HEADLINE_T}: kernel {ms['rollout']:.4f} ms "
          f"({steps / ms['rollout'] * 1e3:.4g} steps/s), plain {plain_ms['rollout']:.4f} ms "
          f"({steps / plain_ms['rollout'] * 1e3:.4g} steps/s)")
    for name, what in (("catalyst_rollout", "catalyst rollout 4096 offsets, horizon 64"),
                       ("controlled_rollout", "controlled rollout 64 candidates, horizon 32")):
        d, mhz = dev_ms[name]
        print(f"[time] {what}: kernel {ms[name]:.4f} ms a call ({d:.4f} ms of it on the "
              f"device, profiler, SM clock {mhz} MHz), plain {plain_ms[name]:.4f} ms"
              f"{before_redesign(name, d)}")
    # [2]'s device time against its horizon: the intercept is what a launch
    # costs whatever T is, the slope what one warp's generation costs
    sweep = {}
    for t in (0, 32, 128):
        tog_t = toggles[:1].expand(t, 64, 64).contiguous()
        sweep[t] = profiled_device_ms(lambda: step_cuda.controlled_rollout(starts, tog_t),
                                      "controlled_kernel", "controlled_rollout")
    per_gen_ns = (sweep[128] - sweep[32]) / 96 * 1e6
    mhz = dev_ms["controlled_rollout"][1]
    clocks = per_gen_ns * float(mhz) / 1e3 if mhz.isdigit() else float("nan")
    print(f"[time] controlled kernel, 64 boards, device time at T = 0 / 32 / 128: "
          + " / ".join(f"{v:.4f}" for v in sweep.values())
          + f" ms, so {per_gen_ns:.1f} ns a generation ({clocks:.0f} clocks at {mhz} MHz)")
    print(f"[time] catalyst rollout, 4096 offsets: {4096 / ms['catalyst_rollout'] * 1e3:.4g} "
          f"placements/s a call, {4096 / dev_ms['catalyst_rollout'][0] * 1e3:.4g} on the "
          f"device")
    search_med = wall(lambda: search.catalyst_search(glider, eater, full_grid, 64), 5)
    print(f"[time] catalyst_search end to end, 4096 offsets, horizon 64: median "
          f"{search_med * 1e3:.3f} ms ({4096 / search_med:.4g} placements/s) over 5")
    solve_s = []
    for seed in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(bench, torch.Generator().manual_seed(seed), n_candidates=64, iters=100)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t0)
    print(f"[time] MPC bench config (64 candidates, horizon 32, 100 iterations): "
          f"median {statistics.median(solve_s):.3f} s per solve over {len(solve_s)}")
    stable_timings(stable_inputs, ms, plain_ms, dev_ms, card)
    ceilings = conv_timings(conv_inputs, ms, plain_ms, lib_ms, dev_ms, card)
    weld_timings(weld_run, ms, plain_ms, dev_ms, card)
    bounds, sass = kernel_bounds(ceilings, stable_inputs, conv_inputs, ms, dev_ms, lib_path)
    roofline_phase(sass, dev_ms, card)
    entry_phase(dev, card)

    # -- 8. the MPC paths: SQP, receding horizon, symmetric, reachability -----------
    # after the kernel timings: their profiler traces keep fewer of a
    # kernel's launches in a process that has already traced these paths'
    # hundred-thousand-kernel calls
    sqp_s, sqp_counts = sqp_phase(dev, card)
    soft_err, soft_bounds = soft_phase(dev, card, ms, plain_ms, dev_ms)
    bounds.update(soft_bounds)
    update_err, update_bounds = update_phase(dev, card, ms, plain_ms, lib_ms, dev_ms)
    bounds.update(update_bounds)
    composed_counts = composed_phase(dev, card)
    mpc_times = {"sqp": sqp_s, "cem": cem_phase(dev, card),
                 "receding": receding_phase(dev, card), "symmetric": symmetric_phase(dev, card),
                 "reach": reach_phase(dev, card)}
    print(f"[mpc] SQP solve {mpc_times['sqp']:.3f} s, CEM solve {mpc_times['cem']:.3f} s, "
          f"run_fused {mpc_times['receding']:.3f} s "
          f"a replan round, D4 symmetric solve {mpc_times['symmetric']:.3f} s, reachability "
          f"{mpc_times['reach']:.4g} candidates/s ({card})")
    # -- 9. the sharded runners over NCCL (last: thousands of MPC kernels) ------------
    parallel_phase(dev, card)
    # -- 10. the dry run over every card, then the 224-instance sweep ------------------
    dryrun_phase(card)
    adversarial_phase(dev, card, stable_err)
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")

    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces[name],
         "launches": counts[name], "max_abs_err": errors[name],
         "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": lib_ms.get(name)}
        for source, replaces, counts, errors in (
            (ROLLOUT_SOURCE, REPLACES, launches, err),
            (STABLE_SOURCE, STABLE_REPLACES, stable_launches, stable_err),
            (CONV_SOURCE, CONV_REPLACES, conv_launches, conv_err),
            (CALIBRATE_SOURCE, CALIBRATE_REPLACES, conv_launches, conv_err),
            (SOFT_SOURCE, SOFT_REPLACES, composed_counts, soft_err),
            (SOFT_SOURCE, OBJECTIVE_REPLACES, sqp_counts, update_err),
            (SOLVER_SOURCE, UPDATE_REPLACES, sqp_counts, update_err))
        for name in replaces
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
