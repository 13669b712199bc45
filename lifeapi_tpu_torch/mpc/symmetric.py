"""Symmetry-constrained MPC search: control sequences constrained to a
symmetry orbit (C2/D4/... via symmetry/groups), with batched still-life
constraint propagation scoring background feasibility of every candidate.

Counterpart of :mod:`lifeapi_tpu.mpc.symmetric`.
"""

from __future__ import annotations

import torch

from ..core import board as B
from ..ops import stable_cuda
from ..stable import bitplane as BP
from ..symmetry import groups as groups_mod
from ..symmetry import transforms as tr
from . import soft as soft_mod
from . import solver as solver_mod


def orbit_symmetrize(dense, sym):
    """Average a dense [..., 64, 64] field over the group orbit — the
    projection onto the symmetric subspace.  Gradients flow through all
    cosets, so optimizing symmetrized logits IS optimization in the
    quotient space."""
    cosets = groups_mod.GROUPS[groups_mod.StaticSymmetry(sym)]
    acc = None
    for t in cosets:
        img = tr.transform_dense(dense, t)
        acc = img if acc is None else acc + img
    return acc / len(cosets)


def symmetric_objective(logits, problem, sym, tau=None):
    """Relaxed cost of orbit-symmetrized control logits [..., T, 64, 64]."""
    return solver_mod.soft_objective(orbit_symmetrize(logits, sym), problem, tau)


def stable_consistency(final_board, region_mask):
    """Batched still-life feasibility: cells of ``region_mask`` (dense
    bool[64, 64]) are taken as known (from the final boards
    int64[..., 64]), everything else unknown; returns the per-board
    consistency bool of the propagation fixpoint.

    On a CUDA board it is one launch of kernel B
    (``ops.stable_cuda.propagate_fused``, whose contract is
    ``bitplane.propagate``'s), with no readback; on a CPU board it is
    :func:`stable_consistency_plain`."""
    if not final_board.is_cuda:
        return stable_consistency_plain(final_board, region_mask)
    return stable_cuda.propagate_fused(_region_stable(final_board, region_mask)).consistent


def stable_consistency_plain(final_board, region_mask):
    """:func:`stable_consistency` by ``bitplane.propagate`` on any
    device."""
    return BP.propagate(_region_stable(final_board, region_mask)).consistent


def _region_stable(final_board, region_mask):
    region = B.from_dense(region_mask.to(torch.bool)).expand(final_board.shape)
    return BP.make(state=final_board & region, unknown=~region)


def _optimize(logits0, problem, sym, iters, lr):
    """Adam (optax's numerics, ``solver.adam_update``) on the symmetric
    objective at ``problem.tau``."""
    logits = logits0.detach()
    state = solver_mod.adam_init(logits)
    for _ in range(iters):
        _, grads = solver_mod.value_and_grad(
            lambda x: symmetric_objective(x, problem, sym), logits)
        logits, state = solver_mod.adam_update(logits, grads, state, lr)
    return logits


def solve_symmetric(problem, generator, sym, n_candidates=16, iters=120, lr=0.15,
                    stable_region=None, infeasible_penalty=1e4):
    """End-to-end symmetric solve: optimize orbit-symmetrized logits, then
    hard-rescore every candidate bit-exactly (the controlled-rollout kernel
    on a CUDA problem); candidates whose final board fails the stable
    propagation on ``stable_region`` are penalized out of the elite
    selection (one :func:`stable_consistency` over all final boards)."""
    logits0 = solver_mod.init_logits(generator, problem, n_candidates)
    logits = _optimize(logits0, problem, sym, iters, lr)

    probs = torch.sigmoid(orbit_symmetrize(logits, sym)) * problem.control_mask
    costs, finals = solver_mod.hard_score_batch(probs, problem)
    if stable_region is not None:
        ok = stable_consistency(finals, stable_region)
        costs = costs + torch.where(ok, 0.0, float(infeasible_penalty))
    best = int(torch.argmin(costs))
    return solver_mod.MPCSolution(
        controls=soft_mod.binarize_controls(probs[best]),
        control_probs=probs[best],
        final_board=finals[best],
        cost=costs[best],
        all_costs=costs,
    )
