"""Receding-horizon MPC: solve, apply the first control slices on
the exact dynamics, re-solve from the new state.

Counterpart of :mod:`lifeapi_tpu.mpc.receding`.  The per-solve machinery
is mpc/solver.py.  Two loops:

* :func:`run` — the host loop: each round's cost is read back, and the
  elite is picked on the host.
* :func:`run_fused` — always warm-started, with every round's noise drawn
  up front: the loop never waits for the device (the elite's index stays a
  device tensor and its toggles are gathered on the device), so the host
  only queues work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import board as B
from ..core import step as S
from ..target import hamming_cost
from . import soft as soft_mod
from . import solver as solver_mod


class MPCRun(NamedTuple):
    boards: torch.Tensor  # int64[steps+1, 64] visited states
    applied: torch.Tensor  # int64[steps, 64] applied toggles
    costs: torch.Tensor  # float32[solves] hard cost of each solve's elite


def run(problem, generator, steps, apply_horizon=1, n_candidates=16,
        solve_iters=80, warm_start=True):
    """Drive the system ``steps`` generations, re-solving every
    ``apply_horizon`` applied control slices.  Each round's initial logits
    (or, warm-started, the fresh tail after the shift) are drawn from
    ``generator`` by ``solver.init_logits``.  Returns the visited
    trajectory, applied controls and per-solve costs."""
    boards = [problem.initial]
    applied = []
    costs = []
    cur = problem
    logits = None
    t = 0
    while t < steps:
        if logits is None or not warm_start:
            logits = solver_mod.init_logits(generator, cur, n_candidates)
        lg, _ = solver_mod.solve_gradient(logits, cur, iters=solve_iters)
        sol = solver_mod.rescore_and_select(lg, cur)
        costs.append(float(sol.cost))

        n_apply = min(apply_horizon, cur.horizon, steps - t)
        board = boards[-1]
        for i in range(n_apply):
            toggle = sol.controls[i]
            board = S.step(board ^ toggle)
            applied.append(toggle)
            boards.append(board)
        t += n_apply

        cur = cur._replace(initial=board)
        if warm_start:
            # shift the candidate controls by the applied steps; pad with
            # fresh noise at the tail
            tail = solver_mod.init_logits(generator, cur, lg.shape[0])[:, :n_apply]
            logits = torch.cat([lg[:, n_apply:], tail], dim=1)

    device = problem.initial.device
    return MPCRun(
        torch.stack(boards),
        torch.stack(applied) if applied else B.empty((0,), device),
        torch.tensor(costs, dtype=torch.float32, device=device),
    )


def final_error(run_result: MPCRun, target):
    return hamming_cost(run_result.boards[-1], target)


def run_fused(problem, generator, steps, apply_horizon=1, n_candidates=16,
              solve_iters=80):
    """Receding-horizon drive with no host sync in its loop (always
    warm-started).

    ``steps`` must be a multiple of ``apply_horizon``; the loop runs
    ``steps // apply_horizon`` replan rounds.  The initial logits and every
    round's tail noise ``[rounds, C, A, 64, 64]`` (``-3 + 0.5 * normal``,
    the distribution of ``init_logits``) are drawn from ``generator`` up
    front.  Each round:

    1. gradient solve from the current board (``solver.solve_gradient``),
    2. binarize every candidate, bit-exact rollout, integer-cost elite
       pick (``rescore_and_select`` semantics, on the device),
    3. apply the elite's first ``apply_horizon`` toggle slices on the
       exact dynamics,
    4. shift the candidate logits by the applied steps and append the
       round's tail.

    Returns an :class:`MPCRun` (boards ``[steps+1]``, applied toggles
    ``[steps]``, per-round elite costs ``[rounds]``).
    """
    if steps % apply_horizon != 0:
        raise ValueError("steps must be a multiple of apply_horizon")
    if apply_horizon > problem.horizon:
        raise ValueError("apply_horizon must not exceed the horizon")
    rounds = steps // apply_horizon
    logits0 = solver_mod.init_logits(generator, problem, n_candidates)
    shape = (rounds, n_candidates, apply_horizon, 64, 64)
    noise = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
    tails = (-3.0 + 0.5 * noise).to(problem.initial.device)
    return _run_fused(problem, logits0, tails, steps=steps,
                      apply_horizon=apply_horizon, solve_iters=solve_iters)


def _run_fused(problem, logits0, tails, *, steps, apply_horizon, solve_iters):
    """The loop of :func:`run_fused` from given initial logits and tails
    ``[rounds, C, apply_horizon, 64, 64]``."""
    A = apply_horizon
    board = problem.initial
    logits = logits0
    visited, applied, costs = [], [], []
    for r in range(steps // A):
        cur = problem._replace(initial=board)
        lg, _ = solver_mod.solve_gradient(logits, cur, iters=solve_iters)

        # hard rescore + elite pick (rescore_and_select, on the device)
        probs = torch.sigmoid(lg) * cur.control_mask
        all_costs, _ = solver_mod.hard_score_batch(probs, cur)
        best = torch.argmin(all_costs).view(1)
        toggles = soft_mod.binarize_controls(probs.index_select(0, best)[0])[:A]

        # apply the first A slices on the exact dynamics
        for tog in toggles:
            board = S.step(board ^ tog)
            visited.append(board)
        applied.append(toggles)
        costs.append(all_costs.index_select(0, best))

        # warm start: shift by A, the round's noise on the tail
        logits = torch.cat([lg[:, A:], tails[r]], dim=1)

    if not visited:
        return MPCRun(problem.initial[None], B.empty((0,), board.device),
                      torch.zeros(0, dtype=torch.float32, device=board.device))
    return MPCRun(torch.stack([problem.initial] + visited), torch.cat(applied),
                  torch.cat(costs))
