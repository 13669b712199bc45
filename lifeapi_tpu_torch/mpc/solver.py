"""MPC / trajectory-optimization engine over Life dynamics.

Counterpart of :mod:`lifeapi_tpu.mpc.solver`.  Solves: find per-step
cell-toggle controls (restricted to a control mask) that steer the 64x64
torus from an initial board to a LifeTarget at the horizon, optionally
preserving a protected still-life background, under a control-effort
penalty.

* :func:`solve_gradient` — batched adam on control logits with
  temperature annealing, over the soft-Life relaxation (mpc/soft.py).
* :func:`solve_sqp` — sequential quadratic steps: damped Newton where each
  QP block (H + lam I) d = -g is solved by conjugate gradients, with
  Hessian-vector products by double backward.
* :func:`solve_cem` — derivative-free cross-entropy method scoring
  candidates on the exact path only.

All finish on the exact path: :func:`hard_score_batch` re-simulates every
candidate with the controlled-rollout kernel (ops/step_cuda.py) on a CUDA
problem, so reported costs are true integer Hamming costs, never relaxed
ones.  Candidates are a leading batch dimension throughout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import board as B
from ..ops import step_cuda
from ..target import LifeTarget
from . import cost as cost_mod
from . import soft as soft_mod

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
CG_TOL = 1e-5  # jax.scipy.sparse.linalg.cg's default relative tolerance


class MPCProblem(NamedTuple):
    initial: torch.Tensor  # board int64[64]
    target: LifeTarget
    horizon: int
    control_mask: torch.Tensor  # dense bool[64, 64] of allowed toggle cells
    protected: Optional[torch.Tensor] = None  # dense bool[64, 64]
    background: Optional[torch.Tensor] = None  # board, intended protected state
    weights: cost_mod.CostWeights = cost_mod.CostWeights()
    tau: float = 0.25


class MPCSolution(NamedTuple):
    controls: torch.Tensor  # toggles int64[T, 64] of the best candidate
    control_probs: torch.Tensor  # [T, 64, 64] relaxed controls of the best
    final_board: torch.Tensor  # board after the hard rollout
    cost: torch.Tensor  # hard cost of the best candidate
    all_costs: torch.Tensor  # [C] hard costs of every candidate


def soft_objective(logits, problem: MPCProblem, tau=None):
    """Relaxed cost of control logits [..., T, 64, 64], one per leading
    index (each candidate's cost depends on its own logits only)."""
    tau = problem.tau if tau is None else tau
    controls = torch.sigmoid(logits) * problem.control_mask
    controls = controls.movedim(-3, 0)  # generation-major for the rollout
    p0 = B.to_dense(problem.initial).to(torch.float32)
    p_final, traj = soft_mod.soft_rollout(p0, controls, tau=tau)
    return cost_mod.soft_total(
        p_final, traj, controls, problem.target, problem.protected,
        problem.weights,
    )


def candidate_toggles(control_probs, problem: MPCProblem):
    """Probabilities [C, T, 64, 64] -> binarized toggles int64[T, C, 64],
    generation-major as the controlled-rollout kernel reads them."""
    toggles = soft_mod.binarize_controls(control_probs * problem.control_mask)
    return toggles.transpose(0, 1).contiguous()


def hard_cost(finals, toggles, problem: MPCProblem):
    """Exact costs of finals int64[C, 64] reached with toggles [T, C, 64]."""
    protected = (
        None if problem.protected is None else B.from_dense(problem.protected)
    )
    background = (
        problem.background if problem.background is not None else problem.initial
    )
    return cost_mod.hard_total(
        finals, toggles, problem.target, protected, background, problem.weights
    )


def hard_score_batch(control_probs, problem: MPCProblem):
    """Exact costs of a batch of binarized control candidates
    [C, T, 64, 64] -> (costs float32[C], finals int64[C, 64]).  On a CUDA
    problem the rollout is the controlled-rollout kernel."""
    toggles = candidate_toggles(control_probs, problem)
    boards = problem.initial.expand(toggles.shape[1], 64).contiguous()
    finals = step_cuda.controlled_rollout(boards, toggles)
    return hard_cost(finals, toggles, problem), finals


def hard_score(control_probs, problem: MPCProblem):
    """Exact cost of one candidate's binarized controls [T, 64, 64] ->
    (cost, final board)."""
    costs, finals = hard_score_batch(control_probs[None], problem)
    return costs[0], finals[0]


def init_logits(generator, problem: MPCProblem, n_candidates, scale=0.5,
                bias=-3.0):
    """Initial logits [C, T, 64, 64], drawn on the generator's device and
    moved to the problem's, so one seed gives the same start everywhere."""
    shape = (n_candidates, problem.horizon, 64, 64)
    noise = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
    return (bias + scale * noise).to(problem.initial.device)


def adam_init(logits):
    """Adam state for ``logits``: the step count and the two moments."""
    return 0, torch.zeros_like(logits), torch.zeros_like(logits)


def adam_update(logits, grads, state, lr):
    """One adam step with optax's numerics (``optax.adam``: bias-corrected
    moments, eps outside the square root).  Returns (logits, state)."""
    count, mu, nu = state
    count += 1
    mu = (1 - ADAM_B1) * grads + ADAM_B1 * mu
    nu = (1 - ADAM_B2) * grads * grads + ADAM_B2 * nu
    mu_hat = mu / (1 - ADAM_B1 ** count)
    nu_hat = nu / (1 - ADAM_B2 ** count)
    logits = logits - lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
    return logits, (count, mu, nu)


def value_and_grad(objective, logits):
    """``objective(logits)`` (one value per leading index) and the
    gradient of its sum, both detached."""
    x = logits.detach().requires_grad_(True)
    vals = objective(x)
    (grads,) = torch.autograd.grad(vals.sum(), x)
    return vals.detach(), grads


def grad_and_hvp(objective, logits):
    """``objective(logits)`` (one value per leading index), the gradient
    of its sum, both detached, and ``hvp(v)``, the Hessian of the sum times
    ``v`` by double backward.  The graph lives as long as ``hvp``."""
    x = logits.detach().requires_grad_(True)
    vals = objective(x)
    (g,) = torch.autograd.grad(vals.sum(), x, create_graph=True)

    def hvp(v):
        (hv,) = torch.autograd.grad(g, x, v, retain_graph=True)
        return hv

    return vals.detach(), g.detach(), hvp


def solve_gradient(logits0, problem: MPCProblem, iters=150, lr=0.15,
                   tau_start=0.6, tau_end=0.15):
    """First-order batched solve.  logits0: [C, T, 64, 64]; iters >= 1.
    Returns (logits, history [iters, C] of soft costs)."""
    logits = logits0.detach()
    state = adam_init(logits)
    history = []
    for i in range(iters):
        frac = i / max(iters - 1, 1)
        tau = tau_start * (tau_end / tau_start) ** frac
        vals, grads = value_and_grad(lambda x: soft_objective(x, problem, tau), logits)
        history.append(vals)
        logits, state = adam_update(logits, grads, state, lr)
    return logits, torch.stack(history)


def _dot(a, b):
    """Per-candidate dot product over every dimension but the first."""
    return (a * b).flatten(1).sum(dim=1)


def conjugate_gradients(matvec, b, maxiter):
    """Solve ``matvec(x) = b`` for a batch of independent symmetric
    positive-definite systems, one per leading index, as
    ``jax.vmap(jax.scipy.sparse.linalg.cg)`` does at its defaults: x0 = 0,
    each system stops once ``<r, r> <= CG_TOL**2 <b, b>`` or after
    ``maxiter`` iterations.  ``matvec`` maps the batch to the batch, each
    system's product depending on its own slice only.

    Under ``vmap`` JAX loops while any system is active and freezes the
    converged ones.  Here every one of the ``maxiter`` iterations runs and
    ``torch.where`` keeps a converged system's state: a mask multiplied in
    would carry a converged system's 0/0 into its result, and the loop
    reads nothing back to the host."""
    stop = CG_TOL ** 2 * _dot(b, b)
    x = torch.zeros_like(b)
    r = b  # b - matvec(x0), and matvec(0) = 0
    p = r
    gamma = _dot(r, r)
    view = (-1,) + (1,) * (b.dim() - 1)
    for _ in range(maxiter):
        active = gamma > stop
        ap = matvec(p)
        alpha = (gamma / _dot(p, ap)).view(view)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        gamma_new = _dot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma).view(view) * p
        a = active.view(view)
        x = torch.where(a, x_new, x)
        r = torch.where(a, r_new, r)
        p = torch.where(a, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


STEP_SIZES = (1.0, 0.5, 0.25)


def solve_sqp(logits0, problem: MPCProblem, iters=8, cg_iters=12, damping=1.0):
    """Damped Newton / SQP on the relaxed objective at ``problem.tau``:
    each step solves the QP block (H + lam I) d = -g by conjugate
    gradients, lam = damping * 0.5**i, with Hessian-vector products by
    double backward, then takes the best of the step sizes 1, 1/2, 1/4
    where it beats the current cost.

    logits0: [C, T, 64, 64]; each candidate is solved independently: the
    objective of the sum over candidates has a block-diagonal Hessian, so
    one product of the batch is every candidate's."""
    def f(lg):
        return soft_objective(lg, problem)

    lg = logits0.detach()
    c = lg.shape[0]
    for i in range(iters):
        lam = damping * 0.5 ** i
        f0, g, hvp = grad_and_hvp(f, lg)
        d = conjugate_gradients(lambda v: hvp(v) + lam * v, -g, cg_iters)
        del hvp  # frees the double-backward graph
        with torch.no_grad():
            cands = torch.stack([lg + a * d for a in STEP_SIZES])
            costs = f(cands.flatten(0, 1)).view(len(STEP_SIZES), c)
            best = torch.argmin(costs, dim=0)
            pick = torch.arange(c, device=best.device)
            improved = costs[best, pick] < f0
            lg = torch.where(improved.view(-1, 1, 1, 1), cands[best, pick], lg)
    return lg


def rescore_and_select(logits, problem: MPCProblem):
    """Binarize every candidate, hard-simulate, pick the elite."""
    probs = torch.sigmoid(logits) * problem.control_mask
    costs, finals = hard_score_batch(probs, problem)
    best = int(torch.argmin(costs))
    return MPCSolution(
        controls=soft_mod.binarize_controls(probs[best]),
        control_probs=probs[best],
        final_board=finals[best],
        cost=costs[best],
        all_costs=costs,
    )


def solve(problem: MPCProblem, generator, n_candidates=32, method="gradient",
          iters=150, **kwargs):
    """End-to-end single-device solve: init -> optimize -> hard rescore.
    ``method="sqp"`` warms up with ``max(iters // 3, 10)`` gradient
    iterations at their defaults, then runs :func:`solve_sqp` with
    ``kwargs``."""
    if method not in ("gradient", "sqp"):
        raise ValueError(f"unknown method {method!r}")
    logits0 = init_logits(generator, problem, n_candidates)
    if method == "gradient":
        logits, _ = solve_gradient(logits0, problem, iters=iters, **kwargs)
    else:
        logits, _ = solve_gradient(logits0, problem, iters=max(iters // 3, 10))
        logits = solve_sqp(logits, problem, **kwargs)
    return rescore_and_select(logits, problem)


def solve_cem(problem: MPCProblem, generator, pop=256, iters=20, elites=16,
              init_p=0.03, smoothing=0.7, mean0=None):
    """Cross-entropy method on the exact path: sample toggle masks, score
    with the bit-exact rollout, refit toggle probabilities to the elite
    set.  ``mean0`` seeds the sampling distribution (e.g. from a gradient
    solve).  Samples are drawn on the generator's device.  Returns
    (mean_probs [T, 64, 64], best_cost, best_controls, history [iters])."""
    T = problem.horizon
    mask = problem.control_mask
    device = problem.initial.device
    if mean0 is None:
        mean = torch.full((T, 64, 64), init_p, device=device) * mask
    else:
        mean = torch.clamp(mean0 * mask, 1e-4, 1 - 1e-4)
    best_cost = torch.tensor(float("inf"), device=device)
    best_sample = torch.zeros((T, 64, 64), dtype=torch.bool, device=device)
    history = []
    for _ in range(iters):
        u = torch.rand((pop, T, 64, 64), generator=generator,
                       device=generator.device).to(device)
        samples = (u < mean) & mask
        costs, _ = hard_score_batch(samples.to(torch.float32), problem)
        order = torch.argsort(costs, stable=True)
        elite = samples[order[:elites]].to(torch.float32)
        mean = smoothing * mean + (1 - smoothing) * elite.mean(dim=0)
        mean = torch.clamp(mean, 1e-4, 1 - 1e-4)
        run_best = costs[order[0]]
        better = run_best < best_cost
        best_cost = torch.where(better, run_best, best_cost)
        best_sample = torch.where(better, samples[order[0]], best_sample)
        history.append(run_best)
    return mean, best_cost, best_sample, torch.stack(history)
