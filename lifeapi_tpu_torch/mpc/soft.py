"""Differentiable soft-Life dynamics for trajectory optimization.

Counterpart of :mod:`lifeapi_tpu.mpc.soft`.  The exact bitboard update
(B3/S23 over CSA counts) is relaxed to a smooth map on cell probabilities
so control sequences can be optimized by gradients, while the hard binary
path (the bit-exact step) re-simulates and scores candidates.

Dynamics: p' = p * survive(count) + (1 - p) * birth(count), where count is
the expected live-neighbour count (3x3 sum minus center) and the gates are
sigmoid windows around [2, 3] and {3} that sharpen to the exact rule as the
temperature tau -> 0.  Controls are per-step cell toggle probabilities
applied as a smooth XOR.

The rollout and its derivatives are the fused sweeps of
:mod:`lifeapi_tpu_torch.ops.soft_cuda` (one CUDA launch each on the card,
their plain twins on the CPU), which also holds the per-generation map
re-exported here.  :func:`soft_rollout` wraps them in autograd Functions
whose backward is a sweep too, so a gradient and a Hessian-vector product by
double backward stay a few launches, whatever the horizon.  Unlike JAX's
``scan``, which differentiates to any order, the rollout differentiates
twice: a third derivative raises.  Memory: the
rollout keeps its trajectory for the backward, and a VJP kept for a double
backward its adjoints, one ``[T, C, 64, 64]`` float32 array each; the JAX
rollout rematerialises each step instead.
"""

from __future__ import annotations

import torch

from ..core import board as B
from ..core import step as S
from ..ops import soft_cuda
from ..ops.soft_cuda import neighbour_sum, soft_gates, soft_step, soft_toggle  # noqa: F401


class SoftRollout(torch.autograd.Function):
    """``traj`` ``[T, *batch, 64, 64]`` of the controlled soft rollout.  Its
    backward is :class:`SoftRolloutVJP`, so a graph built through it (a
    gradient under ``create_graph=True``) differentiates again."""

    @staticmethod
    def forward(ctx, p0, controls, tau):
        traj = soft_cuda.rollout(p0, controls, tau)
        ctx.save_for_backward(p0, controls, traj)
        ctx.tau = tau
        return traj

    @staticmethod
    def backward(ctx, g_traj):
        p0, controls, traj = ctx.saved_tensors
        g_u, g_p0 = SoftRolloutVJP.apply(p0, controls, traj, g_traj, ctx.tau,
                                         ctx.needs_input_grad[0])
        return g_p0, g_u, None


class SoftRolloutVJP(torch.autograd.Function):
    """(the cotangent of the controls, of ``p0`` or None) from ``g_traj``.
    It takes ``traj`` as an input: its backward returns the partials with
    the states held fixed, and the states' own dependence on the controls
    reaches them through :class:`SoftRollout` again, along with the cost's
    curvature.  That backward, the HVP sweep, is differentiable once only:
    a third derivative through :func:`soft_rollout` raises (each further
    order would need a sweep of its own, and no caller takes one)."""

    @staticmethod
    def forward(ctx, p0, controls, traj, g_traj, tau, want_p0):
        g_u, g_p0, lam = soft_cuda.rollout_vjp(p0, controls, traj, g_traj, tau, want_p0)
        ctx.save_for_backward(p0, controls, traj, lam)
        ctx.tau = tau
        ctx.set_materialize_grads(False)
        return (soft_cuda.sum_over_batch(g_u, controls.shape),
                g_p0.sum_to_size(p0.shape) if want_p0 else None)

    @staticmethod
    def backward(ctx, w_u, w_p0):
        p0, controls, traj, lam = ctx.saved_tensors
        with torch.no_grad():
            w = torch.zeros_like(controls) if w_u is None else w_u
            jw, pu, px, px0 = soft_cuda.rollout_hvp(
                p0, controls, traj, lam, soft_cuda.over_batch(w, traj.shape[1:-2]), w_p0,
                ctx.tau, ctx.needs_input_grad[0])
            grads = (None if px0 is None else px0.sum_to_size(p0.shape),
                     soft_cuda.sum_over_batch(pu, controls.shape), px, jw)
        return (*_differentiable_no_further(grads, (p0, controls, traj, lam, w_u, w_p0)),
                None, None)


class _ThirdDerivative(torch.autograd.Function):
    """Aliases of the HVP sweep's first ``n`` tensors on a node that raises
    when differentiated.  The tensors after them, the sweep's inputs that
    need a gradient, tie the node to the graph, so that a derivative
    through the aliases reaches it."""

    @staticmethod
    def forward(ctx, n, *tensors):
        return tuple(t.view_as(t) for t in tensors[:n])

    @staticmethod
    def backward(ctx, *_):
        raise RuntimeError("soft_rollout differentiates twice at most: its second derivative, "
                           "the HVP sweep, has no derivative of its own")


def _differentiable_no_further(grads, inputs):
    """``grads`` as they are, or, where the backward builds a graph
    (``create_graph``) and any input of it needs a gradient, aliases on a
    node that raises when differentiated: the sweep's outputs carry no
    graph, and a graph of the twin would miss the adjoints' dependence on
    the controls, so a third derivative would come out silently wrong.
    (``once_differentiable`` raises only where the incoming cotangents
    themselves need a gradient, which an HVP's direction does not.)"""
    needs = [t for t in inputs if t is not None and t.requires_grad]
    if not torch.is_grad_enabled() or not needs:
        return grads
    given = [g for g in grads if g is not None]
    raising = iter(_ThirdDerivative.apply(len(given), *given, *needs))
    return tuple(None if g is None else next(raising) for g in grads)


def soft_rollout(p0, controls, tau=0.2):
    """Roll the horizon: at each step apply the control toggles, then the
    soft dynamics.  controls: [T, ..., 64, 64] toggle probabilities.
    Returns (final p, trajectory [T, ...]).

    Runs the fused sweeps, which implement this module's ``soft_toggle``
    and ``soft_step``.  Where either has been replaced (``bench_torch/
    control.py`` rounds every generation to bfloat16 that way), the
    replacement is looped eagerly instead, under plain autograd."""
    if soft_step is not soft_cuda.soft_step or soft_toggle is not soft_cuda.soft_toggle:
        p, traj = p0, []
        for u in controls:
            p = soft_step(soft_toggle(p, u), tau)
            traj.append(p)
        return p, torch.stack(traj)
    traj = SoftRollout.apply(p0, controls, tau)
    return traj[-1], traj


def hard_rollout(board0, toggles):
    """Exact binary counterpart on boards: XOR the binarized toggle mask,
    then the bit-exact step — used to score candidates.  toggles:
    int64[T, ..., 64]."""
    b = board0
    for t in toggles:
        b = S.step(b ^ t)
    return b


def binarize_controls(control_probs):
    """Toggle probabilities [..., 64, 64] -> toggle masks int64[..., 64]
    (u > 0.5)."""
    return B.from_dense(control_probs > 0.5)
