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

The JAX rollout rematerialises each step in the backward pass to save
memory; here autograd keeps every step's activations, which at 64
candidates and horizon 32 is a few hundred MB.
"""

from __future__ import annotations

import torch

from ..core import board as B
from ..core import step as S


def neighbour_sum(p):
    """Expected live neighbours (center excluded), float [..., 64, 64]."""
    v = p + torch.roll(p, 1, dims=-1) + torch.roll(p, -1, dims=-1)
    total = v + torch.roll(v, 1, dims=-2) + torch.roll(v, -1, dims=-2)
    return total - p


def soft_gates(count, tau):
    """(survive, birth) gate values for a neighbour count."""
    sig = torch.sigmoid
    survive = sig((count - 1.5) / tau) * sig((3.5 - count) / tau)
    birth = sig((count - 2.5) / tau) * sig((3.5 - count) / tau)
    return survive, birth


def soft_step(p, tau=0.2):
    """One soft-Life generation on probabilities [..., 64, 64]."""
    count = neighbour_sum(p)
    survive, birth = soft_gates(count, tau)
    return p * survive + (1.0 - p) * birth


def soft_toggle(p, u):
    """Smooth XOR: toggle each cell with probability u."""
    return p * (1.0 - u) + (1.0 - p) * u


def soft_rollout(p0, controls, tau=0.2):
    """Roll the horizon: at each step apply the control toggles, then the
    soft dynamics.  controls: [T, ..., 64, 64] toggle probabilities.
    Returns (final p, trajectory [T, ...])."""
    p = p0
    traj = []
    for u in controls:
        p = soft_step(soft_toggle(p, u), tau)
        traj.append(p)
    return p, torch.stack(traj)


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
