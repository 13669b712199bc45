"""Cost heads for the MPC engine.

Counterpart of :mod:`lifeapi_tpu.mpc.cost`.  Hamming distance to a
LifeTarget is the primary cost; the LifeStable background constraint and
control effort enter as penalties.  All costs exist in a soft
(differentiable, on probabilities) and a hard (exact, on boards) form.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import board as B
from ..target import LifeTarget, hamming_cost


class CostWeights(NamedTuple):
    target: float = 1.0
    control: float = 0.01
    stable: float = 0.5
    # weight on the MEAN per-step target cost along the trajectory; > 0
    # rewards reaching (and holding) the target early
    path: float = 0.0


def soft_target_cost(p, target: LifeTarget):
    """Expected Hamming violation at a probability board."""
    wanted = B.to_dense(target.wanted).to(p.dtype)
    unwanted = B.to_dense(target.unwanted).to(p.dtype)
    return torch.sum(wanted * (1.0 - p) + unwanted * p, dim=(-2, -1))


def soft_target_cost_any_time(traj, target: LifeTarget, tau=0.5):
    """Soft-min over the horizon of the per-step target cost.
    traj: [T, ..., 64, 64]."""
    per_step = soft_target_cost(traj, target)  # [T, ...]
    return -tau * torch.logsumexp(-per_step / tau, dim=0)


def hard_target_cost_any_time(board_traj, target: LifeTarget):
    """Exact min over a trajectory int64[T, ..., 64]."""
    return hamming_cost(board_traj, target).min(dim=0).values


def soft_control_cost(controls):
    """L1 effort on toggle probabilities [T, ..., 64, 64], summed over
    horizon and cells."""
    return torch.sum(controls, dim=(0, -2, -1))


def soft_stable_cost(traj, protected):
    """Penalty for disturbing a protected (still-life background) region:
    total probability mass of deviation from the initial configuration over
    the trajectory.  protected: a board (int64[..., 64]) or a dense mask
    [..., 64, 64]; traj: [T, ..., 64, 64] with traj[0] the background."""
    mask = B.to_dense(protected) if protected.dtype == B.WORD else protected
    mask = mask.to(traj.dtype)
    dev = torch.abs(traj - traj[:1])
    return torch.sum(dev * mask, dim=(0, -2, -1))


def soft_total(p_final, traj, controls, target, protected, w: CostWeights):
    c = w.target * soft_target_cost(p_final, target)
    c = c + w.control * soft_control_cost(controls)
    c = c + w.path * torch.mean(soft_target_cost(traj, target), dim=0)
    if protected is not None:
        c = c + w.stable * soft_stable_cost(traj, protected)
    return c


def hard_total(board_final, toggles, target, protected_board, background,
               w: CostWeights):
    """Exact integer-valued counterpart used to score binarized candidates.
    ``toggles``: int64[T, ..., 64]; ``background``: board of the protected
    region's intended state."""
    c = w.target * hamming_cost(board_final, target).to(torch.float32)
    c = c + w.control * B.population(toggles).sum(dim=0).to(torch.float32)
    if protected_board is not None:
        dev = (board_final ^ background) & protected_board
        c = c + w.stable * B.population(dev).to(torch.float32)
    return c
