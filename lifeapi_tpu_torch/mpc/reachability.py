"""Reachability pruning over stable-unknown backgrounds.

Counterpart of :mod:`lifeapi_tpu.mpc.reachability`.  The options-refined
ternary step (stable/bitplane.step_ternary_tracked) rolls a board whose
unknown cells are stable unknowns forward as a three-state interval.  This
module turns those intervals into SOUND cost bounds for MPC / catalyst
search: a candidate whose lower Hamming bound at the horizon already
exceeds the incumbent provably cannot reach the target under ANY
completion of the stable background — prune it before paying for exact
per-completion rollouts.
"""

from __future__ import annotations

from ..core import board as B
from ..stable import bitplane as BP


def refined_rollout(cur_state, cur_unknown, stable: BP.BitStable, steps):
    """Roll the TRACKED options-refined ternary step ``steps`` generations.
    Returns (on, unknown, tracking) planes: cells in ``on`` are ON in EVERY
    completion of the stable background, cells outside ``on | unknown`` are
    OFF in every completion.

    The tracked step (stable/bitplane.step_ternary_tracked) carries a
    per-cell tracking mask and widens neighbour-count intervals for free
    unknowns, so every multi-step claim stays sound once a known cell is
    demoted to unknown mid-rollout; its ``keep`` output prevents most
    demotions in stable regions."""
    s, u = cur_state, cur_unknown
    tr = BP.initial_tracking(s, u, stable)
    for _ in range(steps):
        s, u, tr = BP.step_ternary_tracked(s, u, tr, stable)
    return s, u, tr


def hamming_bounds(on, unknown, target):
    """Sound lower/upper bounds on the Hamming cost of a three-state
    board against a LifeTarget: mismatches certain to occur vs
    mismatches that could occur."""
    definitely_on = on
    definitely_off = ~on & ~unknown
    lower = (B.population(target.wanted & definitely_off)
             + B.population(target.unwanted & definitely_on))
    upper = (B.population(target.wanted & ~definitely_on)
             + B.population(target.unwanted & ~definitely_off))
    return lower, upper


def prune_candidates(initials, stable: BP.BitStable, target, steps, max_cost):
    """Batched reachability prefilter: for each candidate initial board
    (active pattern over the SAME partially-unknown stable background),
    interval-roll ``steps`` generations and keep only candidates whose
    lower Hamming bound can still beat ``max_cost``.

    ``initials``: boards int64[C, 64] (unknown cells at their stable
    values); ``stable``: the (propagated) background knowledge, unbatched,
    broadcast to the candidates without a copy.  Returns
    (keep bool[C], lower[C], upper[C])."""
    shape = initials.shape
    st_b = BP.BitStable(stable.state.expand(shape), stable.unknown.expand(shape),
                        tuple(r.expand(shape) for r in stable.ruled))
    on, unk, _ = refined_rollout(initials, st_b.unknown, st_b, steps)
    lower, upper = hamming_bounds(on, unk, target)
    return lower <= max_cost, lower, upper
