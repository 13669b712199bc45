"""Batched catalyst / placement search.

Counterpart of :mod:`lifeapi_tpu.search`.  Place a candidate catalyst near
an active reaction, step, and keep placements where the catalyst perturbs
the reaction and then recovers.  Interaction prediction prunes the
placement grid first (:func:`candidate_offsets`); then all placements
advance together as one batch through the catalyst-rollout kernel
(ops/step_cuda.py) on a CUDA board, or its plain twin on a CPU board.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .core import board as B
from .core import convolve as conv
from .core import step as S
from .ops import step_cuda
from .symmetry import orbits
from .symmetry import transforms as tr
from .target import LifeTarget


class PlacementResult(NamedTuple):
    offsets: torch.Tensor  # int[P, 2] candidate (dx, dy)
    interacted: torch.Tensor  # bool[P] catalyst was perturbed at some point
    recovered: torch.Tensor  # bool[P] catalyst present again at the end
    reaction_changed: torch.Tensor  # bool[P] the reaction differs from baseline
    final: torch.Tensor  # int64[P, 64] final boards


def candidate_offsets(active, catalyst, search_area=None):
    """Offsets worth trying: all translations inside ``search_area`` (default
    the whole board) that do NOT interact with the active pattern at
    generation 0 (immediate collisions are useless; reference search
    programs mask them with InteractionOffsets, LifeAPI.hpp:1066).
    Returns ``int64[P, 2]`` (dx, dy) in lexicographic order."""
    immediate = conv.interaction_offsets(active, catalyst)
    area = B.full(device=active.device) if search_area is None else search_area
    return torch.nonzero(B.to_dense(area & ~immediate))


def _place(pattern, offsets):
    """The pattern moved by each (dx, dy) of ``offsets`` -> int64[P, 64]."""
    P = offsets.shape[0]
    return B.move_dyn(pattern.expand(P, 64), offsets[:, 0], offsets[:, 1])


def rollout_inputs(active, catalyst, offsets, horizon):
    """What the catalyst rollout takes for this search: (boards, placed,
    placed_zoi, base_traj), with ``base_traj`` the placement-independent
    baseline reaction after each of the ``horizon`` generations."""
    placed = _place(catalyst, offsets).contiguous()
    boards = placed | active
    return boards, placed, B.zoi(placed), S.stepped_trajectory(active, horizon)


def catalyst_search(active, catalyst, offsets, horizon, recovery_target=None):
    """Try every placement: roll the union forward, require the catalyst to
    interact within the horizon and be recovered at the end.

    active, catalyst: boards int64[64]; offsets: int[P, 2].  Returns a
    :class:`PlacementResult`."""
    if recovery_target is None:
        recovery_target = LifeTarget.from_state(catalyst)
    boards, placed, placed_zoi, base_traj = rollout_inputs(
        active, catalyst, offsets, horizon)
    final, interacted = step_cuda.catalyst_rollout(
        boards, placed, placed_zoi, base_traj)
    base_final = base_traj[-1] if horizon > 0 else active

    target_wanted = _place(recovery_target.wanted, offsets)
    target_unwanted = _place(recovery_target.unwanted, offsets)
    # recovered: wanted cells ON, unwanted OFF at the end
    missing = target_wanted & ~final
    spurious = target_unwanted & final
    recovered = B.is_empty(missing) & B.is_empty(spurious)
    reaction_changed = ~B.equal(final & ~target_wanted, base_final & ~target_wanted)
    return PlacementResult(offsets, interacted, recovered, reaction_changed, final)


def successful_catalysts(result: PlacementResult):
    """Placements that interacted AND recovered — the search hits."""
    return result.interacted & result.recovered


def catalyst_search_all_orientations(active, catalyst, offsets, horizon,
                                     recovery_target=None):
    """Sweep every distinct D8 orientation of the catalyst (its symmetry
    orbit representatives) over the placement grid; returns a list of
    (transform, :class:`PlacementResult`) pairs.  Each oriented pattern is
    re-anchored at the original bounding-box corner, so the offsets stay
    relative to the same place."""
    x0, y0 = B.xy_bounds(catalyst)[:2].tolist()
    results = []
    for t in orbits.symmetry_orbit_representatives(catalyst):
        oriented = tr.transform(catalyst, t)
        ox, oy = B.xy_bounds(oriented)[:2].tolist()
        dx, dy = x0 - ox, y0 - oy
        rt = None
        if recovery_target is not None:
            rt = recovery_target.transformed(t).moved(dx, dy)
        results.append((t, catalyst_search(active, B.move(oriented, dx, dy), offsets,
                                           horizon, rt)))
    return results
