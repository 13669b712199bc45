"""LifeTarget: a match target of wanted-ON and unwanted-OFF cells.

Counterpart of :mod:`lifeapi_tpu.target` (reference LifeTarget.hpp:5-55).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .core import board as board_mod
from .core import convolve as convolve_mod
from .symmetry import transforms


class LifeTarget(NamedTuple):
    wanted: torch.Tensor  # int64[..., 64]
    unwanted: torch.Tensor

    @staticmethod
    def from_state(state):
        """Default target: the pattern itself ON, its boundary OFF
        (reference LifeTarget.hpp:10-13)."""
        return LifeTarget(state, board_mod.boundary(state))

    def moved(self, dx, dy):
        return LifeTarget(
            board_mod.move(self.wanted, dx, dy),
            board_mod.move(self.unwanted, dx, dy),
        )

    def transformed(self, transf):
        return LifeTarget(
            transforms.transform(self.wanted, transf),
            transforms.transform(self.unwanted, transf),
        )


def contains(state, target: LifeTarget):
    """Fused containment test (reference LifeTarget.hpp:44-51)."""
    diff = (state ^ target.wanted) & (target.wanted | target.unwanted)
    return board_mod.is_empty(diff)


def contains_moved(state, target: LifeTarget, dx, dy):
    """Reference LifeState::Contains(target, dx, dy) (LifeTarget.hpp:38-42)."""
    return (
        board_mod.contains_moved(state, target.wanted, dx, dy)
        & board_mod.are_disjoint_moved(state, target.unwanted, dx, dy)
    )


def match(state, target: LifeTarget):
    """All offsets at which the target occurs (reference LifeTarget.hpp:53-55)."""
    return convolve_mod.match_live_and_dead(state, target.wanted, target.unwanted)


def hamming_cost(state, target: LifeTarget):
    """Number of violated target cells — the MPC cost head: wanted cells
    that are OFF plus unwanted cells that are ON."""
    missing = target.wanted & ~state
    spurious = target.unwanted & state
    return board_mod.population(missing) + board_mod.population(spurious)
