"""Dense still-life state: the types of :mod:`lifeapi_tpu.stable.propagate`.

Per cell a bool ``state`` (known ON), a bool ``unknown`` and a uint8
``ruled`` options mask (bit set = option ruled out, the reference's
inverted planes, LifeStable.hpp:44-53) over ``[..., 64, 64]`` grids indexed
``[x, y]``.  The beam search takes a dense :class:`Stable` and packs it
(:func:`lifeapi_tpu_torch.stable.bitplane.from_dense_stable`); the dense
per-cell propagation itself is not part of the port yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import board as board_mod

N = 64


class Stable(NamedTuple):
    """Batched partial still-life (reference ``LifeStable``,
    LifeStable.hpp:39-53)."""

    state: torch.Tensor  # bool[..., 64, 64] known ON
    unknown: torch.Tensor  # bool[..., 64, 64]
    ruled: torch.Tensor  # uint8[..., 64, 64] options ruled out

    @property
    def batch_shape(self):
        return self.state.shape[:-2]


class PropagateResult(NamedTuple):
    """Per-board consistency/progress flags (reference
    LifeStable.hpp:123-126)."""

    stable: Stable
    consistent: torch.Tensor  # bool[...]
    changed: torch.Tensor  # bool[...]


def make(state=None, unknown=None, batch=(), device=None):
    """Fresh Stable; ``state``/``unknown`` may be int64 boards or dense."""
    def to_dense(x):
        if x is None:
            return torch.zeros((*batch, N, N), dtype=torch.bool, device=device)
        if x.dtype == torch.int64:
            return board_mod.to_dense(x)
        return x.bool()

    s = to_dense(state)
    u = to_dense(unknown)
    shape = torch.broadcast_shapes(s.shape, u.shape)
    s = s.expand(shape)
    u = u.expand(shape) & ~s
    return Stable(s.clone(), u, torch.zeros(shape, dtype=torch.uint8, device=s.device))
