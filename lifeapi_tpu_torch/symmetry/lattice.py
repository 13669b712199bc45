"""Lattice tricks: 2:1 downscales and shear maps used for diagonal-symmetry
offset math.  Counterpart of :mod:`lifeapi_tpu.symmetry.lattice` (reference
Symmetry.hpp:656-727)."""

from __future__ import annotations

import torch

from ..core.board import from_dense, to_dense

N = 64


def halve_x(board):
    """Keep even columns, duplicated into both board halves (reference
    ``HalveX``, Symmetry.hpp:692-699)."""
    half = to_dense(board)[..., 0::2, :]
    return from_dense(torch.cat([half, half], dim=-2))


def halve_y(board):
    """Compress even rows of every column into the low half, duplicated
    (reference ``HalveY``, Symmetry.hpp:701-709)."""
    half = to_dense(board)[..., :, 0::2]
    return from_dense(torch.cat([half, half], dim=-1))


def halve(board):
    """2:1 downscale in both axes, result replicated in all four quadrants
    (reference ``Halve``, Symmetry.hpp:681-690)."""
    q = to_dense(board)[..., 0::2, 0::2]
    row = torch.cat([q, q], dim=-1)
    return from_dense(torch.cat([row, row], dim=-2))


def _shear(board, sign):
    """Column x rotated by ``sign * x`` towards higher y."""
    x = torch.arange(N, device=board.device)
    return from_dense(torch.gather(to_dense(board), -1,
                                   torch.remainder(x[None, :] - sign * x[:, None], N)
                                   .expand(*board.shape, N)))


def skew(board):
    """(x, y) -> (x, y + x) shear (reference ``Skew``, Symmetry.hpp:712-718)."""
    return _shear(board, 1)


def inv_skew(board):
    """(x, y) -> (x, y - x) shear (reference ``InvSkew``, Symmetry.hpp:721-727)."""
    return _shear(board, -1)
