"""The 16 point-symmetry transforms of the 64x64 torus.

Counterpart of :mod:`lifeapi_tpu.symmetry.transforms` (reference
Symmetry.hpp:7-173), with the same enum values.  Each transform is an affine
index map on the dense view, a composition of an axis swap, axis flips
(coordinate c -> -1-c, the "even" reflections whose axis lies between cells)
and flip-and-roll (c -> -c, the "odd" ones whose axis lies on a cell row or
column).  :func:`transform` applies it to packed boards as a bit permutation;
:func:`transform_dense` is the same map on dense grids.
"""

from __future__ import annotations

import enum

import torch


class SymmetryTransform(enum.IntEnum):
    """Reference Symmetry.hpp:7-26.  Even = axis between cells; odd = axis
    on a cell row/column.  ReflectAcrossYeqNegXP1 reflects across
    y = -x + 3/2, fixing (0, 0) (needed for D4x_1)."""

    Identity = 0
    ReflectAcrossXEven = 1
    ReflectAcrossX = 2
    ReflectAcrossYEven = 3
    ReflectAcrossY = 4
    Rotate90Even = 5
    Rotate90 = 6
    Rotate270Even = 7
    Rotate270 = 8
    Rotate180OddBoth = 9
    Rotate180EvenHorizontal = 10
    Rotate180EvenVertical = 11
    Rotate180EvenBoth = 12
    ReflectAcrossYeqX = 13
    ReflectAcrossYeqNegX = 14
    ReflectAcrossYeqNegXP1 = 15


ALL_TRANSFORMS = tuple(SymmetryTransform)

T = SymmetryTransform

# (swap_axes, x_op, y_op): ops applied after the optional transpose;
# "id" = identity, "even" = c -> -1-c (pure flip), "odd" = c -> -c (flip,
# then roll by 1)
_SPEC = {
    T.Identity: (False, "id", "id"),
    T.ReflectAcrossXEven: (False, "id", "even"),
    T.ReflectAcrossX: (False, "id", "odd"),
    T.ReflectAcrossYEven: (False, "even", "id"),
    T.ReflectAcrossY: (False, "odd", "id"),
    T.Rotate90Even: (True, "even", "id"),
    T.Rotate90: (True, "odd", "id"),
    T.Rotate270Even: (True, "id", "even"),
    T.Rotate270: (True, "id", "odd"),
    T.Rotate180OddBoth: (False, "odd", "odd"),
    T.Rotate180EvenHorizontal: (False, "even", "odd"),
    T.Rotate180EvenVertical: (False, "odd", "even"),
    T.Rotate180EvenBoth: (False, "even", "even"),
    T.ReflectAcrossYeqX: (True, "id", "id"),
    T.ReflectAcrossYeqNegX: (True, "even", "even"),
    T.ReflectAcrossYeqNegXP1: (True, "odd", "odd"),
}

_INVERSE = {
    T.Rotate90Even: T.Rotate270Even,
    T.Rotate90: T.Rotate270,
    T.Rotate270Even: T.Rotate90Even,
    T.Rotate270: T.Rotate90,
}


def transform_inverse(t):
    """Reference ``TransformInverse`` (Symmetry.hpp:47-55)."""
    t = SymmetryTransform(t)
    return _INVERSE.get(t, t)


def _axis_op(dense, op, dim):
    if op == "id":
        return dense
    flipped = torch.flip(dense, dims=(dim,))
    return flipped if op == "even" else torch.roll(flipped, 1, dims=dim)


def transform_dense(dense, t):
    """Apply transform ``t`` to a dense grid ``[..., 64, 64]``."""
    swap, x_op, y_op = _SPEC[SymmetryTransform(t)]
    d = dense.transpose(-1, -2) if swap else dense
    return _axis_op(_axis_op(d, x_op, -2), y_op, -1)


def transform(board, t):
    """Apply transform ``t`` to boards ``int64[..., 64]`` (reference
    ``LifeState::Transform``, Symmetry.hpp:105-173): the transpose is the
    block-swap network, the x ops reverse and roll the columns, the y ops
    reverse and rotate the words."""
    from ..core import board as B

    swap, x_op, y_op = _SPEC[SymmetryTransform(t)]
    out = B.transpose(board, which_diagonal=False) if swap else board
    if x_op != "id":
        out = B.flip_y(out)  # x -> -1-x
        if x_op == "odd":
            out = B.roll_x(out, 1)
    if y_op != "id":
        out = B.flip_x(out)  # y -> -1-y
        if y_op == "odd":
            out = B.roll_y(out, 1)
    return out


def transform_moved(board, dx, dy, t):
    """Reference ``Transform(dx, dy, transf)`` (LifeAPI.hpp:803-806): move
    first, then transform."""
    from ..core.board import move

    return transform(move(board, dx, dy), t)


def commute_translation(t, vec):
    """How a translation commutes past a transform: T . move(v) =
    move(commute(T, v)) . T (reference ``CommuteTranslation``,
    Symmetry.hpp:344-383)."""
    x, y = vec
    table = {
        T.Identity: (x, y),
        T.ReflectAcrossXEven: (x, -y),
        T.ReflectAcrossX: (x, -y),
        T.ReflectAcrossYEven: (-x, y),
        T.ReflectAcrossY: (-x, y),
        T.Rotate90Even: (-y, x),
        T.Rotate90: (-y, x),
        T.Rotate270Even: (y, -x),
        T.Rotate270: (y, -x),
        T.Rotate180OddBoth: (-x, -y),
        T.Rotate180EvenHorizontal: (-x, -y),
        T.Rotate180EvenVertical: (-x, -y),
        T.Rotate180EvenBoth: (-x, -y),
        T.ReflectAcrossYeqX: (y, x),
        T.ReflectAcrossYeqNegX: (-y, -x),
        T.ReflectAcrossYeqNegXP1: (-y, -x),
    }
    return table[SymmetryTransform(t)]
