"""Offset-symmetry algebra: glide-axis placement, symmetrization, and
collision prediction under symmetry.

Counterpart of :mod:`lifeapi_tpu.symmetry.offsets` (reference
Symmetry.hpp:344-403 offset algebra, :540-563 PerpComponent, :565-654
Symmetricize, :729-772 IntersectingOffsets).
"""

from __future__ import annotations

from ..core import board as board_mod
from ..core import convolve as convolve_mod
from .groups import GROUPS, StaticSymmetry as S
from .transforms import SymmetryTransform as T, transform


def halve_offset(sym, vec):
    """Center of the offset symmetry: the (representative) solution c of
    2c == vec on the torus, with the special rotation-center form for C4
    (reference ``HalveOffset``, Symmetry.hpp:385-403)."""
    x, y = vec
    if S(sym) == S.C4:
        x2 = (x - y) // 2
        y2 = (x + y) // 2
        x3 = ((x2 + 16 + 32) % 32 - 16 + 64) % 64
        y3 = ((y2 + 16 + 32) % 32 - 16 + 64) % 64
        return (x3, y3)
    hx = (((x + 32) % 64 - 32) // 2 + 64) % 64
    hy = (((y + 32) % 64 - 32) // 2 + 64) % 64
    return (hx, hy)


def perp_component(transf, offset):
    """Component of a translation perpendicular to a reflection axis
    (reference ``PerpComponent``, Symmetry.hpp:540-563)."""
    t = T(transf)
    x, y = offset
    if t == T.ReflectAcrossX:
        return (0, y)
    if t == T.ReflectAcrossY:
        return (x, 0)
    if t == T.ReflectAcrossYeqX:
        cx = (x + 32) % 64 - 32
        cy = (y + 32) % 64 - 32
        return (((cx - cy + 128) // 2) % 64, ((-cx + cy + 128) // 2) % 64)
    if t == T.ReflectAcrossYeqNegXP1:
        cx = (x + 32) % 64 - 32
        cy = (y + 32) % 64 - 32
        s = ((cx + cy + 128) // 2) % 64
        return (s, s)
    return offset


def symmetricize(state, sym, offset=(0, 0)):
    """OR the orbit of ``state`` under the group with glide offset
    (reference ``Symmetricize``, Symmetry.hpp:565-654).  Supports the same
    cases as the reference: C1, C2, C4, D2*, D4, D4diag."""
    sym = S(sym)
    ox, oy = offset

    def tm(b, t, dx, dy):
        return board_mod.move(transform(b, t), dx, dy)

    if sym == S.C1:
        return state
    if sym == S.C2:
        return state | tm(state, T.Rotate180EvenBoth, ox + 1, oy + 1)
    if sym == S.C4:
        out = state | tm(state, T.Rotate90, ox, oy)
        return out | tm(out, T.Rotate180EvenBoth, ox - oy + 1, oy + ox + 1)
    if sym == S.D2AcrossX:
        return state | tm(state, T.ReflectAcrossXEven, ox, oy + 1)
    if sym == S.D2AcrossY:
        return state | tm(state, T.ReflectAcrossYEven, ox + 1, oy)
    if sym == S.D2diagodd:
        return state | tm(state, T.ReflectAcrossYeqX, ox, oy)
    if sym == S.D2negdiagodd:
        return state | tm(state, T.ReflectAcrossYeqNegX, ox + 1, oy + 1)
    if sym == S.D4:
        xoff = perp_component(T.ReflectAcrossX, offset)
        out = state | tm(state, T.ReflectAcrossXEven, xoff[0], xoff[1] + 1)
        yoff = perp_component(T.ReflectAcrossY, offset)
        return out | tm(out, T.ReflectAcrossYEven, yoff[0] + 1, yoff[1])
    if sym == S.D4diag:
        yoff = perp_component(T.ReflectAcrossYeqX, offset)
        out = state | tm(state, T.ReflectAcrossYeqX, yoff[0], yoff[1])
        xoff = perp_component(T.ReflectAcrossYeqNegXP1, offset)
        return out | tm(out, T.ReflectAcrossYeqNegX, xoff[0] + 1, xoff[1] + 1)
    raise NotImplementedError(f"Symmetricize for {sym!r} (same set as reference)")


def symmetricize_coset(state, sym):
    """Zero-offset symmetrization via the full coset list, for every group
    (beyond the reference's supported set)."""
    out = state
    for t in GROUPS[S(sym)]:
        out = out | transform(state, t)
    return out


_INTERSECTING = {
    S.C2: None,
    S.C4: T.Rotate270,
    S.D2AcrossX: T.ReflectAcrossY,
    S.D2AcrossY: T.ReflectAcrossX,
    S.D2diagodd: T.ReflectAcrossYeqNegXP1,
    S.D2negdiagodd: T.ReflectAcrossYeqX,
}


def intersecting_offsets(pat1, pat2=None, sym=S.C2):
    """Translations at which ``pat2`` touches the symmetric image of
    ``pat1`` under the group's non-identity generator (reference
    ``IntersectingOffsets``, Symmetry.hpp:729-772)."""
    if pat2 is None:
        pat2 = pat1
    sym = S(sym)
    if sym not in _INTERSECTING:
        raise NotImplementedError(f"IntersectingOffsets for {sym!r}")
    t = _INTERSECTING[sym]
    return convolve_mod.convolve(pat2, pat1 if t is None else transform(pat1, t))
