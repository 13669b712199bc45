"""Symmetry groups of the torus: cosets, generator chains, fundamental
domains, and name round-trips.

Counterpart of :mod:`lifeapi_tpu.symmetry.groups`, whose tables are copied
here: reference Symmetry.hpp:57-103 (enums), :175-279 (groups and chains),
:281-342 (fundamental domains), :405-538 (names and apgsearch symmetry
chars).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from .._device import resolve
from ..core.board import from_dense
from .transforms import SymmetryTransform as T

N = 64


class StaticSymmetry(enum.IntEnum):
    """Reference Symmetry.hpp:57-79."""

    C1 = 0
    D2AcrossX = 1
    D2AcrossXEven = 2
    D2AcrossY = 3
    D2AcrossYEven = 4
    D2negdiagodd = 5
    D2diagodd = 6
    C2 = 7
    C2even = 8
    C2verticaleven = 9
    C2horizontaleven = 10
    C4 = 11
    C4even = 12
    D4 = 13
    D4even = 14
    D4verticaleven = 15
    D4horizontaleven = 16
    D4diag = 17
    D4diageven = 18
    D8 = 19
    D8even = 20


ALL_SYMMETRIES = tuple(StaticSymmetry)

S = StaticSymmetry

# Full coset lists (reference ``SymmetryGroupFromEnum``, Symmetry.hpp:175-231).
GROUPS = {
    S.C1: (T.Identity,),
    S.D2AcrossX: (T.Identity, T.ReflectAcrossX),
    S.D2AcrossXEven: (T.Identity, T.ReflectAcrossXEven),
    S.D2AcrossY: (T.Identity, T.ReflectAcrossY),
    S.D2AcrossYEven: (T.Identity, T.ReflectAcrossYEven),
    S.D2diagodd: (T.Identity, T.ReflectAcrossYeqX),
    S.D2negdiagodd: (T.Identity, T.ReflectAcrossYeqNegXP1),
    S.C2: (T.Identity, T.Rotate180OddBoth),
    S.C2even: (T.Identity, T.Rotate180EvenBoth),
    S.C2horizontaleven: (T.Identity, T.Rotate180EvenHorizontal),
    S.C2verticaleven: (T.Identity, T.Rotate180EvenVertical),
    S.C4: (T.Identity, T.Rotate90, T.Rotate180OddBoth, T.Rotate270),
    S.C4even: (T.Identity, T.Rotate90Even, T.Rotate180EvenBoth, T.Rotate270Even),
    S.D4: (T.Identity, T.ReflectAcrossX, T.Rotate180OddBoth, T.ReflectAcrossY),
    S.D4even: (
        T.Identity,
        T.ReflectAcrossXEven,
        T.Rotate180EvenBoth,
        T.ReflectAcrossYEven,
    ),
    S.D4horizontaleven: (
        T.Identity,
        T.ReflectAcrossYEven,
        T.Rotate180EvenHorizontal,
        T.ReflectAcrossX,
    ),
    S.D4verticaleven: (
        T.Identity,
        T.ReflectAcrossXEven,
        T.Rotate180EvenVertical,
        T.ReflectAcrossY,
    ),
    S.D4diag: (
        T.Identity,
        T.ReflectAcrossYeqX,
        T.Rotate180OddBoth,
        T.ReflectAcrossYeqNegXP1,
    ),
    S.D4diageven: (
        T.Identity,
        T.ReflectAcrossYeqX,
        T.Rotate180EvenBoth,
        T.ReflectAcrossYeqNegX,
    ),
    S.D8: (
        T.Identity,
        T.ReflectAcrossX,
        T.ReflectAcrossYeqX,
        T.ReflectAcrossY,
        T.ReflectAcrossYeqNegXP1,
        T.Rotate90,
        T.Rotate270,
        T.Rotate180OddBoth,
    ),
    S.D8even: (
        T.Identity,
        T.ReflectAcrossXEven,
        T.ReflectAcrossYeqX,
        T.ReflectAcrossYEven,
        T.ReflectAcrossYeqNegX,
        T.Rotate90Even,
        T.Rotate270Even,
        T.Rotate180EvenBoth,
    ),
}

# Minimal generator chains for incremental symmetrization (reference
# ``SymmetryChainFromEnum``, Symmetry.hpp:233-279).
CHAINS = {
    S.C1: (),
    S.D2AcrossY: (T.ReflectAcrossY,),
    S.D2AcrossYEven: (T.ReflectAcrossYEven,),
    S.D2AcrossX: (T.ReflectAcrossX,),
    S.D2AcrossXEven: (T.ReflectAcrossXEven,),
    S.D2diagodd: (T.ReflectAcrossYeqX,),
    S.D2negdiagodd: (T.ReflectAcrossYeqNegXP1,),
    S.C2: (T.Rotate180OddBoth,),
    S.C2even: (T.Rotate180EvenBoth,),
    S.C2horizontaleven: (T.Rotate180EvenHorizontal,),
    S.C2verticaleven: (T.Rotate180EvenVertical,),
    S.C4: (T.Rotate90, T.Rotate180OddBoth),
    S.C4even: (T.Rotate90Even, T.Rotate180EvenBoth),
    S.D4: (T.ReflectAcrossX, T.ReflectAcrossY),
    S.D4even: (T.ReflectAcrossXEven, T.ReflectAcrossYEven),
    S.D4horizontaleven: (T.ReflectAcrossYEven, T.ReflectAcrossX),
    S.D4verticaleven: (T.ReflectAcrossXEven, T.ReflectAcrossY),
    S.D4diag: (T.ReflectAcrossYeqX, T.ReflectAcrossYeqNegXP1),
    S.D4diageven: (T.ReflectAcrossYeqX, T.ReflectAcrossYeqNegX),
    S.D8: (T.Rotate90, T.Rotate180OddBoth, T.ReflectAcrossYeqX),
    S.D8even: (T.Rotate90Even, T.Rotate180EvenBoth, T.ReflectAcrossYeqX),
}


def fundamental_domain(sym, device=None):
    """A fundamental domain of the group as a board, the intended
    shapes of reference Symmetry.hpp:281-342 (the snapshot constants are
    mangled by the ConstantParse bare-$ bug, SURVEY.md section 2.7;
    these are the row patterns the RLE constants spell out)."""
    sym = StaticSymmetry(sym)
    x = np.arange(N)[:, None]
    y = np.arange(N)[None, :]
    if sym == S.C1:
        d = np.ones((N, N), dtype=bool)
    elif sym in (S.D2AcrossY, S.D2AcrossYEven):
        d = x < 33
    elif sym in (S.D2AcrossX, S.D2AcrossXEven):
        d = y < 33
    elif sym == S.D2diagodd:
        d = x < np.minimum(y + 2, N)
    elif sym == S.D2negdiagodd:
        d = x < np.where(y <= 2, N, 66 - y)
    elif sym in (S.C2, S.C2even, S.C2horizontaleven, S.C2verticaleven):
        d = y < 33
    elif sym in (S.C4, S.C4even, S.D4, S.D4even, S.D4horizontaleven, S.D4verticaleven):
        d = (x < 33) & (y < 33)
    elif sym in (S.D4diag, S.D4diageven):
        d = x < np.minimum(y + 2, 66 - y)
    else:  # D8, D8even
        d = (y < 32) & (x <= y)
    d = np.broadcast_to(d, (N, N))
    return from_dense(torch.from_numpy(np.array(d)).to(resolve(device)))


# ---------------------------------------------------------------------------
# Name round-trip (reference Symmetry.hpp:405-513), Logic-Life-Search names.
# ---------------------------------------------------------------------------

_TO_STRING = {
    S.C1: "C1",
    S.D2AcrossX: "D2-",
    S.D2AcrossXEven: "D2-even",
    S.D2AcrossY: "D2|",
    S.D2AcrossYEven: "D2|even",
    S.D2diagodd: "D2\\",
    S.D2negdiagodd: "D2/",
    S.C2: "C2",
    S.C2even: "C2even",
    S.C2horizontaleven: "C2|even",
    S.C2verticaleven: "C2-even",
    S.C4: "C4",
    S.C4even: "C4even",
    S.D4: "D4+",
    S.D4even: "D4+even",
    S.D4horizontaleven: "D4+|even",
    S.D4verticaleven: "D4+-even",
    S.D4diag: "D4x",
    S.D4diageven: "D4xeven",
    S.D8: "D8",
    S.D8even: "D8even",
}


def symmetry_to_string(sym):
    return _TO_STRING[StaticSymmetry(sym)]


def symmetry_from_string(name):
    """Reference ``SymmetryFromString`` (Symmetry.hpp:405-466); returns C1
    for unrecognized names, like the reference."""
    start, rest = name[:2], name[2:]
    if start == "D2":
        return {
            "-": S.D2AcrossX,
            "vertical": S.D2AcrossX,
            "-even": S.D2AcrossXEven,
            "verticaleven": S.D2AcrossXEven,
            "|": S.D2AcrossY,
            "horizontal": S.D2AcrossY,
            "|even": S.D2AcrossYEven,
            "horizontaleven": S.D2AcrossYEven,
            "/": S.D2negdiagodd,
            "/odd": S.D2negdiagodd,
            "\\": S.D2diagodd,
            "\\odd": S.D2diagodd,
        }.get(rest, S.C1)
    if start == "C2":
        return {
            "": S.C2,
            "_1": S.C2,
            "even": S.C2even,
            "_4": S.C2even,
            "horizontaleven": S.C2horizontaleven,
            "|even": S.C2horizontaleven,
            "verticaleven": S.C2verticaleven,
            "-even": S.C2verticaleven,
            "_2": S.C2verticaleven,
        }.get(rest, S.C1)
    if start == "C4":
        return {"": S.C4, "_1": S.C4, "even": S.C4even, "_4": S.C4even}.get(
            rest, S.C1
        )
    if start == "D4":
        if rest.startswith("+") or rest in ("_+1", "_+2", "_+4"):
            info = rest[1:] if rest.startswith("+") else None
            if info == "" or rest == "_+1":
                return S.D4
            if info == "even" or rest == "_+4":
                return S.D4even
            if info in ("verticaleven", "-even") or rest == "_+2":
                return S.D4verticaleven
            if info in ("horizontaleven", "|even"):
                return S.D4horizontaleven
        elif rest.startswith("x") or rest in ("_x1", "_x4"):
            info = rest[1:] if rest.startswith("x") else None
            if info == "" or rest == "_x1":
                return S.D4diag
            if info == "even" or rest == "_x4":
                return S.D4diageven
        return S.C1
    if start == "D8":
        return {"": S.D8, "_1": S.D8, "even": S.D8even, "_4": S.D8even}.get(
            rest, S.C1
        )
    return S.C1


def char_to_transforms(ch):
    """apgsearch-style symmetry chars (reference ``CharToTransforms``,
    Symmetry.hpp:515-538)."""
    table = {
        ".": GROUPS[S.C1],
        "|": GROUPS[S.D2AcrossY],
        "-": GROUPS[S.D2AcrossX],
        "\\": GROUPS[S.D2diagodd],
        "/": GROUPS[S.D2negdiagodd],
        "+": GROUPS[S.C4],
        "@": GROUPS[S.C4],
        "x": (T.Identity, T.Rotate90, T.ReflectAcrossX, T.ReflectAcrossYeqX),
        "*": GROUPS[S.D8],
    }
    return table.get(ch, GROUPS[S.C1])
