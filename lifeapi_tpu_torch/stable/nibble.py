"""Bit-sliced small-integer arithmetic on board planes.

Counterpart of :mod:`lifeapi_tpu.stable.nibble`.  A "nibble" is a
little-endian tuple of boards ``(b0, b1, ...)``: bit i of cell (x, y)'s
value lives in plane ``b[i]``.  A plane is a port board ``int64[..., 64]``;
every circuit is ``~``, ``&``, ``|`` and ``^`` only, which are exact on
int64, so the 4096 cells of every board compute in lockstep, 64 per word.
"""

from __future__ import annotations

import torch


def _zeros_like(plane):
    return torch.zeros_like(plane)


def _ones_like(plane):
    return torch.full_like(plane, -1)


def const(plane_like, value, width=4):
    """Nibble with every cell equal to ``value``."""
    z = _zeros_like(plane_like)
    o = _ones_like(plane_like)
    return tuple(o if (value >> i) & 1 else z for i in range(width))


def from_bit(bit_plane, width=4):
    """Nibble holding 0 or 1 per cell."""
    z = _zeros_like(bit_plane)
    return (bit_plane,) + (z,) * (width - 1)


def add(x, y, width=None):
    """Bitsliced ripple add (truncating at ``width`` bits)."""
    width = width or max(len(x), len(y))
    z = _zeros_like(x[0])
    out = []
    carry = z
    for i in range(width):
        xi = x[i] if i < len(x) else z
        yi = y[i] if i < len(y) else z
        s = xi ^ yi ^ carry
        carry = (xi & yi) | (carry & (xi ^ yi))
        out.append(s)
    return tuple(out)


def sub(x, y, width=None):
    """Bitsliced ripple subtract x - y (two's complement, truncating)."""
    width = width or max(len(x), len(y))
    z = _zeros_like(x[0])
    out = []
    borrow = z
    for i in range(width):
        xi = x[i] if i < len(x) else z
        yi = y[i] if i < len(y) else z
        d = xi ^ yi ^ borrow
        borrow = (~xi & (yi | borrow)) | (xi & yi & borrow)
        out.append(d)
    return tuple(out)


def sub_bit(x, bit_plane):
    """x - b for a single-bit b: cheap borrow ripple."""
    out = []
    borrow = bit_plane
    for xi in x:
        out.append(xi ^ borrow)
        borrow = ~xi & borrow
    return tuple(out)


def add_bit(x, bit_plane):
    out = []
    carry = bit_plane
    for xi in x:
        out.append(xi ^ carry)
        carry = xi & carry
    return tuple(out)


def eq_const(x, k):
    """Plane: cell value == k."""
    acc = None
    for i, xi in enumerate(x):
        t = xi if (k >> i) & 1 else ~xi
        acc = t if acc is None else acc & t
    return acc


def eq(x, y):
    acc = None
    for xi, yi in zip(x, y):
        t = ~(xi ^ yi)
        acc = t if acc is None else acc & t
    return acc


def gt_const(x, k):
    """Plane: cell value > k (unsigned)."""
    gt = _zeros_like(x[0])
    eq_pre = _ones_like(x[0])
    for i in range(len(x) - 1, -1, -1):
        if (k >> i) & 1:
            eq_pre = eq_pre & x[i]
        else:
            gt = gt | (eq_pre & x[i])
            eq_pre = eq_pre & ~x[i]
    return gt


def lt_const(x, k):
    """Plane: cell value < k (unsigned)."""
    lt = _zeros_like(x[0])
    eq_pre = _ones_like(x[0])
    for i in range(len(x) - 1, -1, -1):
        if (k >> i) & 1:
            lt = lt | (eq_pre & ~x[i])
            eq_pre = eq_pre & x[i]
        else:
            eq_pre = eq_pre & ~x[i]
    return lt


def le_const(x, k):
    return ~gt_const(x, k)


def ge_const(x, k):
    return ~lt_const(x, k)


def gt(x, y):
    """Plane: x > y (unsigned, equal widths)."""
    g = _zeros_like(x[0])
    eq_pre = _ones_like(x[0])
    for i in range(len(x) - 1, -1, -1):
        g = g | (eq_pre & x[i] & ~y[i])
        eq_pre = eq_pre & ~(x[i] ^ y[i])
    return g


def select(cond_plane, x, y):
    """Per-cell cond ? x : y."""
    return tuple((xi & cond_plane) | (yi & ~cond_plane) for xi, yi in zip(x, y))


def maximum(x, y):
    return select(gt(x, y), x, y)


def minimum(x, y):
    return select(gt(x, y), y, x)


def decode(x):
    """Nibble -> dense int32 values [..., 64, 64] (for tests)."""
    from ..core.board import to_dense

    acc = None
    for i, xi in enumerate(x):
        t = to_dense(xi).to(torch.int32) << i
        acc = t if acc is None else acc + t
    return acc


def encode(values, width=4):
    """Dense int values [..., 64, 64] -> nibble (for tests)."""
    from ..core.board import from_dense

    return tuple(from_dense((values >> i) & 1) for i in range(width))
