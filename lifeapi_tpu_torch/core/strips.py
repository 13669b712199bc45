"""Strip and patch views: small column windows and square patches packed
into words (reference LifeStrip.hpp and LifeAPI.hpp:148-207).

Counterpart of :mod:`lifeapi_tpu.core.strips`.  A strip is ``int64[...,
width]``, one word per column, as boards are.  The solver works on whole
boards, so these exist for API parity and host-side search loops.
"""

from __future__ import annotations

import torch

from .board import N, from_dense, to_dense, torus_wrap

STRIP_WIDTH = 4  # the reference's LifeStateStrip width (LifeStrip.hpp:10)


def _offset(width):
    # 0, 0, 1, 1, 2, 2 for widths 1..6 (reference LifeAPI.hpp:151)
    return (width - 1) // 2


def _columns(column, width):
    off = _offset(width)
    return [(column + i - off) % N for i in range(width)]


def get_strip(board, column, width=STRIP_WIDTH):
    """``int64[..., width]``: the columns of a width-window centered per the
    reference's offset rule (reference ``GetStrip``, LifeAPI.hpp:148-165)."""
    return board[..., _columns(column, width)]


def set_strip(board, column, value, width=None):
    """Write a strip back (reference ``SetStrip``, LifeAPI.hpp:167-174).
    ``value`` is ``int64[..., width]``, a tensor or anything
    ``torch.as_tensor`` takes."""
    value = torch.as_tensor(value, dtype=board.dtype, device=board.device)
    width = width or value.shape[-1]
    out = board.clone()
    out[..., _columns(column, width)] = value[..., :width]
    return out


def get_patch(board, cell, radius):
    """Pack the (2r+1)^2 patch of one board around ``cell`` into a Python
    int, row i (column offset) in bit group i*(2r+1) (reference
    ``GetPatch``, LifeAPI.hpp:179-193).  Host-side."""
    x, y = cell
    d = to_dense(board).cpu().numpy()
    diameter = 2 * radius + 1
    result = 0
    for i in range(diameter):
        c = torus_wrap(x + i - radius)
        for j in range(diameter):
            if d[c, torus_wrap(y + j - radius)]:
                result |= 1 << (i * diameter + j)
    return result


def set_patch(board, cell, radius, value):
    """Inverse of :func:`get_patch` (reference ``SetPatch``,
    LifeAPI.hpp:195-207).  Host-side; the result is on ``board``'s device."""
    x, y = cell
    d = to_dense(board).cpu().numpy()
    diameter = 2 * radius + 1
    for i in range(diameter):
        c = torus_wrap(x + i - radius)
        for j in range(diameter):
            d[c, torus_wrap(y + j - radius)] = bool((value >> (i * diameter + j)) & 1)
    return from_dense(torch.from_numpy(d)).to(board.device)


def strip_indices(column_mask, width=STRIP_WIDTH):
    """Window start columns covering the set bits of a 64-bit column mask
    (a Python int), clamped so windows don't wrap (reference
    ``StripIterator``, LifeStrip.hpp:102-149)."""
    out = []
    mask = column_mask
    off = _offset(width)
    while mask:
        lsb = (mask & -mask).bit_length() - 1
        start = min(max(lsb - off, 0), N - width)
        out.append(start)
        mask &= ~(((1 << width) - 1) << start)
    return out
