"""64x64 torus bitboards as ``torch.int64[..., 64]``.

Counterpart of :mod:`lifeapi_tpu.core.board`.  A board is one 64-bit word
per column x, bit y of word x = cell (x, y): the reference's own layout
(``LifeState``, LifeAPI.hpp:39-1382) and the C oracle's.  The JAX package
splits the same word into two uint32 halves (``uint32[..., 64, 2]``);
:mod:`lifeapi_tpu_torch.convert` maps one to the other.  A dense view is
``bool[..., 64, 64]`` indexed ``[x, y]``.

All functions are batched over leading dims and never modify their inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bitops

N = 64
WORD = torch.int64


def torus_wrap(x):
    """Coordinate wrap, valid for negatives (reference LifeAPI.hpp:14-16)."""
    return x & (N - 1)


def _bit_index(device):
    return torch.arange(N, dtype=WORD, device=device)


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------


def to_dense(board):
    """int64[..., 64] -> dense bool[..., 64, 64] indexed [x, y]."""
    return ((board[..., None] >> _bit_index(board.device)) & 1).bool()


def from_dense(dense):
    """dense bool/int [..., 64, 64] indexed [x, y] -> int64[..., 64]."""
    bits = dense.to(WORD)
    # distinct powers of two: the sum never carries, so the top bit lands
    # in the sign bit exactly
    return (bits << _bit_index(dense.device)).sum(dim=-1)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def empty(batch=(), device=None):
    return torch.zeros((*batch, N), dtype=WORD, device=device)


def full(batch=(), device=None):
    return torch.full((*batch, N), -1, dtype=WORD, device=device)


def random(generator, batch=(), p=0.5, device=None):
    """Random board(s); each cell ON independently with probability p,
    drawn from an explicit ``torch.Generator`` (reference ``RandomState``,
    LifeAPI.hpp:63-69, draws from a nondeterministic mt19937)."""
    if p == 0.5:
        raw = torch.randint(0, 256, (*batch, N, 8), dtype=torch.uint8,
                            generator=generator, device=device)
        return raw.view(WORD)[..., 0]
    u = torch.rand((*batch, N, N), generator=generator, device=device)
    return from_dense(u < p)


def from_cells(cells, batch=(), device=None):
    """Board with the given (x, y) cells set."""
    d = np.zeros((N, N), dtype=bool)
    for x, y in cells:
        d[x % N, y % N] = True
    board = from_dense(torch.from_numpy(d).to(device))
    return board.expand(*batch, N).clone() if batch else board


def on_cells(board):
    """List of (x, y) tuples of ON cells, in lexicographic order (reference
    ``OnCells``, LifeAPI.hpp:1372-1381)."""
    xs, ys = np.nonzero(to_dense(board).cpu().numpy())
    return list(zip(xs.tolist(), ys.tolist()))


# ---------------------------------------------------------------------------
# Cell access
# ---------------------------------------------------------------------------


def get_cell(board, x, y):
    """Cell (x, y) as bool (reference ``Get``, LifeAPI.hpp:134)."""
    return ((board[..., torus_wrap(x)] >> torus_wrap(y)) & 1).bool()


def set_cell(board, x, y, val=True):
    """Copy of the board with cell (x, y) set or erased (reference
    ``Set``/``Erase``, LifeAPI.hpp:131-133)."""
    x, y = torus_wrap(x), torus_wrap(y)
    out = board.clone()
    bit = bitops.rotl64(torch.ones((), dtype=WORD, device=board.device), y)
    out[..., x] = out[..., x] | bit if val else out[..., x] & ~bit
    return out


# ---------------------------------------------------------------------------
# Comparisons (reference LifeAPI.hpp:213-298, :377-422)
# ---------------------------------------------------------------------------


def equal(a, b):
    return (a == b).all(dim=-1)


def is_empty(board):
    """Reference ``IsEmpty`` (LifeAPI.hpp:281-288)."""
    return (board == 0).all(dim=-1)


def population(board):
    """Number of ON cells, int64 (reference ``GetPop``,
    LifeAPI.hpp:290-298)."""
    return bitops.popcount64(board).sum(dim=-1)


def are_disjoint(a, b):
    """True iff a and b share no ON cells (reference LifeAPI.hpp:377-386)."""
    return is_empty(a & b)


def contains(a, b):
    """True iff every ON cell of b is ON in a (reference
    LifeAPI.hpp:388-397)."""
    return is_empty(b & ~a)


def contains_moved(a, b, dx, dy):
    """Reference ``Contains(pat, dx, dy)`` (LifeAPI.hpp:399-409)."""
    return contains(a, move(b, dx, dy))


def are_disjoint_moved(a, b, dx, dy):
    """Reference ``AreDisjoint(pat, dx, dy)`` (LifeAPI.hpp:411-422)."""
    return are_disjoint(a, move(b, dx, dy))


# ---------------------------------------------------------------------------
# Shifts / moves
# ---------------------------------------------------------------------------


def roll_x(board, dx):
    """Shift columns: result column x holds input column x-dx (torus)."""
    return torch.roll(board, dx % N, dims=-1)


def roll_y(board, dy):
    """Shift rows: cell (x, y) of the result holds input cell (x, y-dy)."""
    return bitops.rotl64(board, dy)


def move(board, dx, dy):
    """Translate by (dx, dy) on the torus (reference ``Move``/``Moved``,
    LifeAPI.hpp:682-736)."""
    return roll_y(roll_x(board, dx), dy)


def move_dyn(board, dx, dy):
    """:func:`move` with per-board offsets: ``dx``/``dy`` are integer
    tensors broadcasting against the batch dims of ``board``, any sign."""
    shape = torch.broadcast_shapes(board.shape[:-1], dx.shape, dy.shape)
    board = board.expand(*shape, N)
    dx = dx.to(WORD).expand(shape)
    dy = dy.to(WORD).expand(shape)
    src = torch.remainder(_bit_index(board.device) - dx[..., None], N)
    return bitops.rotl64(torch.gather(board, -1, src), dy[..., None])


# ---------------------------------------------------------------------------
# ZOI family (reference LifeAPI.hpp:521-562)
# ---------------------------------------------------------------------------


def _vert3(board):
    return board | roll_y(board, 1) | roll_y(board, -1)


def zoi(board):
    """3x3 dilation (reference ``ZOI``, LifeAPI.hpp:521-536)."""
    v = _vert3(board)
    return v | roll_x(v, 1) | roll_x(v, -1)


def boundary(board):
    """Reference ``GetBoundary`` (LifeAPI.hpp:538)."""
    return zoi(board) & ~board


def zoi_hollow(board):
    """8-neighbour dilation, center excluded (reference ``ZOIHollow``,
    LifeAPI.hpp:541-562)."""
    t = _vert3(board)
    tmid = roll_y(board, 1) | roll_y(board, -1)
    return roll_x(t, 1) | roll_x(t, -1) | tmid
