"""64x64 torus bitboards as ``torch.int64[..., 64]``.

Counterpart of :mod:`lifeapi_tpu.core.board`.  A board is one 64-bit word
per column x, bit y of word x = cell (x, y): the reference's own layout
(``LifeState``, LifeAPI.hpp:39-1382) and the C oracle's.  The JAX package
splits the same word into two uint32 halves (``uint32[..., 64, 2]``);
:mod:`lifeapi_tpu_torch.convert` maps one to the other.  A dense view is
``bool[..., 64, 64]`` indexed ``[x, y]``.

All functions are batched over leading dims and never modify their inputs.
The constructors build on the CUDA card unless given another ``device``
(:func:`lifeapi_tpu_torch._device.resolve`).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
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
    return torch.zeros((*batch, N), dtype=WORD, device=resolve(device))


def full(batch=(), device=None):
    return torch.full((*batch, N), -1, dtype=WORD, device=resolve(device))


def random(generator, batch=(), p=0.5, device=None):
    """Random board(s); each cell ON independently with probability p,
    drawn from an explicit ``torch.Generator`` (reference ``RandomState``,
    LifeAPI.hpp:63-69, draws from a nondeterministic mt19937).  The draw is
    made on the generator's own device and moved to ``device``, so one
    seed gives the same boards on every device."""
    dev = resolve(device)
    if p == 0.5:
        raw = torch.randint(0, 256, (*batch, N, 8), dtype=torch.uint8,
                            generator=generator, device=generator.device)
        return raw.view(WORD)[..., 0].to(dev)
    u = torch.rand((*batch, N, N), generator=generator, device=generator.device)
    return from_dense(u < p).to(dev)


def from_cells(cells, batch=(), device=None):
    """Board with the given (x, y) cells set."""
    d = np.zeros((N, N), dtype=bool)
    for x, y in cells:
        d[x % N, y % N] = True
    board = from_dense(torch.from_numpy(d).to(resolve(device)))
    return board.expand(*batch, N).clone() if batch else board


def cell_mask(x, y, device=None):
    """A board with the single cell (x, y) set (reference ``Cell``,
    LifeAPI.hpp:57-61)."""
    return from_cells([(x, y)], device=device)


_CHECKER_EVEN = bitops.as_int64(0xAAAAAAAAAAAAAAAA)  # odd y: (0, 0) OFF
_CHECKER_ODD = 0x5555555555555555


def checkerboard(batch=(), device=None):
    """Parity-of-(x+y) board, (0, 0) OFF (reference LifeAPI.hpp:72-82)."""
    x = _bit_index(resolve(device))
    board = torch.where(x % 2 == 0, _CHECKER_EVEN, _CHECKER_ODD)
    return board.expand(*batch, N).clone() if batch else board


def solid_rect(x, y, w, h, device=None):
    """Solid w x h rectangle with top-left (x, y), torus-wrapped (reference
    ``SolidRect``, LifeAPI.hpp:84-111).  Python ints (host setup)."""
    dense = np.zeros((N, N), dtype=bool)
    xs = np.arange(x, x + min(w, N)) % N
    ys = np.arange(y, y + min(h, N)) % N
    dense[np.ix_(xs, ys)] = True
    return from_dense(torch.from_numpy(dense).to(resolve(device)))


def solid_rect_xy(x1, y1, x2, y2, device=None):
    """Reference ``SolidRectXY`` (LifeAPI.hpp:113-115)."""
    return solid_rect(x1, y1, x2 - x1 + 1, y2 - y1 + 1, device=device)


def nzoi_around(cell, distance, device=None):
    """(2d+1)^2 square around cell (reference ``NZOIAround``,
    LifeAPI.hpp:117-121)."""
    x, y = cell
    size = 2 * distance + 1
    return solid_rect(x - distance, y - distance, size, size, device=device)


def cell_zoi(cell, device=None):
    return nzoi_around(cell, 1, device=device)


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
# Flips / transposes (see symmetry/ for the full transform set)
# ---------------------------------------------------------------------------


def flip_x(board):
    """Even reflection across the x-axis: y -> -1-y (reference ``FlipX`` =
    BitReverse, LifeAPI.hpp:758-764)."""
    return bitops.reverse64(board)


def flip_y(board):
    """Even reflection across the y-axis: x -> -1-x (reference ``FlipY``,
    LifeAPI.hpp:754-756)."""
    return torch.flip(board, dims=(-1,))


# Block-swap masks of the 64x64 bit transpose (Hacker's-Delight network,
# reference LifeAPI.hpp:766-783) for the LSB-first layout: at level j the
# exchanged sub-block of the lower column is the bit positions with bit j set.
_TRANSPOSE_MASKS = tuple((j, bitops.as_int64(m)) for j, m in (
    (32, 0xFFFFFFFF00000000), (16, 0xFFFF0000FFFF0000), (8, 0xFF00FF00FF00FF00),
    (4, 0xF0F0F0F0F0F0F0F0), (2, 0xCCCCCCCCCCCCCCCC), (1, 0xAAAAAAAAAAAAAAAA)))


def transpose(board, which_diagonal=True):
    """64x64 bit-matrix transpose (reference ``Transpose``,
    LifeAPI.hpp:766-783).  ``which_diagonal=False`` is the plain transpose
    (x, y) -> (y, x) used by ReflectAcrossYeqX; ``True`` is the anti-diagonal
    variant (x, y) -> (-1-y, -1-x) used by ReflectAcrossYeqNegX.

    The block-swap network on the words: at level j, columns k and k + j
    (bit j of k clear) exchange the bit-j-set positions of column k with the
    bit-j-clear positions of column k + j."""
    lead = board.shape[:-1]
    for j, m in _TRANSPOSE_MASKS:
        pairs = board.reshape(*lead, N // (2 * j), 2, j)
        a, b = pairs[..., 0, :], pairs[..., 1, :]
        t = (a ^ (b << j)) & m
        board = torch.stack([a ^ t, b ^ bitops.shr64(t, j)], dim=-2).reshape(*lead, N)
    if which_diagonal:
        board = flip_x(flip_y(board))
    return board


def mirrored(board):
    """Point reflection through the origin: (x, y) -> (-x, -y) (reference
    ``Mirrored``, LifeAPI.hpp:789-795)."""
    return move(flip_x(flip_y(board)), 1, 1)


# ---------------------------------------------------------------------------
# ZOI family (reference LifeAPI.hpp:521-651)
# ---------------------------------------------------------------------------


def _vert3(board):
    return board | roll_y(board, 1) | roll_y(board, -1)


def _horiz3(board):
    return board | roll_x(board, 1) | roll_x(board, -1)


def zoi(board):
    """3x3 dilation (reference ``ZOI``, LifeAPI.hpp:521-536)."""
    return _horiz3(_vert3(board))


def boundary(board):
    """Reference ``GetBoundary`` (LifeAPI.hpp:538)."""
    return zoi(board) & ~board


def zoi_hollow(board):
    """8-neighbour dilation, center excluded (reference ``ZOIHollow``,
    LifeAPI.hpp:541-562)."""
    t = _vert3(board)
    tmid = roll_y(board, 1) | roll_y(board, -1)
    return roll_x(t, 1) | roll_x(t, -1) | tmid


def moore_zoi(board):
    """5-cell plus-shape dilation (reference ``MooreZOI``,
    LifeAPI.hpp:635-651)."""
    return _vert3(board) | roll_x(board, 1) | roll_x(board, -1)


def big_zoi(board):
    """Dilation with the reference's BigZOI shape (LifeAPI.hpp:564-591):
    plus-dilate, then horizontal 3-dilate, then vertical 3-dilate."""
    return _vert3(_horiz3(moore_zoi(board)))


def nzoi(board, distance):
    """(2d+1)^2 square dilation (reference ``NZOI``, LifeAPI.hpp:607-609);
    ``distance`` is a Python int."""
    for _ in range(distance):
        board = zoi(board)
    return board


# ---------------------------------------------------------------------------
# Bounds / geometry queries
# ---------------------------------------------------------------------------


def populated_columns(board):
    """bool[..., 64]: column x has an ON cell (reference
    ``PopulatedColumns``, LifeAPI.hpp:486-492)."""
    return board != 0


def populated_rows(board):
    """bool[..., 64]: row y has an ON cell."""
    w = board
    for s in (32, 16, 8, 4, 2, 1):
        w = w[..., :s] | w[..., s:2 * s]
    return to_dense(w[..., 0])


def _longest_gap(populated):
    """(length, start) of the longest circular run of empty entries of
    bool[..., 64], ties to the lowest start; length 64 when all are empty."""
    run = (~populated).to(WORD)  # zero-run length starting at i, capped at 2k
    for k in (1, 2, 4, 8, 16, 32):
        run = torch.where(run == k, run + torch.roll(run, -k, dims=-1), run)
        run = torch.clamp(run, max=2 * k)
    return run.max(dim=-1).values, run.argmax(dim=-1)


def _circular_margins(populated):
    """(first, last) of the tightest circular populated window of
    bool[..., 64], or (-1, -1) if empty: the window starts just past the
    longest circular run of empty entries; ``first`` is in centered coords
    [-32, 31] and ``last = first + width - 1`` may exceed 31."""
    gap_len, gap_start = _longest_gap(populated)
    first = (gap_start + gap_len) % N
    first = (first + 32) % N - 32
    last = first + (N - gap_len) - 1
    first = torch.where(gap_len == 0, -32, first)  # fully populated axis
    last = torch.where(gap_len == 0, 31, last)
    any_pop = populated.any(dim=-1)
    return torch.where(any_pop, first, -1), torch.where(any_pop, last, -1)


def xy_bounds(board):
    """[x0, y0, x1, y1] tightest wrap-aware bounding box, or all -1 if
    empty (reference ``XYBounds``, LifeAPI.hpp:446-484, wrap-seam-safe as
    the JAX package's: the box is the complement of the longest circular
    run of empty columns/rows, see PARITY.md)."""
    x0, x1 = _circular_margins(populated_columns(board))
    y0, y1 = _circular_margins(populated_rows(board))
    return torch.stack([x0, y0, x1, y1], dim=-1)


def width_height(board):
    """(width, height) of the populated circular windows (reference
    ``WidthHeight``, LifeAPI.hpp:494-515), 0 for an empty board."""
    def width(populated):
        return torch.where(populated.any(dim=-1), N - _longest_gap(populated)[0], 0)

    return torch.stack([width(populated_columns(board)), width(populated_rows(board))],
                       dim=-1)


def first_on(board):
    """The lexicographically smallest ON cell (x, y), or (-1, -1) if empty
    (reference ``FirstOn``, LifeAPI.hpp:301-323, which names no order)."""
    flat = to_dense(board).flatten(-2).to(torch.uint8)
    idx = flat.argmax(dim=-1)
    found = flat.any(dim=-1).bool()
    return torch.stack([torch.where(found, idx // N, -1),
                        torch.where(found, idx % N, -1)], dim=-1)


def buffer_around(board, size_wh):
    """Reference ``BufferAround`` (LifeAPI.hpp:611-633): the wrap-aware
    rectangle of placements keeping a ``size_wh`` box overlapping the
    pattern's bounding box.  Batched: empty boards give the full board,
    oversize patterns an empty one."""
    b = xy_bounds(board)
    x0, y0, x1, y1 = b.unbind(-1)
    rw = size_wh[0] - (x1 - x0 + 1)
    rh = size_wh[1] - (y1 - y0 + 1)
    lo_x, hi_x = x0 - rw, x1 + rw
    lo_y, hi_y = y0 - rh, y1 + rh
    ix = _bit_index(board.device)
    in_x = torch.remainder(ix - lo_x[..., None], N) <= (hi_x - lo_x)[..., None]
    in_y = torch.remainder(ix - lo_y[..., None], N) <= (hi_y - lo_y)[..., None]
    dense = in_x[..., :, None] & in_y[..., None, :]
    dense = dense & ~((rw < 0) | (rh < 0))[..., None, None]
    dense = dense | (b == -1).all(dim=-1)[..., None, None]
    return from_dense(dense)


def find_set_neighbour(board, cell):
    """An ON cell in the 3x3 window around ``cell`` (including the cell),
    or (-1, -1) (reference ``FindSetNeighbour``, LifeAPI.hpp:360-371; same
    search order).  Host helper on one board."""
    x, y = cell
    d = to_dense(board).cpu().numpy()
    for dx, dy in ((0, 0), (-1, 0), (1, 0), (0, 1), (0, -1), (-1, -1),
                   (-1, 1), (1, -1), (1, 1)):
        cx, cy = torus_wrap(x + dx), torus_wrap(y + dy)
        if d[cx, cy]:
            return (cx, cy)
    return (-1, -1)


def zoi_column(board, i):
    """The vertical ZOI of columns i-1, i, i+1 as one word (reference
    ``ZOIColumn``, LifeAPI.hpp:593-596)."""
    col = board[..., torus_wrap(i - 1)] | board[..., i] | board[..., torus_wrap(i + 1)]
    return col | bitops.rotl64(col, 1) | bitops.rotl64(col, -1)
