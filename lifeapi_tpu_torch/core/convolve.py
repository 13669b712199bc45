"""Torus convolution, pattern matching and interaction prediction.

Counterpart of :mod:`lifeapi_tpu.core.convolve` (reference LifeAPI.hpp:427-444,
:1066-1095, :1284-1370).  The contract is the reference's index-sum
OR-"convolution": bit (x, y) of the result is set iff there are cells (a, b)
of ``a`` and (c, d) of ``b`` with a + c == x and b + d == y mod 64.  The
count variants give the number of such pairs (at most 4096).

Routing.  The JAX package picks a route by whether an operand is a tracer or
concrete (host-known), and on a TPU (its ``_prefer_ntt()``) takes its fused
kernels.  A torch tensor is always concrete, so the default routes here are
the ones JAX takes on a TPU when called eagerly; on both devices the port
routes the same way, and only the kernel wrappers of
:mod:`lifeapi_tpu_torch.ops.conv_cuda` decide between kernel (CUDA tensor)
and plain twin (CPU tensor).  The routes JAX reaches only under ``jit`` are
reached here by explicit arguments: ``method="sparse"`` (the peel kernels),
``method="ntt_fused"`` (the dense counts kernel) and ``small=True`` (the
single-prime kernels).  Every route is exact, so the result never depends on
the route.

The probes that pick a route (:func:`_host_cells`, :func:`_max_pop`,
:func:`_auto_small`) read a population back to the host, which waits for the
device.
"""

from __future__ import annotations

import torch

from . import board as board_mod
from . import ntt
from ..ops import conv_cuda
from .board import from_dense, mirrored, to_dense

N = 64
SPARSE_MAX_CELLS = 48  # host-known operands up to this population take a sparse route


# ---------------------------------------------------------------------------
# Dense transforms (the JAX ``_conv_real`` methods, plain PyTorch)
# ---------------------------------------------------------------------------


def _dft_matrix(device):
    k = torch.arange(N, dtype=torch.float64, device=device)
    return torch.exp(-2j * torch.pi * torch.outer(k, k) / N)


def _dft2(x, w):
    """2D DFT as two complex matmuls (contract y, then x)."""
    return w @ (x @ w)


def _conv_real(da, db, method):
    """Circular convolution of dense [..., 64, 64] 0/1 fields, as float
    counts (exact after rounding): ``"fft"`` (torch.fft in float32, as the
    JAX CPU default), ``"dft"`` (complex matmuls) or ``"ntt"`` (the
    two-prime number-theoretic transform, exact in integers)."""
    if method == "ntt":
        return ntt.counts(da, db).to(torch.float64)
    if method == "dft":
        w = _dft_matrix(da.device)
        fa = _dft2(da.to(torch.complex128), w)
        fb = _dft2(db.to(torch.complex128), w)
        return _dft2(fa * fb, w.conj()).real / (N * N)
    if method == "fft":
        fa = torch.fft.rfft2(da.to(torch.float32))
        fb = torch.fft.rfft2(db.to(torch.float32))
        return torch.fft.irfft2(fa * fb, s=(N, N))
    raise ValueError(f"unknown convolution method {method!r}")


def _broadcast_dense(da, db):
    shape = torch.broadcast_shapes(da.shape, db.shape)
    return (shape, da.expand(shape).reshape(-1, N, N),
            db.expand(shape).reshape(-1, N, N))


def _counts_fused(da, db):
    """The dense counts kernel over the flattened batch."""
    shape, da, db = _broadcast_dense(da, db)
    return conv_cuda.conv_counts_fused(da, db).reshape(shape)


# ---------------------------------------------------------------------------
# Routing probes (each reads back to the host)
# ---------------------------------------------------------------------------


def _host_cells(board):
    """ON cells of an unbatched board (``int64[64]``), else None."""
    if board.dim() != 1:
        return None
    return board_mod.on_cells(board)


def _max_pop(board):
    """The largest population over the batch."""
    return int(board_mod.population(board).max())


def _auto_small(*boards):
    """True when some operand has population < 193 on every board: then
    every count is below 193 and the single-prime route is exact."""
    return any(_max_pop(b) < conv_cuda.MODULUS for b in boards)


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


def convolve_sparse(a, cells):
    """OR-convolution of ``a`` with a host-known cell list: the OR of ``a``
    translated by each cell (the reference's run-decomposition
    ``Convolve``, LifeAPI.hpp:1284-1370, as packed-word translations)."""
    out = torch.zeros_like(a)
    for x, y in cells:
        out = out | board_mod.move(a, int(x), int(y))
    return out


def convolve_sparse_device(a, b):
    """OR-convolution with a runtime-sparse operand ``b``: the peel kernel,
    one round per ON cell of each board's ``b``; exact for any population."""
    return conv_cuda.convolve_sparse_fused(a, b)


def convolve_counts_sparse_device(a, b, max_cells=None, n_planes=None):
    """Exact convolution counts ``int32[..., 64, 64]`` with a runtime-sparse
    operand ``b``: the peel kernel ripple-adding into ``n_planes`` counter
    planes, exact up to ``2**n_planes - 1``.  ``n_planes=None`` is the
    smallest width for a proven bound ``max_cells``, else 13, which holds
    every count."""
    if n_planes is None:
        n_planes = max(1, int(max_cells).bit_length()) if max_cells is not None else 13
    planes = conv_cuda.counts_sparse_fused(a, b, n_planes=n_planes)
    out = torch.zeros(planes[0].shape[:-1] + (N, N), dtype=torch.int32,
                      device=planes[0].device)
    for i, p in enumerate(planes):
        out += to_dense(p).to(torch.int32) << i
    return out


def convolve_counts(a, b, method=None):
    """Circular convolution counts ``int32[..., 64, 64]``: entry (x, y)
    counts the pairs of ON cells (p in a, q in b) with p + q == (x, y).

    Default: a ``b`` of population <= 48 on every board takes the sparse
    counts kernel, anything else the dense counts kernel
    (``method="ntt_fused"``).  Like the reference it tests only ``b`` and
    never commutes (ROADMAP Queue 3).  ``method="sparse"`` forces the peel;
    ``"fft"``, ``"dft"`` and ``"ntt"`` the plain transforms."""
    if method == "sparse":
        return convolve_counts_sparse_device(a, b)
    if method is None:
        mp = _max_pop(b)
        if mp <= SPARSE_MAX_CELLS:
            return convolve_counts_sparse_device(a, b, max_cells=mp)
        method = "ntt_fused"
    if method == "ntt_fused":
        return _counts_fused(to_dense(a), to_dense(b))
    return torch.round(_conv_real(to_dense(a), to_dense(b), method)).to(torch.int32)


def convolve(a, b, method=None, small=None):
    """OR-convolution (dilation of a by b), bit-identical to the reference
    ``LifeState::Convolve`` (LifeAPI.hpp:1293-1370).

    Default routes, in order: an unbatched operand with <= 48 cells takes
    the host shift-OR (:func:`convolve_sparse`); a batched operand with
    <= 48 cells on every board the peel kernel; otherwise, when some
    operand has fewer than 193 cells on every board (or ``small=True``), the
    packed single-prime kernel; else the dense counts kernel.
    ``method="sparse"`` peels the sparser operand; ``"ntt_fused"``, ``"fft"``,
    ``"dft"`` and ``"ntt"`` force a dense route."""
    if method is None:
        for x, y in ((a, b), (b, a)):  # convolution commutes
            cells = _host_cells(y)
            if cells is not None and len(cells) <= SPARSE_MAX_CELLS:
                return convolve_sparse(x, cells)
        for x, y in ((a, b), (b, a)):
            if _max_pop(y) <= SPARSE_MAX_CELLS:
                return convolve_sparse_device(x, y)
    if method == "sparse":
        if _max_pop(a) < _max_pop(b):
            a, b = b, a  # peel the sparser side
        return convolve_sparse_device(a, b)
    if method is None:
        if small is None:
            small = _auto_small(a, b)
        if small:
            shape = torch.broadcast_shapes(a.shape, b.shape)
            out = conv_cuda.conv_small_packed(a.expand(shape).reshape(-1, N),
                                              b.expand(shape).reshape(-1, N))
            return out.reshape(shape)
        method = "ntt_fused"
    if method == "ntt_fused":
        return from_dense(_counts_fused(to_dense(a), to_dense(b)) > 0)
    return from_dense(_conv_real(to_dense(a), to_dense(b), method) > 0.5)


def correlate_counts(state, pattern, small=None):
    """``int32[..., 64, 64]``: entry (dx, dy) counts the ON cells of
    ``pattern`` that land on ON cells of ``state`` when moved by (dx, dy),
    i.e. ``convolve_counts(state, mirrored(pattern))``.  When ``pattern``
    has fewer than 193 cells on every board (or ``small=True``) the
    single-prime kernel computes it; its results are counts mod 193."""
    if small is None:
        small = _auto_small(pattern)
    if small:
        shape, da, db = _broadcast_dense(to_dense(state), to_dense(mirrored(pattern)))
        return conv_cuda.conv_small_fused(da, db, out_or=False).reshape(shape)
    return convolve_counts(state, mirrored(pattern))


# ---------------------------------------------------------------------------
# Matching (reference LifeAPI.hpp:427-444)
# ---------------------------------------------------------------------------


def match_sparse(state, cells, invert=False):
    """Translations at which every cell of ``cells`` lands on an ON
    (``invert=False``) or OFF cell of ``state``: the AND of ``state`` (or
    its complement) translated by each -cell.  No cells match everywhere."""
    src = ~state if invert else state
    out = torch.full_like(state, -1)
    for x, y in cells:
        out = out & board_mod.move(src, -int(x), -int(y))
    return out


def match_live(state, live, small=None):
    """Translations (dx, dy) at which every ON cell of ``live`` is ON in
    ``state`` (reference ``MatchLive``, LifeAPI.hpp:427-430)."""
    cells = _host_cells(live)
    if cells is not None and len(cells) <= SPARSE_MAX_CELLS:
        return match_sparse(state, cells)
    return from_dense(correlate_counts(~state, live, small=small) == 0)


def match_live_and_dead(state, live, dead, small=None):
    """Translations at which ``live`` is fully ON and ``dead`` fully OFF in
    ``state`` (reference ``MatchLiveAndDead``, LifeAPI.hpp:432-435)."""
    lcells, dcells = _host_cells(live), _host_cells(dead)
    if (lcells is not None and dcells is not None
            and len(lcells) <= SPARSE_MAX_CELLS and len(dcells) <= SPARSE_MAX_CELLS):
        return match_sparse(state, lcells) & match_sparse(state, dcells, invert=True)
    misses = correlate_counts(~state, live, small=small)
    hits = correlate_counts(state, dead, small=small)
    return from_dense((misses == 0) & (hits == 0))


def match(state, live):
    """Reference ``Match(live)`` (LifeAPI.hpp:440-442): live cells ON and
    the boundary of live OFF."""
    return match_live_and_dead(state, live, board_mod.boundary(live))


def align_with(state, other):
    """Translate ``state`` so it aligns with ``other`` (reference
    ``AlignWith``, LifeAPI.hpp:738-741)."""
    offset = board_mod.first_on(match(state, other))
    return board_mod.move_dyn(state, -offset[..., 0], -offset[..., 1])


# ---------------------------------------------------------------------------
# Interaction prediction (reference LifeAPI.hpp:1066-1095)
# ---------------------------------------------------------------------------


def interaction_offsets(a, b, method=None):
    """All translations of ``b`` that would interact with ``a`` (change the
    next generation of either), reference ``InteractionOffsets``
    (LifeAPI.hpp:1066-1095): the union of the OR-convolutions of the seven
    pairs of :func:`interaction_pairs`.  ``method`` as
    :func:`union_interacting`."""
    return union_interacting(interaction_pairs(a, b), method=method)


def interaction_pairs(a, b):
    """The seven (left, right) pairs of neighbour-count classified masks
    (overlaps, birth pairs, overcrowding) whose OR-convolutions
    :func:`interaction_offsets` unites."""
    from .step import neighbour_counts

    def masks(state):
        bit3, bit2, bit1, bit0 = neighbour_counts(state)
        out1 = ~bit3 & ~bit2 & ~bit1 & bit0
        out2 = ~bit3 & ~bit2 & bit1 & ~bit0
        out3 = ~bit3 & ~bit2 & bit1 & bit0
        ge1 = bit3 | bit2 | bit1 | bit0
        ge2 = bit3 | bit2 | bit1
        ge4 = bit2 | bit3
        return out1, out2, out3, ge1, ge2, ge4

    a1, a2, a3, a_ge1, a_ge2, a_ge4 = masks(a)
    b = mirrored(b)
    b1, b2, b3, b_ge1, b_ge2, b_ge4 = masks(b)
    return [
        (a, b),
        (a1 & ~a, b2 & ~b),
        (b1 & ~b, a2 & ~a),
        (a3 & a, b_ge2 & ~b),
        (a_ge4 & a, b_ge1 & ~b),
        (b3 & b, a_ge2 & ~a),
        (b_ge4 & b, a_ge1 & ~a),
    ]


def union_interacting(pairs, method=None):
    """OR over (left, right) pairs of their OR-convolutions, the routing
    engine of the interaction-offsets family.  ``method="sparse"``: the
    union peel (:func:`..ops.conv_cuda.union_sparse_fused`), one launch a
    group of up to 8 pairs, each board peeling its smaller side.  Default:
    unbatched masks of <= 48 cells take per-pair host shift-ORs.  Otherwise
    one batched counts call over the stacked pairs, routed by
    :func:`convolve_counts` with ``method`` (``"ntt_fused"``: the dense
    counts kernel)."""
    if method == "sparse":
        out = None
        for i in range(0, len(pairs), conv_cuda.MAX_PAIRS):
            u = conv_cuda.union_sparse_fused(pairs[i:i + conv_cuda.MAX_PAIRS])
            out = u if out is None else out | u
        return out

    def pair_sparse(left, right):
        for p in (right, left):
            c = _host_cells(p)
            if c is not None and len(c) <= SPARSE_MAX_CELLS:
                return True
        return False

    if method is None and all(pair_sparse(l, r) for l, r in pairs):
        out = None
        for l, r in pairs:
            c = convolve(l, r)
            out = c if out is None else out | c
        return out

    lefts = torch.stack(torch.broadcast_tensors(*[l for l, _ in pairs]))
    rights = torch.stack(torch.broadcast_tensors(*[r for _, r in pairs]))
    counts = convolve_counts(lefts, rights, method=method)
    return from_dense((counts > 0).any(dim=0))


# ---------------------------------------------------------------------------
# Components (reference LifeAPI.hpp:655-676, :1184-1188)
# ---------------------------------------------------------------------------


def default_corona(device=None):
    """5x5 square minus corners, centered (reference "b3o$5o$5o$5o$b3o!"
    moved (-2, -2), LifeAPI.hpp:1186)."""
    return board_mod.from_cells(
        [(dx, dy) for dx in range(-2, 3) for dy in range(-2, 3)
         if not (abs(dx) == 2 and abs(dy) == 2)], device=device)


def component_containing(state, seed, corona=None):
    """Connected component of the unbatched ``state`` containing ``seed``,
    by repeated corona dilation (reference ``ComponentContaining``,
    LifeAPI.hpp:655-665, with the intended center-included corona)."""
    if corona is None:
        corona = default_corona(state.device)
    result = torch.zeros_like(state)
    tocheck = seed
    while not bool(board_mod.is_empty(tocheck)):
        neighbours = convolve(tocheck, corona) & state
        tocheck = neighbours & ~result
        result = result | neighbours
    return result


def components(state, corona=None):
    """List of connected components of an unbatched board (reference
    ``Components``, LifeAPI.hpp:667-676)."""
    if corona is None:
        corona = default_corona(state.device)
    result = []
    remaining = state
    while not bool(board_mod.is_empty(remaining)):
        x, y = board_mod.first_on(remaining).tolist()
        comp = component_containing(remaining, board_mod.cell_mask(x, y, state.device),
                                    corona)
        result.append(comp)
        remaining = remaining & ~comp
    return result
