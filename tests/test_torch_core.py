"""The port's bitboard core against :mod:`lifeapi_tpu.core`, bit for bit.

Inputs are made with numpy from a seed and handed to both packages; the
port's boards go back to the JAX packing through ``convert`` for the
comparison.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.core import step as js
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import bitops as tbits
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.core import rle as trle
from lifeapi_tpu_torch.core import step as ts
from oracle import life_step_dense, random_dense
from torch_threads import one_torch_thread  # noqa: F401

EATER = "2b2o$bobo$bo$2o!"
GLIDER = "bob$2bo$3o!"


def _pair(rng, batch=(12,), p=0.35):
    """The same random boards in both packings: (jax packed, torch int64)."""
    packed = jb.from_dense(jnp.asarray(random_dense(rng, p=p, batch=batch)))
    return packed, convert.board_from_packed(packed, device="cpu")


def _same(jax_out, torch_out):
    """Exact equality of a JAX result and the port's (boards, ints, bools,
    or tuples of them)."""
    if isinstance(jax_out, tuple):
        assert len(jax_out) == len(torch_out)
        for a, b in zip(jax_out, torch_out):
            _same(a, b)
        return
    a = np.asarray(jax_out)
    if torch_out.dtype == torch.int64 and a.dtype == np.uint32 and a.shape[-1:] == (2,):
        b = convert.board_to_packed(torch_out)
    else:
        b = torch_out.numpy()
    assert a.shape == b.shape
    assert (a.astype(np.int64) == b.astype(np.int64)).all()


# ---------------------------------------------------------------------------
# Layout and bit tricks
# ---------------------------------------------------------------------------


def test_convert_roundtrip_and_dense(rng):
    words = rng.integers(0, 2**32, size=(5, 64, 2), dtype=np.uint32)
    t = convert.board_from_packed(words, device="cpu")
    assert t.dtype == torch.int64 and t.shape == (5, 64)
    assert (convert.board_to_packed(t) == words).all()
    assert (tb.to_dense(t).numpy() == np.asarray(jb.to_dense(jnp.asarray(words)))).all()
    d = random_dense(rng, p=0.5, batch=(3,))
    _same(jb.from_dense(jnp.asarray(d)), tb.from_dense(torch.from_numpy(d)))


@pytest.mark.parametrize("k", [0, 1, 5, 31, 32, 33, 63, 64, -1, -40, 130])
def test_rotates_match_uint64(rng, k):
    vals = rng.integers(0, 2**64, size=32, dtype=np.uint64)
    x = torch.from_numpy(vals.view(np.int64))
    r = k % 64
    left = (vals << np.uint64(r)) | (vals >> np.uint64((64 - r) % 64)) if r else vals
    right = (vals >> np.uint64(r)) | (vals << np.uint64((64 - r) % 64)) if r else vals
    assert (tbits.rotl64(x, k).numpy().view(np.uint64) == left).all()
    assert (tbits.rotr64(x, k).numpy().view(np.uint64) == right).all()
    ks = torch.full((32,), k)
    assert (tbits.rotl64(x, ks).numpy().view(np.uint64) == left).all()


def test_popcount_and_shift(rng):
    vals = rng.integers(0, 2**64, size=256, dtype=np.uint64)
    vals[:3] = [0, 2**64 - 1, 2**63]
    x = torch.from_numpy(vals.view(np.int64))
    expect = np.array([bin(int(v)).count("1") for v in vals])
    assert (tbits.popcount64(x).numpy() == expect).all()
    for s in (1, 7, 32, 63):
        assert (tbits.shr64(x, s).numpy().view(np.uint64) == vals >> np.uint64(s)).all()


# ---------------------------------------------------------------------------
# Board operations
# ---------------------------------------------------------------------------

UNARY = {
    "zoi": (jb.zoi, tb.zoi),
    "boundary": (jb.boundary, tb.boundary),
    "zoi_hollow": (jb.zoi_hollow, tb.zoi_hollow),
    "population": (jb.population, tb.population),
    "is_empty": (jb.is_empty, tb.is_empty),
    "step": (js.step, ts.step),
    "step_alt": (js.step_alt, ts.step_alt),
    "count_rows": (js.count_rows, ts.count_rows),
    "neighbour_counts": (js.neighbour_counts, ts.neighbour_counts),
    "interaction_counts": (js.interaction_counts, ts.interaction_counts),
    "interaction_counts_and_next": (js.interaction_counts_and_next,
                                    ts.interaction_counts_and_next),
    "flip_x": (jb.flip_x, tb.flip_x),
    "flip_y": (jb.flip_y, tb.flip_y),
    "transpose": (jb.transpose, tb.transpose),
    "transpose_plain": (lambda b: jb.transpose(b, False), lambda b: tb.transpose(b, False)),
    "mirrored": (jb.mirrored, tb.mirrored),
    "moore_zoi": (jb.moore_zoi, tb.moore_zoi),
    "big_zoi": (jb.big_zoi, tb.big_zoi),
    "nzoi_3": (lambda b: jb.nzoi(b, 3), lambda b: tb.nzoi(b, 3)),
    "populated_columns": (jb.populated_columns, tb.populated_columns),
    "populated_rows": (jb.populated_rows, tb.populated_rows),
    "xy_bounds": (jb.xy_bounds, tb.xy_bounds),
    "width_height": (jb.width_height, tb.width_height),
    "first_on": (jb.first_on, tb.first_on),
    "buffer_around": (lambda b: jb.buffer_around(b, (20, 9)),
                      lambda b: tb.buffer_around(b, (20, 9))),
}


@pytest.mark.parametrize("name", sorted(UNARY))
@pytest.mark.parametrize("p", [0.0, 0.1, 0.45])
def test_unary_ops_bit_exact(rng, name, p):
    jf, tf = UNARY[name]
    packed, t = _pair(rng, p=p)
    _same(jf(packed), tf(t))


BINARY = {
    "equal": (jb.equal, tb.equal),
    "contains": (jb.contains, tb.contains),
    "are_disjoint": (jb.are_disjoint, tb.are_disjoint),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_ops_bit_exact(rng, name):
    jf, tf = BINARY[name]
    a, ta = _pair(rng, p=0.5)
    b, tb_ = _pair(rng, p=0.05)
    for x, y, tx, ty in ((a, b, ta, tb_), (a, a & b, ta, ta & tb_), (a, a, ta, ta)):
        _same(jf(x, y), tf(tx, ty))


@pytest.mark.parametrize("dx, dy", [(0, 0), (1, 0), (0, 1), (-1, -1), (5, -37),
                                    (-64, 70), (31, 32), (-33, 63)])
def test_rolls_and_moves(rng, dx, dy):
    packed, t = _pair(rng, batch=(4,), p=0.2)
    _same(jb.roll_x(packed, dx), tb.roll_x(t, dx))
    _same(jb.roll_y(packed, dy), tb.roll_y(t, dy))
    _same(jb.move(packed, dx, dy), tb.move(t, dx, dy))
    small, tsmall = _pair(rng, batch=(4,), p=0.02)
    _same(jb.contains_moved(packed, small, dx, dy), tb.contains_moved(t, tsmall, dx, dy))
    _same(jb.are_disjoint_moved(packed, small, dx, dy),
          tb.are_disjoint_moved(t, tsmall, dx, dy))


def test_roll_conventions():
    """Result column x holds input column x - dx; row y holds row y - dy."""
    t = tb.from_cells([(3, 7)], device="cpu")
    assert tb.on_cells(tb.roll_x(t, 2)) == [(5, 7)]
    assert tb.on_cells(tb.roll_y(t, -9)) == [(3, 62)]
    assert tb.on_cells(tb.move(t, -4, 60)) == [(63, 3)]


def test_move_dyn_per_board_negative_offsets(rng):
    packed, t = _pair(rng, batch=(24,), p=0.1)
    offs = rng.integers(-70, 70, size=(24, 2)).astype(np.int32)
    expect = jb.move_dyn(packed, jnp.asarray(offs[:, 0]), jnp.asarray(offs[:, 1]))
    o = torch.from_numpy(offs)
    _same(expect, tb.move_dyn(t, o[:, 0], o[:, 1]))
    # one pattern broadcast against per-board offsets
    _same(jb.move_dyn(jnp.broadcast_to(packed[0], (24, 64, 2)),
                      jnp.asarray(offs[:, 0]), jnp.asarray(offs[:, 1])),
          tb.move_dyn(t[0], o[:, 0], o[:, 1]))


def test_cells_and_constructors(rng):
    cells = [(0, 0), (63, 63), (5, 40), (-1, 3), (70, -2)]
    _same(jb.from_cells(cells), tb.from_cells(cells, device="cpu"))
    _same(jb.from_cells(cells, batch=(3,)), tb.from_cells(cells, batch=(3,), device="cpu"))
    assert tb.on_cells(tb.from_cells(cells, device="cpu")) == jb.on_cells(jb.from_cells(cells))
    _same(jb.empty((2,)), tb.empty((2,), device="cpu"))
    _same(jb.full((2,)), tb.full((2,), device="cpu"))
    packed, t = _pair(rng, batch=(), p=0.3)
    for x, y in [(0, 0), (63, 31), (17, 32), (-1, -1), (64, 65)]:
        _same(jb.get_cell(packed, x, y), tb.get_cell(t, x, y))
        for val in (True, False):
            _same(jb.set_cell(packed, x, y, val), tb.set_cell(t, x, y, val))


def test_constructors_and_queries_of_the_board_layer(rng):
    _same(jb.cell_mask(5, 63), tb.cell_mask(5, 63, device="cpu"))
    _same(jb.checkerboard(), tb.checkerboard(device="cpu"))
    _same(jb.checkerboard((2,)), tb.checkerboard((2,), device="cpu"))
    for args in ((3, 60, 5, 9), (-2, -3, 70, 4), (10, 10, 0, 3)):
        _same(jb.solid_rect(*args), tb.solid_rect(*args, device="cpu"))
    _same(jb.solid_rect_xy(2, 3, 7, 4), tb.solid_rect_xy(2, 3, 7, 4, device="cpu"))
    _same(jb.nzoi_around((1, 62), 2), tb.nzoi_around((1, 62), 2, device="cpu"))
    _same(jb.cell_zoi((0, 0)), tb.cell_zoi((0, 0), device="cpu"))
    packed, t = _pair(rng, batch=(3,), p=0.01)
    for i in (0, 17, 63):
        lo, hi = jb.zoi_column(packed, i)
        word = tb.zoi_column(t, i)
        _same(lo, word & 0xFFFFFFFF)
        _same(hi, (word >> 32) & 0xFFFFFFFF)
    one, tone = _pair(rng, batch=(), p=0.02)
    for cell in ((0, 0), (31, 40), (63, 1)):
        assert tb.find_set_neighbour(tone, cell) == jb.find_set_neighbour(one, cell)
    # a pattern across the seam: the wrap-aware bounds agree
    seam = [(62, 63), (63, 0), (0, 1), (1, 1)]
    _same(jb.xy_bounds(jb.from_cells(seam)), tb.xy_bounds(tb.from_cells(seam, device="cpu")))
    _same(jb.width_height(jb.from_cells(seam)), tb.width_height(tb.from_cells(seam, device="cpu")))
    _same(jb.first_on(jb.empty()), tb.first_on(tb.empty(device="cpu")))
    _same(jb.buffer_around(jb.empty(), (3, 3)), tb.buffer_around(tb.empty(device="cpu"), (3, 3)))


def test_random_generator_boards():
    g = torch.Generator().manual_seed(3)
    a = tb.random(g, (64,), device="cpu")
    b = tb.random(torch.Generator().manual_seed(3), (64,), device="cpu")
    assert a.dtype == torch.int64 and a.shape == (64, 64)
    assert torch.equal(a, b)
    assert abs(float(tb.population(a).sum()) / (64 * 4096) - 0.5) < 0.01
    sparse = tb.random(g, (64,), p=0.1, device="cpu")
    assert abs(float(tb.population(sparse).sum()) / (64 * 4096) - 0.1) < 0.01


# ---------------------------------------------------------------------------
# Stepping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 7])
def test_step_n_and_trajectory(rng, n):
    packed, t = _pair(rng, batch=(6,), p=0.35)
    _same(js.step_n(packed, n), ts.step_n(t, n))
    if n:
        _same(js.stepped_trajectory(packed, n), ts.stepped_trajectory(t, n))
    else:
        assert ts.stepped_trajectory(t, 0).shape == (0, 6, 64)


@pytest.mark.parametrize("p", [0.2, 0.37, 0.6])
def test_step_matches_dense_oracle(rng, p):
    d = random_dense(rng, p=p, batch=(16,))
    t = tb.from_dense(torch.from_numpy(d))
    for _ in range(4):
        d = life_step_dense(d)
        t = ts.step(t)
        assert (tb.to_dense(t).numpy() == d).all()


# ---------------------------------------------------------------------------
# RLE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", [EATER, GLIDER, "3o$o2bo$bo!", "x = 3, y = 3\nb2o$2o$bo!",
                                  "7q$$$!!", "2o2$2o!"])
def test_rle_matches_jax(text):
    t = trle.parse(text, device="cpu")
    _same(jrle.parse(text), t)
    moved = tb.move(t, 20, 45)
    assert trle.to_rle(moved) == jrle.to_rle(jb.move(jrle.parse(text), 20, 45))
    assert torch.equal(trle.parse(trle.to_rle(moved), device="cpu"), tb.move(moved, -32, -32))


def test_count_plane_helpers(rng):
    """count_planes_to_int, with_exactly, add_counts and subtract_counts
    (JAX core/step.py:131-175) on the neighbour counts of random boards."""
    ja, ta = _pair(rng, p=0.4)
    jb_, tb_ = _pair(rng, p=0.2)
    jpa, tpa = js.neighbour_counts(ja), ts.neighbour_counts(ta)
    jpb, tpb = js.neighbour_counts(jb_), ts.neighbour_counts(tb_)
    got = ts.count_planes_to_int(*tpa)
    assert got.dtype == torch.int32
    assert (got.numpy() == np.asarray(js.count_planes_to_int(*jpa))).all()
    for n in range(16):
        _same(js.with_exactly(jpa, n), ts.with_exactly(tpa, n))
    _same(js.add_counts(jpa, jpb), ts.add_counts(tpa, tpb))
    _same(js.subtract_counts(jpa, jpb), ts.subtract_counts(tpa, tpb))
    carry = jb.from_dense(jnp.asarray(random_dense(rng, p=0.5, batch=(12,))))
    _same(js.add_counts(jpa, jpb, carry), ts.add_counts(tpa, tpb, convert.board_from_packed(carry, device="cpu")))


@pytest.mark.parametrize("x, y", [(0, 0), (5, 63), (63, 17), (-1, 3), (32, -64)])
def test_step_for_cell(rng, x, y):
    ja, ta = _pair(rng, p=0.4)
    got = ts.step_for_cell(ta, x, y)
    assert got.dtype == torch.bool
    _same(js.step_for_cell(ja, x % 64, y % 64), got)
    expect = life_step_dense(tb.to_dense(ta).numpy())[:, x % 64, y % 64]
    assert (got.numpy() == expect).all()
