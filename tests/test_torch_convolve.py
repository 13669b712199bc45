"""The port's convolution layer (``lifeapi_tpu_torch.core.convolve``, CPU
tensors, so the kernel wrappers take their plain twins) against
:mod:`lifeapi_tpu.core.convolve`, exact, on every route the port can take:
each forced ``method``, the default routes, batched and unbatched."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import convolve as jconv
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.symmetry import transforms as jtr
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.core import convolve as conv
from lifeapi_tpu_torch.core import rle, step
from lifeapi_tpu_torch.ops import conv_cuda
from torch_threads import one_torch_thread  # noqa: F401

EATER = [(0, 0), (1, 0), (0, 1), (2, 1), (2, 2), (2, 3), (3, 3)]


def _pair(dense):
    """(JAX packed board, port board) of one dense numpy field."""
    packed = jb.from_dense(jnp.asarray(dense))
    return packed, convert.board_from_packed(packed, device="cpu")


def _sparse(rng, batch, k, lo=0, hi=64):
    d = np.zeros((*batch, 64, 64), bool)
    for idx in np.ndindex(*batch):
        d[idx][rng.integers(lo, hi, k), rng.integers(lo, hi, k)] = True
    return d


def _same(got, expect):
    if isinstance(got, torch.Tensor) and got.dtype == torch.int64 and got.shape[-1:] == (64,):
        got = convert.board_to_packed(got)
    assert np.array_equal(np.asarray(got), np.asarray(expect))


# operands: (name, dense a, dense b); "s" = at most 48 cells, "d" = dense
def _operands(rng):
    return {
        "unbatched s*s": (_sparse(rng, (), 9), _sparse(rng, (), 7)),
        "unbatched d*s": (rng.random((64, 64)) < 0.3, _sparse(rng, (), 7)),
        "unbatched s*d": (_sparse(rng, (), 7), rng.random((64, 64)) < 0.3),
        "batched d*s": (rng.random((3, 64, 64)) < 0.3, _sparse(rng, (3,), 6)),
        "batched s*d": (_sparse(rng, (3,), 6), rng.random((3, 64, 64)) < 0.3),
        "broadcast d*s": (rng.random((64, 64)) < 0.2, _sparse(rng, (2, 2), 5)),
        "batched d*d": (rng.random((2, 64, 64)) < 0.5, rng.random((2, 64, 64)) < 0.02),
        "dense d*d": (rng.random((2, 64, 64)) < 0.5, rng.random((2, 64, 64)) < 0.5),
    }


# every case through the kernels' routes (but the peel of two p=0.5
# operands, 2000 rounds: "batched d*d" covers it), and the plain transforms
# on a batched and a dense case
ROUTES = ([(case, method) for case in _operands(np.random.default_rng(0))
           for method in (None, "sparse", "ntt_fused")
           if (case, method) != ("dense d*d", "sparse")]
          + [(case, method) for case in ("broadcast d*s", "dense d*d")
             for method in ("fft", "dft", "ntt")])


@pytest.mark.parametrize("case, method", ROUTES)
def test_convolve_matches_jax(case, method):
    da, db = _operands(np.random.default_rng(0))[case]
    (ja, ta), (jb_, tb_) = _pair(da), _pair(db)
    expect = jconv.convolve(ja, jb_, method="fft")
    _same(conv.convolve(ta, tb_, method=method), expect)
    if method is None:
        _same(conv.convolve(ta, tb_, small=False), expect)  # dense counts route
        _same(conv.convolve(ta, tb_, small=True), expect)


@pytest.mark.parametrize("case, method", ROUTES)
def test_convolve_counts_matches_jax(case, method):
    da, db = _operands(np.random.default_rng(0))[case]
    (ja, ta), (jb_, tb_) = _pair(da), _pair(db)
    expect = np.asarray(jconv.convolve_counts(ja, jb_, method="fft"))
    got = conv.convolve_counts(ta, tb_, method=method)
    assert got.dtype == torch.int32
    _same(got, expect)
    if method is None:  # the reference default on this device, too
        _same(got, jconv.convolve_counts(ja, jb_))


def test_dense_counts_need_the_crt(rng):
    (ja, ta), (jb_, tb_) = _pair(rng.random((2, 64, 64)) < 0.5), _pair(rng.random((2, 64, 64)) < 0.5)
    got = conv.convolve_counts(ta, tb_, method="ntt_fused")
    assert int(got.max()) > 257
    _same(got, jconv.convolve_counts(ja, jb_, method="ntt"))


def test_sparse_device_routes_match_jax(rng):
    (ja, ta), (jb_, tb_) = _pair(rng.random((4, 64, 64)) < 0.2), _pair(_sparse(rng, (4,), 11))
    _same(conv.convolve_sparse_device(ta, tb_), jconv.convolve_sparse_device(ja, jb_))
    for n_planes in (None, 3, 13):
        _same(conv.convolve_counts_sparse_device(ta, tb_, n_planes=n_planes),
              jconv.convolve_counts_sparse_device(ja, jb_, n_planes=n_planes))
    _same(conv.convolve_counts_sparse_device(ta, tb_, max_cells=11),
          jconv.convolve_counts_sparse_device(ja, jb_, max_cells=11))
    cells = [(62, 1), (0, 5), (7, 63), (31, 32)]
    _same(conv.convolve_sparse(ta, cells), jconv.convolve_sparse(ja, cells))
    _same(conv.convolve_sparse(ta, []), jconv.convolve_sparse(ja, []))


@pytest.mark.parametrize("small", [None, True, False])
def test_correlate_and_match_match_jax(rng, small):
    state_d = rng.random((3, 64, 64)) < 0.35
    (js, ts) = _pair(state_d)
    pattern = _sparse(rng, (), 100)  # above the 48-cell sparse cap, below 193
    (jp, tp) = _pair(pattern)
    _same(conv.correlate_counts(ts, tp, small=small), jconv.correlate_counts(js, jp))
    _same(conv.match_live(ts, tp, small=small), jconv.match_live(js, jp))
    dead = _sparse(rng, (), 60) & ~pattern
    (jd, td) = _pair(dead)
    _same(conv.match_live_and_dead(ts, tp, td, small=small),
          jconv.match_live_and_dead(js, jp, jd))


def test_match_family_sparse_patterns(rng):
    (js, ts) = _pair(rng.random((3, 64, 64)) < 0.35)
    live, dead = [(0, 0), (1, 0), (0, 1), (2, 1), (62, 63)], [(3, 3), (63, 0), (1, 63)]
    jl, jd = jb.from_cells(live), jb.from_cells(dead)
    tl, td = tb.from_cells(live, device="cpu"), tb.from_cells(dead, device="cpu")
    _same(conv.match_sparse(ts, live), jconv.match_sparse(js, live))
    _same(conv.match_sparse(ts, dead, invert=True), jconv.match_sparse(js, dead, invert=True))
    _same(conv.match_sparse(ts, []), jconv.match_sparse(js, []))
    _same(conv.match_live(ts, tl), jconv.match_live(js, jl))
    _same(conv.match_live_and_dead(ts, tl, td), jconv.match_live_and_dead(js, jl, jd))
    # batched patterns take the correlation route
    _same(conv.match_live(ts, tl.expand(3, 64)), jconv.match_live(js, jl))
    _same(conv.match_live(ts, tb.empty(device="cpu")), jconv.match_live(js, jb.empty()))


def test_match_and_align_with():
    jpat, tpat = jb.from_cells(EATER), tb.from_cells(EATER, device="cpu")
    jstate = jb.move(jpat, 10, 20) | jb.from_cells([(40, 40)])
    tstate = tb.move(tpat, 10, 20) | tb.from_cells([(40, 40)], device="cpu")
    m = conv.match(tstate, tpat)
    _same(m, jconv.match(jstate, jpat))
    assert tb.on_cells(m) == [(10, 20)]
    _same(conv.align_with(tstate, tpat), jconv.align_with(jstate, jpat))
    assert tb.on_cells(conv.match(tstate | tb.from_cells([(9, 19)], device="cpu"), tpat)) == []


def _glider_eater():
    jg = jb.move(jrle.parse("bob$2bo$3o!"), 8, 8)
    je = jb.move(jtr.transform(jrle.parse("2b2o$bobo$bo$2o!"),
                               jtr.SymmetryTransform.Rotate270), 24, 24)
    return (jg, convert.board_from_packed(jg, device="cpu")), (je, convert.board_from_packed(je, device="cpu"))


@pytest.mark.parametrize("method", [None, "sparse", "ntt_fused", "fft"])
def test_interaction_offsets_routes_match_jax(method):
    (jg, tg), (je, te) = _glider_eater()
    expect = np.asarray(jconv.interaction_offsets(jg, je))
    got = conv.interaction_offsets(tg, te, method=method)
    _same(got, expect)
    assert int(tb.population(got)) == int(jb.population(jnp.asarray(expect))) == 71


@pytest.mark.parametrize("method", [None, "sparse", "ntt_fused"])
def test_interaction_offsets_batched_match_jax(rng, method):
    (jg, tg), _ = _glider_eater()
    d = _sparse(rng, (3,), 6, 10, 50)
    jbb, tbb = _pair(d)
    expect = jconv.interaction_offsets(jnp.broadcast_to(jg, (3, 64, 2)), jbb)
    _same(conv.interaction_offsets(tg.expand(3, 64), tbb, method=method), expect)


def test_union_interacting_matches_jax(rng):
    pairs_d = [(_sparse(rng, (), 5), _sparse(rng, (), 8)) for _ in range(3)]
    jpairs = [(_pair(l)[0], _pair(r)[0]) for l, r in pairs_d]
    tpairs = [(_pair(l)[1], _pair(r)[1]) for l, r in pairs_d]
    expect = jconv.union_interacting(jpairs)
    for method in (None, "sparse", "ntt_fused"):
        _same(conv.union_interacting(tpairs, method=method), expect)


def _union_pairs(rng, case):
    """Dense (left, right) pairs for the union of peels: batches of 3."""
    def sparse(k, batch=(3,)):
        return _sparse(rng, batch, k, 16, 48)

    if case == "P1":
        return [(rng.random((3, 64, 64)) < 0.2, sparse(6))]
    if case == "P7":  # the seven mask pairs of interaction_offsets
        (jg, _), _ = _glider_eater()
        a = jnp.broadcast_to(jg, (3, 64, 2))
        b = _pair(sparse(6))[0]
        seen = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jconv, "union_interacting",
                       lambda pairs, method=None: seen.setdefault("pairs", pairs))
            jconv.interaction_offsets(a, b, method="sparse")
        return [(np.asarray(jb.to_dense(l)), np.asarray(jb.to_dense(r))) for l, r in seen["pairs"]]
    if case == "each side smaller":  # per board, left then right is the smaller
        left = np.stack([sparse(3, ()), rng.random((64, 64)) < 0.3, sparse(9, ())])
        right = np.stack([rng.random((64, 64)) < 0.3, sparse(4, ()), sparse(9, ())])
        return [(left, right), (right, left)]
    if case == "empty":  # an empty board on either side, and an empty pair side
        left, right = rng.random((3, 64, 64)) < 0.3, sparse(5)
        left[1] = False
        right[0] = False
        return [(left, right), (right, np.zeros((3, 64, 64), bool))]
    raise ValueError(case)


UNION_CASES = ["P1", "P7", "each side smaller", "empty"]


@pytest.mark.parametrize("case", UNION_CASES)
def test_union_interacting_sparse_matches_jax(rng, case):
    """The union peel's plain version and the sparse route against the JAX
    package's union_interacting(method="sparse"), which peels each board's
    smaller side."""
    pairs_d = _union_pairs(rng, case)
    jpairs = [(_pair(l)[0], _pair(r)[0]) for l, r in pairs_d]
    tpairs = [(_pair(l)[1], _pair(r)[1]) for l, r in pairs_d]
    expect = jconv.union_interacting(jpairs, method="sparse")
    _same(conv_cuda.union_sparse_fused_plain(tpairs), expect)
    _same(conv.union_interacting(tpairs, method="sparse"), expect)
    assert int(jb.population(expect).sum()) > 0


def test_union_interacting_sparse_broadcasts_an_unbatched_side(rng):
    """Unbatched right boards against a batch of left ones: the port takes
    them as [64] or [1, 64]; the JAX package stacks them as [1, 64, 2]."""
    lefts = [rng.random((4, 64, 64)) < 0.15 for _ in range(3)]
    rights = [_sparse(rng, (), k, 20, 40) for k in (1, 5, 30)]
    rights[0][:] = False  # an empty right side
    expect = jconv.union_interacting(
        [(_pair(l)[0], _pair(r[None])[0]) for l, r in zip(lefts, rights)], method="sparse")
    for shape in ((64,), (1, 64)):
        tpairs = [(_pair(l)[1], _pair(r)[1].reshape(shape)) for l, r in zip(lefts, rights)]
        got = conv.union_interacting(tpairs, method="sparse")
        assert got.shape == (4, 64)
        _same(got, expect)
        _same(conv_cuda.union_sparse_fused_plain(tpairs), expect)


def test_union_interacting_sparse_beyond_eight_pairs(rng):
    """More pairs than one launch takes: groups of 8, OR-ed."""
    pairs_d = [(_sparse(rng, (2,), 4, 10, 50), _sparse(rng, (2,), 3, 10, 50)) for _ in range(9)]
    expect = jconv.union_interacting([(_pair(l)[0], _pair(r)[0]) for l, r in pairs_d],
                                     method="sparse")
    _same(conv.union_interacting([(_pair(l)[1], _pair(r)[1]) for l, r in pairs_d],
                                 method="sparse"), expect)


def test_weld_interaction_offsets_sparse_matches_jax_sparse():
    """The frozen-aware weld.interaction_offsets on the reference LifeWeldTest
    fixture, through the union peel against the JAX package's sparse
    route."""
    from lifeapi_tpu import weld as JW
    from lifeapi_tpu_torch import weld as W

    def centered(s, dx=0, dy=0):
        return jb.move(jrle.parse(s), 20 + dx, 20 + dy)

    j = JW.from_required(centered("2b2o$bobo$bo$2o!"),
                         centered("2b2o$b3o$b4o$5o$4o$4o!", -1, -1))
    block = JW.LifeWeld.from_state(centered("2o$2o!"))
    for ja, jb_w in ((j, j), (block, j)):
        ta, tb_w = convert.weld_from_jax(ja, device="cpu"), convert.weld_from_jax(jb_w, device="cpu")
        _same(W.interaction_offsets(ta, tb_w, method="sparse"),
              JW.interaction_offsets(ja, jb_w, method="sparse"))


def test_interaction_offsets_predict_then_simulate():
    """The reference's EaterSelfInteractionTest (tests/InteractionTest.cpp):
    for every non-overlapping placement, interaction_offsets predicts
    exactly whether the union of the two still lifes fails to be still."""
    eater = tb.move(rle.parse("2b2o$bobo$bo$2o!", device="cpu"), 20, 20)
    offsets = tb.to_dense(conv.interaction_offsets(eater, eater))
    grid = torch.tensor([[dx, dy] for dx in range(-10, 10) for dy in range(-10, 10)])
    moved = tb.move_dyn(eater.expand(len(grid), 64), grid[:, 0], grid[:, 1])
    disjoint = tb.are_disjoint(eater, moved)
    together = eater | moved
    interacts = ~tb.equal(step.step(together), together)
    predicted = offsets[grid[:, 0] % 64, grid[:, 1] % 64]
    assert disjoint.sum() > 300
    assert torch.equal(predicted[disjoint], interacts[disjoint])


def test_components_match_jax(rng):
    cells = EATER + [(30 + x, 30 + y) for x, y in EATER] + [(50, 5), (52, 5)]
    jstate, tstate = jb.from_cells(cells), tb.from_cells(cells, device="cpu")
    got, expect = conv.components(tstate), jconv.components(jstate)
    assert len(got) == len(expect) == 3
    for g, e in zip(got, expect):
        _same(g, e)
    seed = tb.cell_mask(31, 30, device="cpu")
    _same(conv.component_containing(tstate, seed),
          jconv.component_containing(jstate, jb.cell_mask(31, 30)))
    _same(conv.default_corona(device="cpu"), jconv.default_corona())
