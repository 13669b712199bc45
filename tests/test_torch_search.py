"""The port's catalyst search (plain twins on CPU) against
:mod:`lifeapi_tpu.search` with ``engine="xla"``, exact on every
``PlacementResult`` field."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu import search as jsearch
from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.symmetry import transforms as tr
from lifeapi_tpu.symmetry.transforms import SymmetryTransform as T
from lifeapi_tpu.target import LifeTarget as JTarget
from lifeapi_tpu_torch import convert, search
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.target import LifeTarget
from torch_threads import one_torch_thread  # noqa: F401

GLIDER_CELLS = [(8, 10), (9, 8), (9, 10), (10, 9), (10, 10)]
EATER_CELLS = [(24, 21), (24, 22), (25, 21), (25, 23), (26, 23), (27, 23), (27, 24)]


def _jax_pair():
    glider = jb.move(jrle.parse("bob$2bo$3o!"), 8, 8)
    eater = jb.move(tr.transform(jrle.parse("2b2o$bobo$bo$2o!"), T.Rotate270), 24, 24)
    return glider, eater


def test_cells_are_the_examples_patterns():
    glider, eater = _jax_pair()
    assert jb.on_cells(glider) == GLIDER_CELLS
    assert jb.on_cells(eater) == EATER_CELLS


@pytest.mark.parametrize("recovery", [False, True])
def test_catalyst_search_matches_xla_engine(rng, recovery):
    glider, eater = _jax_pair()
    offsets = rng.integers(-12, 6, size=(64, 2)).astype(np.int32)
    offsets[:2] = [[0, 0], [2, -1]]
    jtarget = ttarget = None
    if recovery:
        # recover only the eater's body, with no boundary constraint
        jtarget = JTarget(eater, jb.empty())
        ttarget = LifeTarget(convert.board_from_packed(eater, device="cpu"), tb.empty(device="cpu"))
    expect = jsearch.catalyst_search(glider, eater, jnp.asarray(offsets), 16,
                                     recovery_target=jtarget, engine="xla")
    got = convert.placement_to_numpy(search.catalyst_search(
        convert.board_from_packed(glider, device="cpu"), convert.board_from_packed(eater, device="cpu"),
        torch.from_numpy(offsets), 16, recovery_target=ttarget))
    for field in ("offsets", "interacted", "recovered", "reaction_changed", "final"):
        assert (got[field] == np.asarray(getattr(expect, field))).all(), field
    assert got["interacted"].any() and not got["interacted"].all()


def test_example_grid_hits():
    """The example's grid (dx, dy in -8..8) at horizon 100 has 13 hits."""
    offsets = torch.tensor([[dx, dy] for dx in range(-8, 9) for dy in range(-8, 9)])
    result = search.catalyst_search(tb.from_cells(GLIDER_CELLS, device="cpu"),
                                    tb.from_cells(EATER_CELLS, device="cpu"), offsets, 100)
    hits = search.successful_catalysts(result)
    assert int(hits.sum()) == 13
    i = int(torch.nonzero(hits)[0])
    placed = tb.move(tb.from_cells(EATER_CELLS, device="cpu"), *offsets[i].tolist())
    assert torch.equal(result.final[i], placed)  # the glider is eaten


def test_horizon_zero_and_far_catalyst():
    glider = tb.from_cells(GLIDER_CELLS, device="cpu")
    far = tb.move(tb.from_cells(EATER_CELLS, device="cpu"), 20, -5)
    offsets = torch.tensor([[0, 0], [1, 1]])
    for horizon in (0, 12):
        r = search.catalyst_search(glider, far, offsets, horizon)
        assert not r.interacted.any() and r.recovered.all()
        assert not r.reaction_changed.any()


def _both_pairs():
    glider, eater = _jax_pair()
    return (glider, eater), (convert.board_from_packed(glider, device="cpu"), convert.board_from_packed(eater, device="cpu"))


def test_candidate_offsets_match_jax():
    (jg, je), (tg, te) = _both_pairs()
    expect = np.asarray(jsearch.candidate_offsets(jg, je))
    got = search.candidate_offsets(tg, te)
    assert got.shape == (4025, 2) and np.array_equal(got.numpy(), expect)
    area = tb.solid_rect(-8, -8, 17, 17, device="cpu")
    expect = np.asarray(jsearch.candidate_offsets(jg, je, search_area=jb.solid_rect(-8, -8, 17, 17)))
    assert np.array_equal(search.candidate_offsets(tg, te, search_area=area).numpy(), expect)


def test_search_over_candidate_offsets_matches_jax():
    """The slice's catalyst search: the pruned grid at horizon 64."""
    (jg, je), (tg, te) = _both_pairs()
    offsets = search.candidate_offsets(tg, te)
    got = search.catalyst_search(tg, te, offsets, 64)
    expect = jsearch.catalyst_search(jg, je, jsearch.candidate_offsets(jg, je), 64,
                                     engine="xla")
    counts = (int(got.interacted.sum()), int(got.recovered.sum()),
              int(search.successful_catalysts(got).sum()))
    assert counts == (int(expect.interacted.sum()), int(expect.recovered.sum()),
                      int(jsearch.successful_catalysts(expect).sum())) == (195, 3845, 15)
    placed = convert.placement_to_numpy(got)
    for field in ("interacted", "recovered", "reaction_changed", "final"):
        assert (placed[field] == np.asarray(getattr(expect, field))).all(), field


@pytest.mark.parametrize("recovery", [False, True])
def test_all_orientations_match_jax(recovery):
    """Every orientation of the eater over the example's 17 x 17 window of
    candidate offsets, against the JAX sweep."""
    (jg, je), (tg, te) = _both_pairs()
    area = jb.solid_rect(-8, -8, 17, 17)
    joffsets = jsearch.candidate_offsets(jg, je, search_area=area)
    toffsets = search.candidate_offsets(tg, te, search_area=tb.solid_rect(-8, -8, 17, 17, device="cpu"))
    jtarget = JTarget(je, jb.empty()) if recovery else None
    ttarget = LifeTarget(te, tb.empty(device="cpu")) if recovery else None
    expect = jsearch.catalyst_search_all_orientations(jg, je, joffsets, 48, jtarget)
    got = search.catalyst_search_all_orientations(tg, te, toffsets, 48, ttarget)
    assert [int(t) for t, _ in got] == [int(t) for t, _ in expect]
    for (_, g), (_, e) in zip(got, expect):
        placed = convert.placement_to_numpy(g)
        for field in ("offsets", "interacted", "recovered", "reaction_changed", "final"):
            assert (placed[field] == np.asarray(getattr(e, field))).all(), field
    assert sum(int(search.successful_catalysts(r).sum()) for _, r in got) > 0


def test_target_match_and_transformed():
    (jg, je), (tg, te) = _both_pairs()
    jt, tt = JTarget.from_state(je), LifeTarget.from_state(te)
    state_j = jb.move(je, 3, -7) | jg
    state_t = tb.move(te, 3, -7) | tg
    from lifeapi_tpu import target as jtarget_mod
    from lifeapi_tpu_torch import target as target_mod

    got = target_mod.match(state_t, tt)
    assert np.array_equal(convert.board_to_packed(got), np.asarray(jtarget_mod.match(state_j, jt)))
    assert tb.on_cells(got) == [(3, 57)]
    for t in (T.Rotate90, T.ReflectAcrossYeqNegXP1):
        moved = tt.transformed(t)
        expect = jt.transformed(t)
        assert np.array_equal(convert.board_to_packed(moved.wanted), np.asarray(expect.wanted))
        assert np.array_equal(convert.board_to_packed(moved.unwanted),
                              np.asarray(expect.unwanted))
