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
        ttarget = LifeTarget(convert.board_from_packed(eater), tb.empty())
    expect = jsearch.catalyst_search(glider, eater, jnp.asarray(offsets), 16,
                                     recovery_target=jtarget, engine="xla")
    got = convert.placement_to_numpy(search.catalyst_search(
        convert.board_from_packed(glider), convert.board_from_packed(eater),
        torch.from_numpy(offsets), 16, recovery_target=ttarget))
    for field in ("offsets", "interacted", "recovered", "reaction_changed", "final"):
        assert (got[field] == np.asarray(getattr(expect, field))).all(), field
    assert got["interacted"].any() and not got["interacted"].all()


def test_example_grid_hits():
    """The example's grid (dx, dy in -8..8) at horizon 100 has 13 hits."""
    offsets = torch.tensor([[dx, dy] for dx in range(-8, 9) for dy in range(-8, 9)])
    result = search.catalyst_search(tb.from_cells(GLIDER_CELLS),
                                    tb.from_cells(EATER_CELLS), offsets, 100)
    hits = search.successful_catalysts(result)
    assert int(hits.sum()) == 13
    i = int(torch.nonzero(hits)[0])
    placed = tb.move(tb.from_cells(EATER_CELLS), *offsets[i].tolist())
    assert torch.equal(result.final[i], placed)  # the glider is eaten


def test_horizon_zero_and_far_catalyst():
    glider = tb.from_cells(GLIDER_CELLS)
    far = tb.move(tb.from_cells(EATER_CELLS), 20, -5)
    offsets = torch.tensor([[0, 0], [1, 1]])
    for horizon in (0, 12):
        r = search.catalyst_search(glider, far, offsets, horizon)
        assert not r.interacted.any() and r.recovered.all()
        assert not r.reaction_changed.any()
