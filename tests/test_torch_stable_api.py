"""The port's ``LifeStable`` (``lifeapi_tpu_torch.stable.api``) against
:class:`lifeapi_tpu.stable.api.LifeStable`, method by method, on the
reference eater instance.  Bit-exact, except the portfolio, whose random
translations differ between the packages: both champions are checked as
still lifes of the same instance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.stable.api import LifeStable as JLS
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.stable import options as opt
from lifeapi_tpu_torch.stable.api import LifeStable
from lifeapi_tpu_torch.stable.complete import CompletionResult
from lifeapi_tpu_torch.symmetry.transforms import SymmetryTransform
from oracle import life_step_dense
from torch_threads import one_torch_thread  # noqa: F401

EATER = "2b2o$bobo$bo$2o!"


def _pair(hide=((20, 20), (21, 20))):
    e = jb.move(jrle.parse(EATER), 20, 20)
    h = jb.from_cells(list(hide))
    state, unknown = e & ~h, (jb.zoi(e) & ~e) | h
    j = JLS.from_boards(state=state, unknown=unknown)
    t = LifeStable.from_boards(state=convert.board_from_packed(state, device="cpu"),
                               unknown=convert.board_from_packed(unknown, device="cpu"))
    _same(convert.lifestable_from_jax(j, device="cpu"), j)
    return j, t


def _same(t, j):
    for name in ("state", "unknown", "ruled"):
        assert (getattr(t.data, name).numpy() == np.asarray(getattr(j.data, name))).all()


def _same_board(t, j):
    assert (convert.board_to_packed(t) == np.asarray(j)).all()


def _same_flags(t, j):
    assert (t.numpy() == np.asarray(j)).all()


def test_construction_and_views():
    j, t = _pair()
    _same(t, j)
    _same_board(t.state, j.state)
    _same_board(t.unknown, j.unknown)
    jp, _, _ = j.propagate()
    tp, _, _ = t.propagate()
    for name in ("live2", "live3", "dead0", "dead1", "dead2", "dead4", "dead5", "dead6"):
        _same_board(tp.plane(name), jp.plane(name))
    dev = LifeStable.from_boards(batch=(2,), device=torch.device("cpu"))
    assert dev.data.state.shape == (2, 64, 64)


@pytest.mark.parametrize("method", ["propagate", "propagate_simple", "stabilise_options",
                                    "propagate_and_test"])
def test_propagation_methods(method):
    j, t = _pair()
    jo, jc, jch = getattr(j, method)()
    to, tc, tch = getattr(t, method)()
    _same(to, jo)
    _same_flags(tc, jc)
    _same_flags(tch, jch)


def test_cell_ops_and_lattice():
    j, t = _pair()
    cells_j = jb.from_cells([(19, 21), (24, 24)])
    cells_t = convert.board_from_packed(cells_j, device="cpu")
    _same(t.set_on(cells_t), j.set_on(cells_j))
    _same(t.set_off(cells_t), j.set_off(cells_j))
    _same(t.restrict_options(cells_t, opt.DEAD_MASK), j.restrict_options(cells_j, opt.DEAD_MASK))
    _same(t.set_cell_on((3, 4)), j.set_cell_on((3, 4)))
    _same(t.set_cell_off((3, 4)), j.set_cell_off((3, 4)))
    assert int(t.get_options((20, 21))) == int(j.get_options((20, 21)))
    tp, _, _ = t.propagate()
    jp, _, _ = j.propagate()
    assert tp.singleton_options((22, 22)) == jp.singleton_options((22, 22))
    _same(t.join(tp), j.join(jp))
    _same(t.graft(tp), j.graft(jp))
    _same(tp.clear_unmodified(), jp.clear_unmodified())
    _same_board(t.differences(tp), j.differences(jp))
    assert bool(t.compatible_with(tp)) == bool(j.compatible_with(jp))
    e = jb.move(jrle.parse(EATER), 20, 20)
    assert bool(tp.compatible_with(convert.board_from_packed(e, device="cpu"))) == bool(jp.compatible_with(e))
    _same_board(tp.perturbed_unknowns(), jp.perturbed_unknowns())
    _same_board(tp.vulnerable(), jp.vulnerable())
    cell = jb.from_cells([(22, 23)])
    to, tc, tch = tp.test_unknowns(convert.board_from_packed(cell, device="cpu"))
    jo, jc, jch = jp.test_unknowns(cell)
    _same(to, jo)
    assert bool(tc) == bool(jc) and bool(tch) == bool(jch)


def test_moved_transformed_rle():
    j, t = _pair()
    _same(t.moved(3, -4), j.moved(3, -4))
    _same(t.transformed(SymmetryTransform.Rotate90),
          j.transformed(SymmetryTransform.Rotate90))
    back = t.transformed(SymmetryTransform.Rotate90).transformed(SymmetryTransform.Rotate270)
    _same(back, j)
    assert t.rle() == j.rle() and t.rle_with_header() == j.rle_with_header()


def test_sanity_check_matches_jax_invariants():
    from lifeapi_tpu.utils import debug as jdebug
    from lifeapi_tpu_torch.utils import debug

    j, t = _pair()
    jp, tp = j.propagate()[0], t.propagate()[0]
    tp.sanity_check()
    broken = (tp.data._replace(unknown=tp.data.unknown | tp.data.state),
              jp.data._replace(unknown=jp.data.unknown | jp.data.state))
    # unpropagated, the known-ON cells still have their dead options open
    for tst, jst in ((t.data, j.data), (tp.data, jp.data), broken):
        got, want = debug.check_stable_invariants(tst), jdebug.check_stable_invariants(jst)
        assert {k: bool(v) for k, v in got.items()} == {k: bool(v) for k, v in want.items()}
    for st in (t, LifeStable(broken[0])):
        with pytest.raises(AssertionError):
            st.sanity_check()
    debug.check_board(t.state)


def test_complete_stable_matches_jax():
    j, t = _pair()
    jr, jbest = j.complete_stable(timeout=30.0, minimise=True)
    tr, tbest = t.complete_stable(timeout=30.0, minimise=True)
    assert tr == CompletionResult.COMPLETED and tr.name == jr.name
    _same_board(tbest, jbest)
    d = B.to_dense(tbest).numpy()
    assert (life_step_dense(d) == d).all()


def test_beam_and_portfolio():
    j, t = _pair()
    jb8 = JLS(jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (3,) + x.shape), j.data))
    tb8 = LifeStable(type(t.data)(*(x.expand(3, 64, 64) for x in t.data)))
    jres = jb8.complete_stable_beam(frontier=4, iters=24)
    tres = tb8.complete_stable_beam(frontier=4, iters=24)
    assert (tres.found.numpy() == np.asarray(jres.found)).all() and tres.found.all()
    assert (tres.best_pop.numpy() == np.asarray(jres.best_pop)).all()
    assert (tres.best.numpy() == np.asarray(jres.best)).all()
    res = t.complete_stable_portfolio(torch.Generator().manual_seed(0), replicas=16,
                                      frontier=4, iters=24)
    assert res.found and res.best_pop == 7
    d = B.to_dense(res.best).numpy()
    assert (life_step_dense(d) == d).all()
    assert B.is_empty(t.state & ~res.best)
