"""The port's still-life completion (``lifeapi_tpu_torch.stable.complete``)
against :mod:`lifeapi_tpu.stable.complete`: the beam on CPU tensors (the
plain twin of the beam kernel) against the JAX jnp runner
(``complete_stable_beam(fused=False)``) on the cases of
``tests/test_stable_pallas.py``, the queued runner against per-chunk calls,
and the carried-over host DFS against the JAX package's.  Every comparison
is exact; every board found is checked to be a still life."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.stable import bitplane as JBP
from lifeapi_tpu.stable import complete as JC
from lifeapi_tpu.stable import host as JH
from lifeapi_tpu.stable import propagate as JP
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.core import step as S
from lifeapi_tpu_torch.stable import bitplane as BP
from lifeapi_tpu_torch.stable import complete as C
from lifeapi_tpu_torch.stable import host as H
from lifeapi_tpu_torch.stable import propagate as P
from torch_threads import one_torch_thread  # noqa: F401

N = 64
EATER = "2b2o$bobo$bo$2o!"


def _eater(hide_cells=((20, 20), (21, 20)), ring2=False):
    eater = jb.move(jrle.parse(EATER), 20, 20)
    hide = jb.from_cells(list(hide_cells))
    ring = jb.zoi(jb.zoi(eater)) if ring2 else jb.zoi(eater)
    return eater & ~hide, (ring & ~eater) | hide


def _dense_pair(states, unknowns):
    """JAX and port dense ``Stable`` of the same dense boards."""
    jst = JP.make(state=jnp.asarray(states), unknown=jnp.asarray(unknowns))
    return jst, convert.stable_from_jax(jst, device="cpu")


def _eater_dense(b, **kw):
    st, un = _eater(**kw)
    return _dense_pair(np.broadcast_to(np.asarray(jb.to_dense(st)), (b, N, N)),
                       np.broadcast_to(np.asarray(jb.to_dense(un)), (b, N, N)))


def _random_dense(rng, b):
    states, unknowns = [], []
    for _ in range(b):
        truth = np.zeros((N, N), bool)
        for _ in range(3):
            x, y = rng.integers(8, 52, 2)
            truth[x:x + 2, y:y + 2] = True
        hide = (rng.random((N, N)) < 0.35) & JH.zoi(truth)
        states.append(truth & ~hide)
        unknowns.append(hide | (JH.zoi(truth) & ~truth))
    return _dense_pair(np.stack(states), np.stack(unknowns))


def _check_still_lifes(res, state, unknown):
    """Every found board is a still life that keeps the known ON cells and
    lies inside state | unknown."""
    best = B.from_dense(res.best) if res.best.dtype == torch.bool else res.best
    f = res.found
    assert torch.equal(S.step(best[f]), best[f])
    assert B.is_empty(state[f] & ~best[f]).all()
    assert B.is_empty(best[f] & ~(state[f] | unknown[f])).all()


def _compare(jst, tst, **kw):
    expect = JC.complete_stable_beam(jst, fused=False, **kw)
    got = C.complete_stable_beam(tst, **kw)
    out = convert.beam_result_to_numpy(got)
    for key in ("found", "best_pop", "proved_inconsistent"):
        assert (np.asarray(getattr(expect, key)) == out[key]).all(), key
    assert (np.asarray(expect.best) == out["best"]).all()
    bst = tst if isinstance(tst.ruled, tuple) else BP.from_dense_stable(tst)
    _check_still_lifes(got, bst.state, bst.unknown)
    return got


def test_beam_frontier_2():
    jst, tst = _eater_dense(2)
    got = _compare(jst, tst, frontier=2, iters=10, minimise=True)
    assert got.found.all() and (got.best_pop == 7).all()


def test_beam_batch_33_packed_output():
    jst, tst = _eater_dense(33)
    got = _compare(jst, tst, frontier=4, iters=6, minimise=True, dense=False)
    assert got.best.dtype == torch.int64 and got.best.shape == (33, 64)


def test_beam_sat_unsat_mix_first_solution():
    st, un = (np.asarray(jb.to_dense(x)) for x in _eater())
    lone = np.asarray(jb.to_dense(jb.from_cells([(40, 40)])))
    none = np.zeros((N, N), bool)
    jst, tst = _dense_pair(np.stack([st, lone, st]), np.stack([un, none, un]))
    got = _compare(jst, tst, frontier=8, iters=16, minimise=False)
    assert got.found.tolist() == [True, False, True]
    assert got.proved_inconsistent.tolist() == [False, True, False]


def test_beam_seeded():
    hide = ((20, 20), (21, 20), (22, 21))
    jst, tst = _eater_dense(3, hide_cells=hide, ring2=True)
    seed = _eater(hide_cells=hide)[0]
    expect = JC.complete_stable_beam(jst, frontier=4, iters=24, minimise=True,
                                     fused=False, seed=jnp.broadcast_to(seed, (3, 64, 2)))
    got = C.complete_stable_beam(tst, frontier=4, iters=24, minimise=True,
                                 seed=convert.board_from_packed(seed, device="cpu"))
    out = convert.beam_result_to_numpy(got)
    for key in ("found", "best", "best_pop", "proved_inconsistent"):
        assert (np.asarray(getattr(expect, key)) == out[key]).all(), key
    assert got.found.any()
    bst = BP.from_dense_stable(tst)
    _check_still_lifes(got, bst.state, bst.unknown)


def test_beam_random_instances_frontier_8(rng):
    jst, tst = _random_dense(rng, 6)
    got = _compare(jst, tst, frontier=8, iters=12, minimise=True)
    assert got.found.any()


@pytest.mark.parametrize("bound,found", [(7, False), (8, True)])
def test_beam_init_bound(bound, found):
    st, un = _eater()
    jbst = JBP.make(state=jnp.broadcast_to(st, (4, 64, 2)),
                    unknown=jnp.broadcast_to(un, (4, 64, 2)))
    got = _compare(jbst, convert.bitstable_from_jax(jbst, device="cpu"), frontier=4, iters=24,
                   minimise=True, dense=False, init_bound=bound)
    assert bool(got.found.all()) is found and bool(got.found.any()) is found
    assert (got.best_pop == 7).all()


def test_beam_without_boards_and_simple_phase():
    _, tst = _eater_dense(2)
    res = C.complete_stable_beam(tst, frontier=4, iters=24, return_boards=False)
    assert res.best is None and res.found.all() and (res.best_pop == 7).all()
    with pytest.raises(NotImplementedError):
        C.complete_stable_beam(tst, frontier=4, iters=4, simple_phase=True)
    with pytest.raises(NotImplementedError):
        C.complete_stable_beam_queued(BP.from_dense_stable(tst), simple_phase=True)


def test_queued_equals_per_chunk_calls():
    """The queued runner on 21 rolled eaters (chunk 8) equals the JAX jnp
    runner's per-chunk calls, the port's per-chunk calls and its one
    whole-batch call."""
    st, un = _eater()
    jbst = JBP.make(state=jnp.stack([jnp.roll(st, i, axis=-2) for i in range(21)]),
                    unknown=jnp.stack([jnp.roll(un, i, axis=-2) for i in range(21)]))
    bst = convert.bitstable_from_jax(jbst, device="cpu")
    got = C.complete_stable_beam_queued(bst, chunk=8, frontier=4, iters=16)
    whole = C.complete_stable_beam(bst, frontier=4, iters=16, return_boards=False)
    keys = ("found", "best_pop", "proved_inconsistent")
    for lo in range(0, 21, 8):
        part = BP.BitStable(*(x[lo:lo + 8] for x in bst[:2]),
                            tuple(r[lo:lo + 8] for r in bst.ruled))
        ref = C.complete_stable_beam(part, frontier=4, iters=16, return_boards=False)
        jpart = JBP.BitStable(*(x[lo:lo + 8] for x in jbst[:2]),
                              tuple(r[lo:lo + 8] for r in jbst.ruled))
        expect = JC.complete_stable_beam(jpart, frontier=4, iters=16, fused=False,
                                         return_boards=False)
        for key in keys:
            assert torch.equal(getattr(got, key)[lo:lo + 8], getattr(ref, key)), key
            assert (np.asarray(getattr(expect, key))
                    == getattr(got, key)[lo:lo + 8].numpy()).all(), key
    for key in keys:
        assert torch.equal(getattr(got, key), getattr(whole, key)), key
    assert got.found.all() and (got.best_pop == 7).all()


def test_queued_empty_problem_set():
    empty = BP.make(state=torch.zeros((0, 64), dtype=torch.int64))
    res = C.complete_stable_beam_queued(empty, chunk=8)
    assert res.found.shape == res.best_pop.shape == res.proved_inconsistent.shape == (0,)


def test_host_dfs_matches_jax_dfs():
    eater = np.asarray(jb.to_dense(jb.move(jrle.parse(EATER), 20, 20)))
    hide = np.zeros((N, N), bool)
    hide[20:22, 20] = True
    expect, expect_best = JC.complete_stable(JH.HostStable(eater & ~hide, hide),
                                             timeout=30.0, minimise=True)
    got, best = C.complete_stable(H.HostStable(eater & ~hide, hide), timeout=30.0,
                                  minimise=True)
    assert got.name == expect.name == "COMPLETED"
    assert (best == expect_best).all() and (best == eater).all()
    board = B.from_dense(torch.from_numpy(best))
    assert torch.equal(S.step(board), board)
