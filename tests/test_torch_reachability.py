"""The port's reachability prefilter against :mod:`lifeapi_tpu.mpc.reachability`.

Every output is a bit plane or an integer count, so every comparison is
exact: the eater fixtures of ``tests/test_ternary_refined.py`` (whose
hidden cells propagation determines) and gliders at random offsets over
the eater with its 2-ring unknown (40 cells stay unknown after
propagation), plus the JAX tests' known answers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.mpc import reachability as JRC
from lifeapi_tpu.stable import bitplane as JBP
from lifeapi_tpu.target import LifeTarget as JTarget
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.core import step as tstep
from lifeapi_tpu_torch.mpc import reachability as RC
from lifeapi_tpu_torch.target import hamming_cost
from torch_threads import one_torch_thread  # noqa: F401

N = 64
EATER = "2b2o$bobo$bo$2o!"


def _eater_stable(hide_cells, ring2=False):
    """The propagated eater background (unbatched) with the given cells
    hidden, and with its 2-ring unknown if ``ring2``; the target is the
    whole eater.  As ((jax stable, jax target), (port stable, port
    target))."""
    eater = jb.move(jrle.parse(EATER), 20, 20)
    hide = jb.from_cells(list(hide_cells))
    unknown = (jb.zoi(jb.zoi(eater)) & ~eater) | hide if ring2 else hide
    bst = JBP.make(state=eater & ~hide, unknown=unknown)
    res = JBP.propagate(JBP.BitStable(bst.state[None], bst.unknown[None],
                                      tuple(r[None] for r in bst.ruled)))
    assert bool(res.consistent[0])
    jst = JBP.BitStable(res.stable.state[0], res.stable.unknown[0],
                        tuple(r[0] for r in res.stable.ruled))
    jtarget = JTarget.from_state(eater)
    return (jst, jtarget), (convert.bitstable_from_jax(jst, device="cpu"), convert.target_from_jax(jtarget, device="cpu"))


def _same(jax_planes, torch_planes):
    for a, b in zip(jax_planes, torch_planes):
        assert (np.asarray(a) == convert.board_to_packed(b)).all()


def _glider_candidates(rng, jst, n):
    """n candidates: a glider at random offsets in [12, 28)^2 over the
    background, around the eater at (20, 20)."""
    glider = jb.from_cells([(1, 0), (2, 1), (0, 2), (1, 2), (2, 2)])
    offs = rng.integers(12, 28, size=(n, 2))
    return jnp.stack([jst.state | jb.move(glider, int(x), int(y)) for x, y in offs])


@pytest.mark.parametrize("steps", [1, 4])
def test_refined_rollout_and_bounds_on_eater(steps):
    """``test_reachability_bounds_sound_over_completions``' instance: the
    rollout and the bounds equal JAX's."""
    (jst, jtarget), (tst, ttarget) = _eater_stable(((22, 20), (23, 20)))
    jblink = jb.from_cells([(30, 30), (30, 31), (30, 32)])
    jcur = jst.state | jblink
    tcur = convert.board_from_packed(jcur, device="cpu")
    jout = JRC.refined_rollout(jcur, jst.unknown, jst, steps)
    tout = RC.refined_rollout(tcur, tst.unknown, tst, steps)
    _same(jout, tout)
    jl, ju = JRC.hamming_bounds(jout[0], jout[1], jtarget)
    tl, tu = RC.hamming_bounds(tout[0], tout[1], ttarget)
    assert int(tl) == int(jl) and int(tu) == int(ju)
    assert int(tl) <= int(tu)


def test_prune_candidates_known_answer():
    """``test_prune_candidates_keeps_reachable``: the quiet candidate is
    kept and certainly recovers (upper 0), the smashed one is pruned."""
    (jst, jtarget), (tst, ttarget) = _eater_stable(((22, 20),))
    smash = tb.from_cells([(20, 21), (20, 22), (21, 21), (21, 22)], device="cpu")
    initials = torch.stack([tst.state, tst.state | smash])
    keep, lower, upper = RC.prune_candidates(initials, tst, ttarget, steps=4, max_cost=0)
    assert keep.tolist() == [True, False]
    assert int(upper[0]) == 0
    jk, jl, ju = JRC.prune_candidates(convert.board_to_packed(initials), jst, jtarget,
                                      steps=4, max_cost=0)
    assert (keep.numpy() == np.asarray(jk)).all()
    assert (lower.numpy() == np.asarray(jl)).all() and (upper.numpy() == np.asarray(ju)).all()


@pytest.mark.parametrize("ring2", [False, True])
def test_prune_candidates_random(rng, ring2):
    """Gliders at 24 random offsets around the eater, 8 steps: keep, lower
    and upper equal JAX's.  With one hidden cell, which propagation
    determines, the bounds are exact and prune the gliders that break the
    eater; with the 2-ring unknown they leave slack."""
    (jst, jtarget), (tst, ttarget) = _eater_stable(() if ring2 else ((22, 20),), ring2=ring2)
    assert int(tb.population(tst.unknown)) == (40 if ring2 else 0)
    jinit = _glider_candidates(rng, jst, 24)
    tinit = convert.board_from_packed(jinit, device="cpu")
    jk, jl, ju = JRC.prune_candidates(jinit, jst, jtarget, steps=8, max_cost=0)
    tk, tl, tu = RC.prune_candidates(tinit, tst, ttarget, steps=8, max_cost=0)
    assert tk.dtype == torch.bool and tk.shape == (24,)
    assert (tk.numpy() == np.asarray(jk)).all()
    assert (tl.numpy() == np.asarray(jl)).all() and (tu.numpy() == np.asarray(ju)).all()
    assert bool((tl <= tu).all())
    if ring2:
        assert int((tu - tl).min()) > 0
    else:
        assert torch.equal(tl, tu) and tk.any() and not tk.all()


def test_bounds_hold_for_the_completions(rng):
    """For candidates whose glider misses the background's unknown cells,
    the exact Hamming of the completed board (the eater plus the glider)
    after 8 steps lies within [lower, upper]."""
    (jst, _), (tst, ttarget) = _eater_stable((), ring2=True)
    eater = tb.move(convert.board_from_packed(jrle.parse(EATER), device="cpu"), 20, 20)
    tinit = convert.board_from_packed(_glider_candidates(rng, jst, 24), device="cpu")
    glider_cells = tinit & ~tst.state
    clear = tb.is_empty(glider_cells & tst.unknown)
    assert 6 <= int(clear.sum()) < 24
    _, lower, upper = RC.prune_candidates(tinit, tst, ttarget, steps=8, max_cost=0)
    exact = hamming_cost(tstep.step_n(eater | glider_cells, 8), ttarget)
    assert bool(((lower <= exact) & (exact <= upper))[clear].all())
