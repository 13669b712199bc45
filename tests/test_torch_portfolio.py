"""The port's portfolio search (``complete_stable_portfolio`` and its
helpers in ``lifeapi_tpu_torch.stable.complete``) against
:mod:`lifeapi_tpu.stable.complete`.  The translations are JAX's own draws
from ``jax.random``, handed to the port through ``draw_offsets``, so the
whole search compares bit for bit (the port's beam twin equals the JAX jnp
runner)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.stable import complete as JC
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.stable import complete as C
from lifeapi_tpu_torch.stable import bitplane as BP
from oracle import life_step_dense
from torch_threads import one_torch_thread  # noqa: F401

EATER = "2b2o$bobo$bo$2o!"
R, ITERS = 32, 24  # one shape for every JAX call, so its compiles are shared


def _jax_draws(key, replicas):
    """``complete_stable_portfolio``'s translations for ``key``."""
    kx, ky = jax.random.split(key)
    return (jax.random.randint(kx, (replicas,), 0, 64),
            jax.random.randint(ky, (replicas,), 0, 64))


def use_jax_draws(monkeypatch, *draws):
    """Make the port's ``draw_offsets`` return ``draws`` in order."""
    it = iter(draws)
    monkeypatch.setattr(C, "draw_offsets", lambda generator, replicas, device=None:
                        tuple(_tt(d).to(device) for d in next(it)))


def _eater_instance(hide=((20, 20), (21, 20), (22, 20))):
    eater = jb.move(jrle.parse(EATER), 20, 20)
    h = jb.from_cells(list(hide))
    return eater & ~h, (jb.zoi(eater) & ~eater) | h


def _t(x):
    return convert.board_from_packed(x, device="cpu")


def _tt(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def test_build_replicas_and_champion_match_jax():
    state, unknown = _eater_instance()
    dx, dy = _jax_draws(jax.random.key(5), R)
    js, ju = JC._build_replicas(state, unknown, dx, dy)
    ts, tu = C._build_replicas(_t(state), _t(unknown), _tt(dx), _tt(dy))
    assert (convert.board_to_packed(ts) == np.asarray(js)).all()
    assert (convert.board_to_packed(tu) == np.asarray(ju)).all()
    from lifeapi_tpu.stable import bitplane as JBP

    jres = JC.complete_stable_beam(JBP.make(state=js, unknown=ju), frontier=4, iters=ITERS,
                                   dense=False, fused=False)
    tres = C.complete_stable_beam(BP.make(state=ts, unknown=tu), frontier=4, iters=ITERS,
                                  dense=False)
    jpop, jchamp = JC._portfolio_champion(jres, dx, dy)
    tpop, tchamp = C._portfolio_champion(tres, _tt(dx), _tt(dy))
    assert tpop == jpop
    assert (convert.board_to_packed(tchamp) == np.asarray(jchamp)).all()
    none = tres._replace(found=torch.zeros_like(tres.found))
    assert C._portfolio_champion(none, _tt(dx), _tt(dy)) == (None, None)


@pytest.mark.parametrize("reminimise", [False, True])
def test_portfolio_reconstructs_eater_as_jax(reminimise, monkeypatch):
    state, unknown = _eater_instance()
    key = jax.random.key(0)
    want = JC.complete_stable_portfolio(state, unknown, key, replicas=R, frontier=4,
                                        iters=ITERS, fused=False, reminimise=reminimise)
    use_jax_draws(monkeypatch, _jax_draws(key, R))
    got = C.complete_stable_portfolio(_t(state), _t(unknown), replicas=R, frontier=4,
                                      iters=ITERS, reminimise=reminimise)
    out = convert.portfolio_result_to_numpy(got)
    assert out["found"] and want.found
    assert out["best_pop"] == want.best_pop and out["found_fraction"] == want.found_fraction
    assert (out["best"] == np.asarray(want.best)).all()
    d = B.to_dense(got.best).numpy()
    assert (life_step_dense(d) == d).all()
    assert B.is_empty(_t(state) & ~got.best)
    assert B.is_empty(got.best & ~(_t(state) | _t(unknown)))


def test_portfolio_explore_and_polish_as_jax(monkeypatch):
    """explore draws fresh translations (JAX: fold_in(key, 2)); the DFS
    polish is bounded by the champion."""
    state, unknown = _eater_instance(hide=((20, 20), (21, 20)))
    key = jax.random.key(7)
    want = JC.complete_stable_portfolio(state, unknown, key, replicas=R, frontier=4,
                                        iters=ITERS, fused=False, explore=True,
                                        dfs_polish_timeout=5.0)
    use_jax_draws(monkeypatch, _jax_draws(key, R), _jax_draws(jax.random.fold_in(key, 2), R))
    got = C.complete_stable_portfolio(_t(state), _t(unknown), replicas=R, frontier=4,
                                      iters=ITERS, explore=True, dfs_polish_timeout=5.0)
    assert got.found and got.best_pop == want.best_pop
    assert (convert.board_to_packed(got.best) == np.asarray(want.best)).all()


def test_portfolio_unsat_instance():
    lone = jb.from_cells([(40, 40)])
    none = jnp.zeros((64, 2), jnp.uint32)
    want = JC.complete_stable_portfolio(lone, none, jax.random.key(1), replicas=R,
                                        frontier=4, iters=ITERS, fused=False)
    got = C.complete_stable_portfolio(_t(lone), _t(none), torch.Generator().manual_seed(1),
                                      replicas=R, frontier=4, iters=ITERS)
    assert not got.found and not want.found
    assert got.found_fraction == want.found_fraction == 0.0
    assert (convert.board_to_packed(got.best) == np.asarray(want.best)).all()


def test_draw_offsets_follow_the_generator():
    a = C.draw_offsets(torch.Generator().manual_seed(9), 64, device="cpu")
    b = C.draw_offsets(torch.Generator().manual_seed(9), 64, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(int(x.min()) >= 0 and int(x.max()) < 64 for x in a)


def test_portfolio_example_runs_on_cpu():
    """examples/portfolio_minimise.py's port at a small size: a still life
    on both anchors, inside the unknown area; the instance's minimum is the
    pop-6 barge."""
    from lifeapi_tpu_torch.examples import portfolio_minimise

    r = portfolio_minimise.run("cpu", replicas=R, iters=96)
    assert r["result"].found and r["still_life"] and r["anchors_on"] and r["inside_area"]
    assert r["result"].best_pop >= 6
