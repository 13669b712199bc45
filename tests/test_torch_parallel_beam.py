"""The beam runners of ``lifeapi_tpu_torch.parallel.elite`` at world size 1,
in process, against :mod:`lifeapi_tpu.parallel.elite` (``engine="jnp"``,
the beam the port's is held to) on its 8-device CPU mesh and on a 1-device
mesh: found flags, boards, populations, champions and the found fraction
exactly.  The portfolio's translations come from ``jax.random`` in JAX; the
port's ``_portfolio`` takes the same translations.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.parallel import elite as jelite
from lifeapi_tpu.parallel import make_mesh as jmake_mesh
from lifeapi_tpu.stable import bitplane as JBP
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.core import step as S
from lifeapi_tpu_torch.parallel import destroy, elite, make_mesh
from lifeapi_tpu_torch.stable import bitplane as BP
from lifeapi_tpu_torch.stable import complete as C
from torch_threads import one_torch_thread  # noqa: F401

EATER_RLE = "2b2o$bobo$bo$2o!"


@pytest.fixture(scope="module")
def tmesh():
    try:
        yield make_mesh(device="cpu")
    finally:
        destroy()


@pytest.fixture(scope="module", params=["8 devices", "1 device"])
def jmesh(request):
    if request.param == "1 device":
        return jmake_mesh(1, 1, devices=jax.devices()[:1])
    if len(jax.devices()) < 8:
        pytest.fail("tests/conftest.py forces 8 virtual CPU devices")
    return jmake_mesh(n_scenario=4, n_candidate=2)


def _t(packed):
    return convert.board_from_packed(np.asarray(packed), device="cpu")


def _instance(hide_cells=((20, 20), (21, 20))):
    eater = jb.move(jrle.parse(EATER_RLE), 20, 20)
    hide = jb.from_cells(list(hide_cells))
    return eater & ~hide, (jb.zoi(eater) & ~eater) | hide


def _mixed_problems(n=16):
    """Eater instances with one or two hidden cells, and unsatisfiable
    lone cells, so found flags and populations differ across the batch."""
    rows = []
    for i in range(n):
        if i % 5 == 3:
            lone = jb.from_cells([(30, 30)])
            rows.append((lone, jnp.zeros_like(lone)))
        else:
            rows.append(_instance(((20, 20),) if i % 2 else ((20, 20), (21, 20))))
    return (jnp.stack([s for s, _ in rows]), jnp.stack([u for _, u in rows]))


@pytest.mark.parametrize("two_phase", [False, True])
def test_sharded_beam_complete_matches_jax(tmesh, jmesh, two_phase):
    state, unknown = _mixed_problems()
    jres = jelite.sharded_beam_complete(JBP.make(state=state, unknown=unknown), jmesh,
                                        frontier=4, iters=16, two_phase=two_phase)
    tres = elite.sharded_beam_complete(BP.make(state=_t(state), unknown=_t(unknown)), tmesh,
                                       frontier=4, iters=16, two_phase=two_phase)
    found, best, pop, champ, champ_pop = tres
    assert (found.numpy() == np.asarray(jres[0])).all()
    assert torch.equal(best, _t(jres[1]))
    assert (pop.numpy() == np.asarray(jres[2])).all()
    assert torch.equal(champ, _t(jres[3])) and int(champ_pop) == int(jres[4])
    assert not found.all() and found.any()
    assert torch.equal(S.step(champ), champ) and int(B.population(champ)) == int(champ_pop)


def test_sharded_beam_complete_nothing_found(tmesh):
    lone = B.from_cells([(30, 30)], device="cpu").expand(4, 64)
    found, _, _, champ, champ_pop = elite.sharded_beam_complete(
        BP.make(state=lone, unknown=torch.zeros_like(lone)), tmesh, frontier=2, iters=4,
        two_phase=True)
    assert not found.any() and int(champ_pop) == elite.SENTINEL and bool(B.is_empty(champ))


def _jax_offsets(key, replicas):
    # the draw of lifeapi_tpu.parallel.elite.sharded_portfolio
    kx, ky = jax.random.split(key)
    return (np.array(jax.random.randint(kx, (replicas,), 0, 64)),
            np.array(jax.random.randint(ky, (replicas,), 0, 64)))


@pytest.mark.parametrize("two_phase", [False, True])
def test_sharded_portfolio_matches_jax(tmesh, jmesh, two_phase):
    state, unknown = _instance()
    key = jax.random.key(7)
    jres = jelite.sharded_portfolio(state, unknown, key, jmesh, replicas=16, frontier=2,
                                    iters=16, two_phase=two_phase)
    dx, dy = (torch.from_numpy(d).long() for d in _jax_offsets(key, 16))
    tres = elite._portfolio(_t(state), _t(unknown), dx, dy, tmesh, frontier=2, iters=16,
                            minimise=True, two_phase=two_phase, dfs_polish_timeout=None)
    assert tres.found == bool(jres.found) and tres.best_pop == jres.best_pop
    assert tres.found_fraction == jres.found_fraction
    assert torch.equal(tres.best, _t(jres.best))
    assert torch.equal(S.step(tres.best), tres.best)


def test_sharded_portfolio_equals_the_unsharded_portfolio(tmesh):
    """One pass at world size 1 is ``complete_stable_portfolio`` without its
    re-minimise pass, on the same generator's translations; the DFS polish
    on rank 0 can only improve the champion."""
    state, unknown = (_t(x) for x in _instance())
    res = elite.sharded_portfolio(state, unknown, torch.Generator().manual_seed(5), tmesh,
                                  replicas=16, frontier=2, iters=12, two_phase=False)
    ref = C.complete_stable_portfolio(state, unknown, torch.Generator().manual_seed(5),
                                      replicas=16, frontier=2, iters=12, reminimise=False)
    assert (res.found, res.best_pop, res.found_fraction) == (ref.found, ref.best_pop,
                                                             ref.found_fraction)
    assert torch.equal(res.best, ref.best)
    polished = elite.sharded_portfolio(state, unknown, torch.Generator().manual_seed(5),
                                       tmesh, replicas=16, frontier=2, iters=12,
                                       dfs_polish_timeout=2.0)
    assert polished.found and polished.best_pop <= res.best_pop
    with pytest.raises(ValueError):
        elite.sharded_portfolio(state, unknown, torch.Generator(), tmesh, replicas=0)
