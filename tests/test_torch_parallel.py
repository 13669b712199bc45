"""``lifeapi_tpu_torch.parallel`` at world size 1, in process, against
:mod:`lifeapi_tpu.parallel` on its 8-device CPU mesh (``tests/conftest.py``)
and on a 1-device mesh.

Every rank takes the global inputs and returns global outputs, so a port
runner on one gloo rank must give what a JAX runner gives on any mesh:
boards, flags, counts and populations exactly; float32 costs and controls
at rtol 1e-4 / atol 1e-5 (the multichip dryrun's tolerance;
``solve_gradient``'s reductions run in another order).  The JAX runners
draw their MPC logits and portfolio translations from ``jax.random``;
here the same draws reach the port's runners through the private helpers
that take them (``_scenario_sweep``, ``_portfolio``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.mpc import CostWeights as JWeights
from lifeapi_tpu.mpc import MPCProblem as JProblem
from lifeapi_tpu.mpc import solver as jsolver
from lifeapi_tpu.parallel import elite as jelite
from lifeapi_tpu.parallel import make_mesh as jmake_mesh
from lifeapi_tpu.symmetry import transforms as jtr
from lifeapi_tpu.target import LifeTarget as JTarget
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import step as S
from lifeapi_tpu_torch.parallel import destroy, elite, make_mesh, mesh
from torch_parallel_cases import COST_TOL
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


def test_mesh(tmesh):
    assert tuple(tmesh.shape) == (1, 1)
    assert tmesh.mesh_dim_names == (mesh.SCENARIO_AXIS, mesh.CANDIDATE_AXIS)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert tuple(make_mesh(1, device="cpu").shape) == (1, 1)  # the group is reused
    with pytest.raises(ValueError):
        make_mesh(2, 1, device="cpu")


def test_mesh_refuses_a_missing_card(tmesh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_local_topk_matches_jax(rng):
    costs = rng.integers(0, 5, size=32).astype(np.float32)  # many ties
    for k in (1, 4, 32):
        jv, ji = jelite.local_topk(jnp.asarray(costs), k)
        tv, ti = elite.local_topk(torch.from_numpy(costs), k)
        assert (tv.numpy() == np.asarray(jv)).all() and (ti.numpy() == np.asarray(ji)).all()


def test_sharded_rollout_matches_jax(tmesh, jmesh, rng):
    boards = rng.integers(0, 2**32, size=(16, 64, 2), dtype=np.uint64).astype(np.uint32)
    jf, jpop = jelite.sharded_rollout(jnp.asarray(boards), steps=6, mesh=jmesh)
    tf, tpop = elite.sharded_rollout(_t(boards), 6, tmesh)
    assert torch.equal(tf, _t(jf)) and int(tpop) == int(jpop)
    assert torch.equal(tf, S.step_n(_t(boards), 6))


def test_sharded_catalyst_search_matches_jax(tmesh, jmesh):
    glider = jb.move(jrle.parse("bob$2bo$3o!"), 8, 8)
    eater = jb.move(jtr.transform(jrle.parse(EATER_RLE), jtr.SymmetryTransform.Rotate270),
                    24, 24)
    offsets = np.asarray([[dx, dy] for dx in range(-8, 8) for dy in range(-8, 8)], np.int32)
    ji, jr, jh = jelite.sharded_catalyst_search(glider, eater, jnp.asarray(offsets), 100,
                                                jmesh)
    ti, tr, th = elite.sharded_catalyst_search(_t(glider), _t(eater),
                                               torch.from_numpy(offsets).long(), 100, tmesh)
    assert (ti.numpy() == np.asarray(ji)).all() and (tr.numpy() == np.asarray(jr)).all()
    assert int(th) == int(jh) > 0


def _jax_problem(horizon=4):
    target = JTarget.from_state(jb.move(jrle.parse("2o$2o!"), 31, 31))
    mask = jnp.zeros((64, 64), bool).at[28:36, 28:36].set(True)
    return JProblem(initial=jb.empty(), target=target, horizon=horizon, control_mask=mask,
                    weights=JWeights(target=1.0, control=0.01))


def test_sharded_candidate_solve_matches_jax(tmesh, jmesh):
    jp = _jax_problem()
    logits0 = np.array(jsolver.init_logits(jax.random.key(0), jp, 16))
    jbest, jprobs, jall = jelite.sharded_candidate_solve(jp, jnp.asarray(logits0), jmesh,
                                                         iters=60, topk=2)
    tbest, tprobs, tall = elite.sharded_candidate_solve(
        convert.problem_from_jax(jp, device="cpu"), torch.from_numpy(logits0), tmesh, iters=60, topk=2)
    np.testing.assert_allclose(tall.numpy(), np.asarray(jall), **COST_TOL)
    np.testing.assert_allclose(float(tbest), float(jbest), **COST_TOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **COST_TOL)
    assert float(tbest) == float(tall.min())


def test_sharded_scenario_sweep_matches_jax(tmesh, jmesh):
    """JAX's own sweep, and the port's sweep from the logits JAX draws."""
    jp = _jax_problem()
    initials = jnp.broadcast_to(jb.move(jrle.parse("bo$2o!"), 30, 30), (8, 64, 2))
    key = jax.random.key(1)
    jper, jchamp = jelite.sharded_scenario_sweep(
        initials, jp.target, jp.horizon, jp.control_mask, jmesh, key,
        candidates_per_scenario=4, iters=40, weights=jp.weights)
    first = JProblem(initials[0], jp.target, jp.horizon, jp.control_mask, weights=jp.weights)
    logits0 = np.array(jsolver.init_logits(key, first, 32)).reshape(8, 4, 4, 64, 64)
    tp = convert.problem_from_jax(jp, device="cpu")
    tper, tchamp = elite._scenario_sweep(_t(initials), tp.target, tp.horizon,
                                         tp.control_mask, tmesh, torch.from_numpy(logits0),
                                         40, tp.weights)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), **COST_TOL)
    np.testing.assert_allclose(float(tchamp), float(jchamp), **COST_TOL)
    # the public runner, from a torch generator: the champion is the best scenario
    per, champ = elite.sharded_scenario_sweep(
        _t(initials), tp.target, tp.horizon, tp.control_mask, tmesh,
        torch.Generator().manual_seed(1), candidates_per_scenario=4, iters=3,
        weights=tp.weights)
    assert per.shape == (8,) and float(champ) == float(per.min())
