"""The port's MPC engine against :mod:`lifeapi_tpu.mpc`.

Tolerances: float32 values rtol 1e-5 / atol 1e-5; gradients rtol 1e-4 /
atol 1e-5 (the reduction order differs); ``solve_gradient`` logits after
5 iterations rtol 1e-4 / atol 1e-5, the multichip dryrun's tolerance.
Hard costs and final boards are exact: every input probability lies at
least 1e-3 from the 0.5 binarisation threshold.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.mpc import CostWeights as JWeights
from lifeapi_tpu.mpc import MPCProblem as JProblem
from lifeapi_tpu.mpc import cost as jcost
from lifeapi_tpu.mpc import soft as jsoft
from lifeapi_tpu.mpc import solver as jsolver
from lifeapi_tpu.target import LifeTarget as JTarget
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.mpc import cost as tcost
from lifeapi_tpu_torch.mpc import soft as tsoft
from lifeapi_tpu_torch.mpc import solver as tsolver
from lifeapi_tpu_torch.target import LifeTarget, hamming_cost
from torch_threads import one_torch_thread  # noqa: F401

VALUE = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _jax_problem(kind, horizon=3):
    block = jb.move(jrle.parse("2o$2o!"), 31, 31)
    mask = jnp.zeros((64, 64), bool).at[26:38, 26:38].set(True)
    if kind == "plain":
        return JProblem(initial=jb.empty(), target=JTarget.from_state(block),
                        horizon=horizon, control_mask=mask, weights=JWeights())
    # every cost term: protected background, path weight, stable weight
    bg = jb.move(jrle.parse("2o$2o!"), 10, 10)
    return JProblem(
        initial=bg | jb.move(jrle.parse("bob$2bo$3o!"), 28, 28),
        target=JTarget.from_state(block), horizon=horizon, control_mask=mask,
        protected=jb.to_dense(jb.zoi(bg)), background=bg,
        weights=JWeights(target=1.0, control=0.02, stable=2.0, path=0.5), tau=0.3)


def _away_from_half(x, margin=1e-3):
    x = np.asarray(x, dtype=np.float32)
    return np.where(np.abs(x - 0.5) < margin, np.float32(0.25), x)


def _logits(rng, shape):
    """Logits whose sigmoid stays clear of 0.5 (|logit| >= 0.01)."""
    x = rng.normal(0.0, 2.0, size=shape).astype(np.float32)
    return np.where(np.abs(x) < 0.01, np.float32(1.0), x)


# ---------------------------------------------------------------------------
# Soft dynamics and costs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tau", [0.15, 0.25, 0.6])
def test_soft_step_and_rollout(rng, tau):
    p = rng.random((2, 64, 64)).astype(np.float32)
    u = (rng.random((4, 2, 64, 64)) * 0.2).astype(np.float32)
    np.testing.assert_allclose(tsoft.soft_step(torch.from_numpy(p), tau).numpy(),
                               np.asarray(jsoft.soft_step(jnp.asarray(p), tau)), **VALUE)
    jf, jt = jsoft.soft_rollout(jnp.asarray(p), jnp.asarray(u), tau=tau)
    tf, tt = tsoft.soft_rollout(torch.from_numpy(p), torch.from_numpy(u), tau=tau)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **VALUE)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **VALUE)


def test_soft_costs(rng):
    jp = _jax_problem("protected")
    tp = convert.problem_from_jax(jp, device="cpu")
    traj = rng.random((3, 2, 64, 64)).astype(np.float32)
    jt, tt = jnp.asarray(traj), torch.from_numpy(traj)
    pairs = [
        (jcost.soft_target_cost(jt, jp.target), tcost.soft_target_cost(tt, tp.target)),
        (jcost.soft_target_cost_any_time(jt, jp.target),
         tcost.soft_target_cost_any_time(tt, tp.target)),
        (jcost.soft_control_cost(jt), tcost.soft_control_cost(tt)),
        (jcost.soft_stable_cost(jt, jp.protected), tcost.soft_stable_cost(tt, tp.protected)),
        (jcost.soft_stable_cost(jt, jb.zoi(jp.background)),
         tcost.soft_stable_cost(tt, tb.zoi(tp.background))),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **VALUE)


def test_hard_cost_heads(rng):
    jp = _jax_problem("protected")
    tp = convert.problem_from_jax(jp, device="cpu")
    packed = jb.from_dense(jnp.asarray(rng.random((4, 3, 64, 64)) < 0.05))
    t = convert.board_from_packed(packed, device="cpu")
    assert (hamming_cost(t, tp.target).numpy()
            == np.asarray(jax.vmap(lambda b: jcost.hamming_cost(b, jp.target))(packed))).all()
    assert (tcost.hard_target_cost_any_time(t, tp.target).numpy()
            == np.asarray(jcost.hard_target_cost_any_time(packed, jp.target))).all()
    prot = jb.from_dense(jp.protected)
    expect = jcost.hard_total(packed[0, 0], packed[:, 0], jp.target, prot,
                              jp.background, jp.weights)
    got = tcost.hard_total(t[0, 0], t[:, 0], tp.target, tb.from_dense(tp.protected),
                           tp.background, tp.weights)
    assert float(got) == float(expect)


# ---------------------------------------------------------------------------
# Objective, hard scoring, solvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "protected"])
def test_soft_objective_value_and_grad(rng, kind):
    jp = _jax_problem(kind, horizon=4)
    tp = convert.problem_from_jax(jp, device="cpu")
    logits = rng.normal(-1.0, 1.5, size=(3, 4, 64, 64)).astype(np.float32)
    jv, jg = jax.vmap(jax.value_and_grad(
        lambda l: jsolver.soft_objective(l, jp, 0.4)))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    tv = tsolver.soft_objective(t, tp, 0.4)
    (tg,) = torch.autograd.grad(tv.sum(), t)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **VALUE)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD)


@pytest.mark.parametrize("kind", ["plain", "protected"])
def test_hard_score_batch_bit_identical_to_vmap_path(rng, kind):
    jp = _jax_problem(kind, horizon=4)
    tp = convert.problem_from_jax(jp, device="cpu")
    probs = _away_from_half(rng.random((4, 4, 64, 64)) * 0.7)
    jc, jf = jsolver.hard_score_batch(jnp.asarray(probs), jp, use_fused=False)
    tc, tf = tsolver.hard_score_batch(torch.from_numpy(probs), tp)
    assert tc.dtype == torch.float32
    assert (tc.numpy() == np.asarray(jc)).all()
    assert (convert.board_to_packed(tf) == np.asarray(jf)).all()
    c1, f1 = jsolver.hard_score(jnp.asarray(probs[1]), jp)
    t1, g1 = tsolver.hard_score(torch.from_numpy(probs[1]), tp)
    assert float(t1) == float(c1)
    assert (convert.board_to_packed(g1) == np.asarray(f1)).all()


@pytest.mark.parametrize("kind", ["plain", "protected"])
def test_rescore_and_select(rng, kind):
    jp = _jax_problem(kind, horizon=3)
    tp = convert.problem_from_jax(jp, device="cpu")
    logits = _logits(rng, (4, 3, 64, 64)) - 2.0
    js = jsolver.rescore_and_select(jnp.asarray(logits), jp)
    ts = convert.solution_to_numpy(tsolver.rescore_and_select(torch.from_numpy(logits), tp))
    assert (ts["all_costs"] == np.asarray(js.all_costs)).all()
    assert ts["cost"] == np.asarray(js.cost)
    assert (ts["final_board"] == np.asarray(js.final_board)).all()
    assert (ts["controls"] == np.asarray(js.controls)).all()
    np.testing.assert_allclose(ts["control_probs"], np.asarray(js.control_probs), **VALUE)


@pytest.mark.parametrize("kind", ["plain", "protected"])
def test_solve_gradient_five_iterations(rng, kind):
    jp = _jax_problem(kind, horizon=3)
    tp = convert.problem_from_jax(jp, device="cpu")
    logits0 = rng.normal(-3.0, 0.5, size=(2, 3, 64, 64)).astype(np.float32)
    jl, jh = jsolver.solve_gradient(jnp.asarray(logits0), jp, iters=5)
    tl, th = tsolver.solve_gradient(torch.from_numpy(logits0), tp, iters=5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)


def test_solve_reaches_target():
    problem = convert.problem_from_jax(_jax_problem("plain", horizon=6), device="cpu")
    problem = problem._replace(weights=tcost.CostWeights(target=1.0, control=0.01))
    sol = tsolver.solve(problem, torch.Generator().manual_seed(0), n_candidates=8,
                        iters=120)
    assert int(hamming_cost(sol.final_board, problem.target)) == 0
    assert sol.all_costs.shape == (8,) and sol.controls.shape == (6, 64)
    cost, final = tsolver.hard_score(sol.control_probs, problem)
    assert float(cost) == float(sol.cost) and torch.equal(final, sol.final_board)


def test_solve_rejects_unported_method():
    """Every method of the JAX package's ``solve`` is ported; an unknown
    method name still raises."""
    problem = convert.problem_from_jax(_jax_problem("plain"), device="cpu")
    with pytest.raises(ValueError):
        tsolver.solve(problem, torch.Generator(), method="newton")


def test_cem_reaches_target():
    block = tb.move(tb.from_cells([(0, 0), (0, 1), (1, 0), (1, 1)], device="cpu"), 31, 31)
    mask = torch.zeros((64, 64), dtype=torch.bool)
    mask[30:34, 30:34] = True
    problem = tsolver.MPCProblem(
        initial=tb.empty(device="cpu"), target=LifeTarget.from_state(block), horizon=2,
        control_mask=mask, weights=tcost.CostWeights(target=1.0, control=0.01))
    mean, best_cost, best_sample, history = tsolver.solve_cem(
        problem, torch.Generator().manual_seed(1), pop=128, iters=12, elites=8,
        init_p=0.25)
    assert mean.shape == (2, 64, 64) and history.shape == (12,)
    cost, final = tsolver.hard_score(best_sample.to(torch.float32), problem)
    assert float(cost) == float(best_cost) == float(history.min())
    assert int(hamming_cost(final, problem.target)) == 0
    assert not (best_sample & ~mask).any()


def test_hard_rollout_matches_jax(rng):
    packed = jb.from_dense(jnp.asarray(rng.random((3, 64, 64)) < 0.3))
    tog = jb.from_dense(jnp.asarray(rng.random((5, 3, 64, 64)) < 0.02))
    expect = jsoft.hard_rollout(packed, tog)
    got = tsoft.hard_rollout(convert.board_from_packed(packed, device="cpu"), convert.board_from_packed(tog, device="cpu"))
    assert (convert.board_to_packed(got) == np.asarray(expect)).all()
    probs = _away_from_half(rng.random((2, 64, 64)))
    assert (convert.board_to_packed(tsoft.binarize_controls(torch.from_numpy(probs)))
            == np.asarray(jsoft.binarize_controls(jnp.asarray(probs)))).all()
