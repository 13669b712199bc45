"""The port's SQP solver against :mod:`lifeapi_tpu.mpc.solver`'s.

Tolerances: the conjugate gradients rtol 1e-5 (atol 1e-6) against
``jax.vmap(jax.scipy.sparse.linalg.cg)``; Hessian-vector products rtol
1e-4 / atol 1e-5 against JAX's ``jvp`` of ``grad`` (the reduction order
differs); ``solve_sqp``'s logits rtol 1e-4 / atol 1e-5, the multichip
dryrun's tolerance.
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
from lifeapi_tpu.mpc import solver as jsolver
from lifeapi_tpu.target import LifeTarget as JTarget
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.mpc import solver as tsolver
from torch_threads import one_torch_thread  # noqa: F401

SQP = dict(rtol=1e-4, atol=1e-5)


def _jax_problem(kind, horizon):
    block = jb.move(jrle.parse("2o$2o!"), 31, 31)
    mask = jnp.zeros((64, 64), bool).at[26:38, 26:38].set(True)
    if kind == "plain":
        return JProblem(initial=jb.empty(), target=JTarget.from_state(block),
                        horizon=horizon, control_mask=mask,
                        weights=JWeights(target=1.0, control=0.01))
    bg = jb.move(jrle.parse("2o$2o!"), 10, 10)
    return JProblem(
        initial=bg | jb.move(jrle.parse("bob$2bo$3o!"), 28, 28),
        target=JTarget.from_state(block), horizon=horizon, control_mask=mask,
        protected=jb.to_dense(jb.zoi(bg)), background=bg,
        weights=JWeights(target=1.0, control=0.01, stable=5.0, path=0.5), tau=0.3)


def _spd_batch(rng, n=24):
    """Four SPD operators whose CG converges at different iterations (2, 5
    and n distinct eigenvalues), and right-hand sides, the last one zero."""
    mats = []
    for distinct in (2, 5, n, n):
        q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        levels = np.linspace(1.0, 9.0, distinct)
        eig = levels[np.arange(n) % distinct]
        mats.append((q * eig) @ q.T)
    a = np.stack(mats).astype(np.float32)
    b = rng.normal(size=(4, n)).astype(np.float32)
    b[3] = 0.0
    return a, b


@pytest.mark.parametrize("maxiter", [3, 8, 30])
def test_conjugate_gradients_match_vmapped_jax_cg(rng, maxiter):
    a, b = _spd_batch(rng)
    expect = jax.vmap(lambda m, r: jax.scipy.sparse.linalg.cg(
        lambda v: m @ v, r, maxiter=maxiter)[0])(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a)
    got = tsolver.conjugate_gradients(lambda v: torch.einsum("cij,cj->ci", ta, v),
                                      torch.from_numpy(b), maxiter)
    assert torch.isfinite(got).all()
    assert (got[3] == 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["plain", "protected"])
def test_hvp_matches_jax_jvp_of_grad(rng, kind):
    jp = _jax_problem(kind, horizon=3)
    tp = convert.problem_from_jax(jp, device="cpu")
    logits = rng.normal(-1.5, 1.5, size=(2, 3, 64, 64)).astype(np.float32)
    vecs = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)

    def f(l):
        return jsolver.soft_objective(l, jp)

    expect = jax.vmap(lambda l, v: jax.jvp(jax.grad(f), (l,), (v,))[1])(
        jnp.asarray(logits), jnp.asarray(vecs))
    jv, jg = jax.vmap(jax.value_and_grad(f))(jnp.asarray(logits))
    vals, grads, hvp = tsolver.grad_and_hvp(lambda x: tsolver.soft_objective(x, tp),
                                            torch.from_numpy(logits))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads.numpy(), np.asarray(jg), **SQP)
    np.testing.assert_allclose(hvp(torch.from_numpy(vecs)).numpy(), np.asarray(expect), **SQP)


@pytest.mark.parametrize("kind", ["plain", "protected"])
def test_solve_sqp_matches_jax(rng, kind):
    jp = _jax_problem(kind, horizon=2)
    tp = convert.problem_from_jax(jp, device="cpu")
    logits0 = rng.normal(-2.0, 1.0, size=(2, 2, 64, 64)).astype(np.float32)
    expect = jsolver.solve_sqp(jnp.asarray(logits0), jp, iters=2, cg_iters=4)
    got = tsolver.solve_sqp(torch.from_numpy(logits0), tp, iters=2, cg_iters=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **SQP)
    assert not np.allclose(got.numpy(), logits0)


def test_sqp_solver_improves():
    """Mirror of ``test_sqp_solver_improves``: the toy problem's best soft
    objective after 30 gradient iterations and 3 SQP steps is below the
    best at the start, and SQP does not undo the warm-up."""
    problem = convert.problem_from_jax(_jax_problem("plain", horizon=6), device="cpu")
    logits0 = tsolver.init_logits(torch.Generator().manual_seed(2), problem, 4)
    start = tsolver.soft_objective(logits0, problem)
    warm, _ = tsolver.solve_gradient(logits0, problem, iters=30)
    logits = tsolver.solve_sqp(warm, problem, iters=3, cg_iters=8)
    end = tsolver.soft_objective(logits, problem)
    assert float(end.min()) < float(start.min())
    assert bool((end <= tsolver.soft_objective(warm, problem)).all())


def test_solve_sqp_method_is_warm_up_then_sqp():
    """``solve(method="sqp")``: ``max(iters // 3, 10)`` gradient
    iterations, then ``solve_sqp`` with the caller's kwargs, then the hard
    rescore."""
    problem = convert.problem_from_jax(_jax_problem("plain", horizon=2), device="cpu")
    sol = tsolver.solve(problem, torch.Generator().manual_seed(5), n_candidates=2,
                        method="sqp", iters=12, cg_iters=3)
    logits0 = tsolver.init_logits(torch.Generator().manual_seed(5), problem, 2)
    warm, _ = tsolver.solve_gradient(logits0, problem, iters=10)
    expect = tsolver.rescore_and_select(tsolver.solve_sqp(warm, problem, cg_iters=3), problem)
    assert torch.equal(sol.all_costs, expect.all_costs)
    assert torch.equal(sol.controls, expect.controls)
    assert torch.equal(sol.control_probs, expect.control_probs)
