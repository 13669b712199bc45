"""The MPC objective's fused path (``mpc/soft.py`` ``fused_objective`` over
``ops/soft_cuda.py``'s objective sweeps) and the solver's update kernels
(``ops/solver_cuda.py``) on the CPU, where every kernel runs its plain
twin: the objective's value, gradient and Hessian-vector product against
:mod:`lifeapi_tpu.mpc.solver` and against the eager composition, the update
twins against the solver's eager code bit for bit.  The kernels themselves
are held to the twins on the card (``tests/test_torch_cuda_kernels.py``).

Tolerances: against JAX rtol 1e-5 / atol 1e-5 for values and rtol 1e-4 /
atol 1e-5 for gradients and Hessian-vector products, as
``tests/test_torch_mpc_sqp.py`` compares them (the reduction order
differs), each atol scaled by the expected tensor's largest magnitude (the
map carries a rounding in one cell to its neighbours, growing with the
derivatives themselves); against the composition, which sums the same
terms in another order, the same.
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
from lifeapi_tpu_torch.mpc import soft as tsoft
from lifeapi_tpu_torch.mpc import solver as tsolver
from lifeapi_tpu_torch.ops import soft_cuda, solver_cuda
from torch_threads import one_torch_thread  # noqa: F401

VALUE = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def assert_close(got, want, tol):
    """``tol``'s atol scaled by the largest magnitude of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol["rtol"],
                               atol=tol["atol"] * max(float(np.abs(want).max()), 1.0))


def _jax_problem(kind, horizon):
    """The SQP tests' problems: a block to reach from an empty board, or
    from a glider beside a protected block with every cost term weighted
    (stable and path too)."""
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


def _fused(problem):
    inputs = tsolver.objective_inputs(problem)
    return lambda x: tsoft.fused_objective(x, inputs, problem.tau)


@pytest.mark.parametrize("kind", ["plain", "protected"])
@pytest.mark.parametrize("cands,horizon", [(2, 3), (4, 5)])
def test_fused_value_gradient_and_hvp_match_jax(kind, cands, horizon):
    """``grad_and_hvp`` of the fused objective against JAX's
    ``value_and_grad`` and ``jvp`` of ``grad``, from numpy draws."""
    jp = _jax_problem(kind, horizon)
    tp = convert.problem_from_jax(jp, device="cpu")
    rng = np.random.default_rng([cands, horizon])
    logits = rng.normal(-1.5, 1.5, size=(cands, horizon, 64, 64)).astype(np.float32)
    vecs = rng.normal(size=logits.shape).astype(np.float32)

    def f(lg):
        return jsolver.soft_objective(lg, jp)

    jv, jg = jax.vmap(jax.value_and_grad(f))(jnp.asarray(logits))
    jh = jax.vmap(lambda lg, v: jax.jvp(jax.grad(f), (lg,), (v,))[1])(
        jnp.asarray(logits), jnp.asarray(vecs))
    vals, grads, hvp = tsolver.grad_and_hvp(_fused(tp), torch.from_numpy(logits))
    assert_close(vals.numpy(), jv, VALUE)
    assert_close(grads.numpy(), jg, GRAD)
    assert_close(hvp(torch.from_numpy(vecs)).numpy(), jh, GRAD)
    v2, g2 = tsolver.value_and_grad(_fused(tp), torch.from_numpy(logits))
    assert torch.equal(v2, vals) and torch.equal(g2, grads)


@pytest.mark.parametrize("horizon", [1, 2, 5])
def test_fused_objective_agrees_with_the_composition(horizon):
    """The fused twin against the eager composition it replaces on the card
    (every cost term weighted, horizon 1 where traj[0] is the last state):
    values, gradients and HVPs, and with a values' cotangent other than 1."""
    tp = convert.problem_from_jax(_jax_problem("protected", horizon), device="cpu")
    rng = np.random.default_rng(horizon)
    logits = torch.from_numpy(rng.normal(-1.0, 1.5, (3, horizon, 64, 64)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=logits.shape).astype(np.float32))
    weights = torch.tensor([1.0, -0.5, 2.0])

    def run(objective):
        x = logits.clone().requires_grad_(True)
        vals = objective(x)
        (g,) = torch.autograd.grad((vals * weights).sum(), x, create_graph=True)
        (h,) = torch.autograd.grad(g, x, v)
        return vals.detach(), g.detach(), h

    fused = run(_fused(tp))
    eager = run(lambda x: tsolver.composed_objective(x, tp))
    for got, want, tol in zip(fused, eager, (VALUE, GRAD, GRAD)):
        assert_close(got.numpy(), want.numpy(), tol)


def test_fused_objective_keeps_the_leading_shape_and_needs_no_trajectory():
    tp = convert.problem_from_jax(_jax_problem("plain", 2), device="cpu")
    logits = torch.from_numpy(np.random.default_rng(3).normal(-2, 1, (2, 3, 2, 64, 64))
                              .astype(np.float32))
    got = _fused(tp)(logits)
    assert got.shape == (2, 3)
    assert torch.allclose(got, tsolver.composed_objective(logits, tp), rtol=1e-5)
    assert _fused(tp)(logits[0, 0]).shape == ()


def test_fused_objective_third_derivative_raises():
    tp = convert.problem_from_jax(_jax_problem("protected", 3), device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(-1, 1, (2, 3, 64, 64))
                         .astype(np.float32)).requires_grad_(True)
    (g,) = torch.autograd.grad(_fused(tp)(x).sum(), x, create_graph=True)
    (h,) = torch.autograd.grad((g * g).sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiates twice at most"):
        torch.autograd.grad(h.sum(), x)


def test_a_replaced_map_runs_the_objective_eagerly(monkeypatch):
    """With ``soft.soft_step`` replaced, ``soft_objective`` is the eager
    composition over the replacement, and no objective sweep runs."""
    tp = convert.problem_from_jax(_jax_problem("protected", 3), device="cpu")
    logits = tsolver.init_logits(torch.Generator().manual_seed(0), tp, 2)
    launches = dict(soft_cuda.LAUNCHES)
    monkeypatch.setattr(tsoft, "soft_step",
                        lambda p, tau=0.2: soft_cuda.soft_step(p, tau) * 0.5)
    assert tsoft.map_replaced()
    got = tsolver.soft_objective(logits, tp)
    controls = (torch.sigmoid(logits) * tp.control_mask).movedim(-3, 0)
    p = tsolver.B.to_dense(tp.initial).to(torch.float32)
    traj = []
    for u in controls:
        p = soft_cuda.soft_step(soft_cuda.soft_toggle(p, u), tp.tau) * 0.5
        traj.append(p)
    want = tsolver.cost_mod.soft_total(p, torch.stack(traj), controls, tp.target,
                                       tp.protected, tp.weights)
    assert torch.equal(got, want)
    assert soft_cuda.LAUNCHES == launches


# ---------------------------------------------------------------------------
# the update twins against the solver's eager code
# ---------------------------------------------------------------------------


def _eager_cg(matvec, b, maxiter):
    """Conjugate gradients as the solver wrote it before the update kernel."""
    def dot(a, c):
        return (a * c).flatten(1).sum(dim=1)

    stop = tsolver.CG_TOL ** 2 * dot(b, b)
    x = torch.zeros_like(b)
    r = b
    p = r
    gamma = dot(r, r)
    view = (-1,) + (1,) * (b.dim() - 1)
    for _ in range(maxiter):
        active = gamma > stop
        ap = matvec(p)
        alpha = (gamma / dot(p, ap)).view(view)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        gamma_new = dot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma).view(view) * p
        a = active.view(view)
        x = torch.where(a, x_new, x)
        r = torch.where(a, r_new, r)
        p = torch.where(a, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return x


@pytest.mark.parametrize("maxiter", [1, 4, 9, 30])
def test_cg_twin_equals_the_eager_loop_bit_for_bit(maxiter):
    """Four systems that converge after 2, 5 and 24 iterations and one
    right-hand side of zeros, on the shape of the solver's batches."""
    rng = np.random.default_rng(maxiter)
    n = 24
    mats = []
    for distinct in (2, 5, n, n):
        q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        eig = np.linspace(1.0, 9.0, distinct)[np.arange(n) % distinct]
        mats.append((q * eig) @ q.T)
    a = torch.from_numpy(np.stack(mats).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4, 2, 3, 4)).astype(np.float32))
    b[3] = 0.0

    def matvec(v):
        return torch.einsum("cij,cj->ci", a, v.flatten(1)).view(v.shape)

    got = tsolver.conjugate_gradients(matvec, b, maxiter)
    assert torch.equal(got, _eager_cg(matvec, b, maxiter))
    assert (got[3] == 0).all()


def test_cg_update_twin_is_in_place_and_keeps_a_frozen_system():
    rng = np.random.default_rng(5)
    x, r, p, ap = (torch.from_numpy(rng.normal(size=(3, 2, 8)).astype(np.float32))
                   for _ in range(4))
    gamma = solver_cuda.batch_dot(r, r)
    stop = torch.stack([gamma[0] + 1, gamma[1] - 1, gamma[2] - 1])
    before = [t.clone() for t in (x, r, p, gamma)]
    solver_cuda.cg_update(x, r, p, ap, gamma, stop)
    for new, old in zip((x, r, p, gamma), before):
        assert torch.equal(new[0], old[0])
        assert not torch.equal(new[1:], old[1:])


def _eager_adam(logits, grads, state, lr):
    """Adam as the solver wrote it before the update kernel."""
    count, mu, nu = state
    count += 1
    mu = (1 - tsolver.ADAM_B1) * grads + tsolver.ADAM_B1 * mu
    nu = (1 - tsolver.ADAM_B2) * grads * grads + tsolver.ADAM_B2 * nu
    mu_hat = mu / (1 - tsolver.ADAM_B1 ** count)
    nu_hat = nu / (1 - tsolver.ADAM_B2 ** count)
    logits = logits - lr * (mu_hat / (torch.sqrt(nu_hat) + tsolver.ADAM_EPS))
    return logits, (count, mu, nu)


@pytest.mark.parametrize("lr", [0.15, 0.05])
def test_adam_twin_equals_the_eager_step_bit_for_bit(lr):
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.normal(-3, 0.5, (3, 4, 64, 64)).astype(np.float32))
    got, want = (logits, tsolver.adam_init(logits)), (logits, tsolver.adam_init(logits))
    for _ in range(5):
        grads = torch.from_numpy(rng.normal(0, 1e-2, logits.shape).astype(np.float32))
        got = tsolver.adam_update(got[0], grads, got[1], lr)
        want = _eager_adam(want[0], grads, want[1], lr)
        assert got[1][0] == want[1][0]
        for g, w in zip((got[0], *got[1][1:]), (want[0], *want[1][1:])):
            assert torch.equal(g, w)
