"""The port's receding-horizon loops against :mod:`lifeapi_tpu.mpc.receding`.

Both packages get the same logits: ``run`` draws through its solver's
``init_logits``, which the tests replace in both packages with one that
hands out the same numpy-seeded arrays in turn; ``_run_fused`` takes JAX's
initial logits and the tails JAX draws from ``jax.random.split(key,
rounds)``.  Boards and applied toggles must match bit for bit and the
per-solve costs to rtol 1e-5.  Every round's logits are also compared
after 30 adam iterations, at rtol 1e-4 / atol 1e-4: adam divides each
cell's gradient by its own running scale, so the float32 rounding of a
near-zero gradient, which differs with the reduction order, moves a logit
by up to 6e-5 here.  JAX's logits stay more than 1e-4 from the
binarisation threshold, so within that tolerance no toggle can flip on
rounding alone.
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
from lifeapi_tpu.mpc import receding as jreceding
from lifeapi_tpu.mpc import solver as jsolver
from lifeapi_tpu.target import LifeTarget as JTarget
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.examples import receding_mpc
from lifeapi_tpu_torch.mpc import receding as treceding
from lifeapi_tpu_torch.mpc import solver as tsolver
from torch_threads import one_torch_thread  # noqa: F401

COSTS = dict(rtol=1e-5)
LOGITS = dict(rtol=1e-4, atol=1e-4)


def _jax_problem(horizon):
    block = jb.move(jrle.parse("2o$2o!"), 31, 31)
    mask = jnp.zeros((64, 64), bool).at[27:37, 27:37].set(True)
    return JProblem(initial=jb.move(jrle.parse("3o!"), 30, 30),
                    target=JTarget.from_state(block), horizon=horizon, control_mask=mask,
                    weights=JWeights(target=1.0, control=0.01, path=1.0))


class _Draws:
    """Hands out the same numpy-seeded logits to both packages' solvers."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.drawn = []

    def jax(self, key, problem, n_candidates, scale=0.5, bias=-3.0):
        a = (bias + scale * self.rng.normal(size=(n_candidates, problem.horizon, 64, 64)))
        self.drawn.append(a.astype(np.float32))
        return jnp.asarray(self.drawn[-1])

    def port(self, generator, problem, n_candidates, scale=0.5, bias=-3.0):
        return torch.from_numpy(self.drawn.pop(0))


def _spy_elites(monkeypatch, module, unpack):
    """Record the logits every ``rescore_and_select`` call of ``module``
    receives."""
    seen = []
    original = module.rescore_and_select

    def spy(logits, problem):
        seen.append(unpack(logits))
        return original(logits, problem)

    monkeypatch.setattr(module, "rescore_and_select", spy)
    return seen


def _check_logits(jax_logits, port_logits):
    for j, t in zip(jax_logits, port_logits):
        np.testing.assert_allclose(t, j, **LOGITS)
        assert np.abs(j).min() > 1e-4  # no toggle can flip on rounding alone


def _same_run(jax_run, port_run):
    got = convert.mpc_run_to_numpy(port_run)
    assert (got["boards"] == np.asarray(jax_run.boards)).all()
    assert (got["applied"] == np.asarray(jax_run.applied)).all()
    np.testing.assert_allclose(got["costs"], np.asarray(jax_run.costs), **COSTS)


def _exact_dynamics(run):
    from lifeapi_tpu_torch.core import step as tstep

    for i in range(run.applied.shape[0]):
        assert torch.equal(run.boards[i + 1], tstep.step(run.boards[i] ^ run.applied[i]))


@pytest.mark.parametrize("steps, apply_horizon, warm", [(4, 2, True), (3, 2, False)])
def test_run_matches_jax(monkeypatch, steps, apply_horizon, warm):
    jp = _jax_problem(horizon=3)
    tp = convert.problem_from_jax(jp, device="cpu")
    draws = _Draws(7)
    monkeypatch.setattr(jsolver, "init_logits", draws.jax)
    monkeypatch.setattr(tsolver, "init_logits", draws.port)
    j_elites = _spy_elites(monkeypatch, jsolver, np.asarray)
    t_elites = _spy_elites(monkeypatch, tsolver, lambda t: t.numpy())
    want = jreceding.run(jp, jax.random.key(0), steps=steps, apply_horizon=apply_horizon,
                         n_candidates=2, solve_iters=30, warm_start=warm)
    got = treceding.run(tp, torch.Generator(), steps=steps, apply_horizon=apply_horizon,
                        n_candidates=2, solve_iters=30, warm_start=warm)
    assert not draws.drawn  # the port took every array JAX drew, in turn
    _check_logits(j_elites, t_elites)
    _same_run(want, got)
    assert got.boards.shape == (steps + 1, 64) and got.applied.shape == (steps, 64)
    assert int(tb.population(got.applied).sum()) > 0  # the elites do toggle
    _exact_dynamics(got)


def test_run_with_no_steps():
    tp = convert.problem_from_jax(_jax_problem(horizon=2), device="cpu")
    got = treceding.run(tp, torch.Generator(), steps=0)
    assert got.boards.shape == (1, 64) and got.applied.shape == (0, 64)
    assert got.applied.dtype == torch.int64 and got.costs.shape == (0,)


def test_run_fused_matches_jax(monkeypatch):
    """``_run_fused`` from JAX's ``logits0`` and the tails JAX draws, 2
    rounds of 2 applied slices."""
    jp = _jax_problem(horizon=2)
    tp = convert.problem_from_jax(jp, device="cpu")
    key = jax.random.key(3)
    steps, A, C = 4, 2, 2
    logits0 = jsolver.init_logits(key, jp, C)
    want = jreceding._run_fused(jp, key, logits0, steps=steps, apply_horizon=A,
                                solve_iters=30)
    tails = np.stack([-3.0 + 0.5 * np.asarray(jax.random.normal(k, (C, A, 64, 64), jnp.float32))
                      for k in jax.random.split(key, steps // A)])
    t_elites = []
    original = tsolver.hard_score_batch

    def spy(probs, problem):
        t_elites.append(probs)
        return original(probs, problem)

    monkeypatch.setattr(tsolver, "hard_score_batch", spy)
    got = treceding._run_fused(tp, torch.from_numpy(np.array(logits0)),
                               torch.from_numpy(tails.astype(np.float32)), steps=steps,
                               apply_horizon=A, solve_iters=30)
    for probs in t_elites:  # the port's probabilities stay clear of 0.5
        assert float((probs - 0.5).abs().min()) > 1e-5
    _same_run(want, got)
    assert got.costs.shape == (steps // A,)
    assert int(tb.population(got.applied).sum()) > 0
    _exact_dynamics(got)


def test_run_fused_contract():
    tp = convert.problem_from_jax(_jax_problem(horizon=2), device="cpu")
    with pytest.raises(ValueError):
        treceding.run_fused(tp, torch.Generator(), steps=3, apply_horizon=2)
    with pytest.raises(ValueError):
        treceding.run_fused(tp, torch.Generator(), steps=3, apply_horizon=3)
    got = treceding.run_fused(tp, torch.Generator().manual_seed(1), steps=2,
                              apply_horizon=1, n_candidates=2, solve_iters=3)
    assert got.boards.shape == (3, 64) and got.applied.shape == (2, 64)
    assert got.costs.shape == (2,) and got.costs.dtype == torch.float32
    _exact_dynamics(got)
    none = treceding.run_fused(tp, torch.Generator(), steps=0, apply_horizon=2)
    assert none.boards.shape == (1, 64) and none.applied.shape == (0, 64)
    assert none.costs.shape == (0,)


@pytest.mark.parametrize("fused", [False, True])
def test_receding_example_reaches_target(fused):
    """The example's configuration (horizon 4, 8 steps, replan every 2, 8
    candidates, 80 iterations) reaches the block along the exact dynamics,
    as ``test_receding_horizon_reaches_target`` and
    ``test_receding_fused_one_dispatch`` do."""
    r = receding_mpc.run("cpu", fused=fused)
    assert r["run"].boards.shape == (9, 64) and r["run"].costs.shape == (4,)
    assert r["exact_dynamics"]
    assert r["hamming"] == 0
