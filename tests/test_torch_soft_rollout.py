"""The fused soft-Life sweeps (``ops/soft_cuda.py``) and the autograd
Functions over them (``mpc/soft.py``) against autograd of the eager
per-generation loop and against :mod:`lifeapi_tpu.mpc.soft`, on the CPU,
where every sweep runs its plain twin.  The kernels themselves are held to
the twins on the card (``tests/test_torch_cuda_kernels.py``).

Tolerances: float32 rtol 1e-5 and an atol of 1e-6 times the largest
magnitude of the expected tensor, against torch's autograd: the sweeps sum
a cell's contributions in another order than autograd does, and the map
carries a rounding in one cell to its neighbours, growing with the
derivatives themselves (a tangent grows about 400-fold over the 5
generations of these random boards), so an element's error scales with
the tensor's largest elements rather than with itself;
float64 ``gradcheck`` / ``gradgradcheck`` at their defaults; against JAX
rtol 1e-5 / atol 1e-5 for values and rtol 1e-4 / atol 1e-5 for gradients
and Hessian-vector products, as ``tests/test_torch_mpc.py`` compares them,
each atol scaled by the expected tensor's largest magnitude for the same
reason.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.mpc import soft as jsoft
from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.core import rle
from lifeapi_tpu_torch.mpc import CostWeights, MPCProblem, solver
from lifeapi_tpu_torch.mpc import soft
from lifeapi_tpu_torch.ops import soft_cuda
from lifeapi_tpu_torch.target import LifeTarget
from torch_threads import one_torch_thread  # noqa: F401

def assert_f32(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
VALUE = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def assert_jax(got, want, tol):
    """``tol``'s atol scaled by the largest magnitude of ``want``, as for
    float32 above."""
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * float(np.abs(want).max()))
T, C, TAU = 5, 3, 0.25


def _inputs(seed, dtype=np.float32, steps=T, cands=C, window=None):
    """p0 [64, 64] and controls [T, C, 64, 64] of the solver's kind: a
    random board, and the toggle probabilities of ``init_logits``'s draw
    (logits -3 + 0.5 N(0, 1)).  With ``window``, the board's cells and the
    controls lie in the square [24, 24 + window)^2 only, as an MPC
    problem's pattern and control mask do."""
    rng = np.random.default_rng(seed)
    p0 = (rng.random((64, 64)) < 0.3) * 1.0
    u = 1 / (1 + np.exp(-(rng.normal(-3.0, 0.5, (steps, cands, 64, 64)))))
    if window:
        inside = np.zeros((64, 64), bool)
        inside[24:24 + window, 24:24 + window] = True
        p0, u = p0 * inside, u * inside
    return p0.astype(dtype), u.astype(dtype)


def _eager(p0, controls, tau=TAU):
    """The per-generation loop of ``soft_toggle`` / ``soft_step``, under
    plain autograd, and its states x_1..x_T."""
    p, traj = p0, []
    for u in controls:
        p = soft.soft_step(soft.soft_toggle(p, u), tau)
        traj.append(p)
    return torch.stack(traj), traj


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrays]


def test_forward_twin_equals_the_eager_loop_bit_for_bit():
    p0, u = map(torch.from_numpy, _inputs(0))
    want, _ = _eager(p0, u)
    assert torch.equal(soft_cuda.rollout_plain(p0, u, TAU), want)
    assert torch.equal(soft_cuda.rollout(p0, u, TAU), want)
    final, traj = soft.soft_rollout(p0, u, TAU)
    assert torch.equal(traj, want) and torch.equal(final, want[-1])


@pytest.mark.parametrize("want_p0", [False, True])
def test_vjp_twin_matches_autograd(want_p0):
    p0, u = _leaves(*_inputs(1))
    traj, states = _eager(p0, u)
    g_traj = torch.from_numpy(np.random.default_rng(2).standard_normal(traj.shape)
                              .astype(np.float32))
    g_u, g_p0, lam = soft_cuda.rollout_vjp(p0.detach(), u.detach(), traj.detach(), g_traj,
                                           TAU, want_p0)
    want = torch.autograd.grad(traj, [u, p0, *states], g_traj)
    assert_f32(g_u, want[0])
    assert_f32(lam, torch.stack(want[2:]))
    if want_p0:
        assert_f32(g_p0.sum(0), want[1])
    else:
        assert g_p0 is None


def test_hvp_twin_matches_forward_over_reverse():
    """jw against forward mode of the rollout, and the HVP of an objective
    through both Functions against double backward of the eager loop."""
    rng = np.random.default_rng(3)
    p0, u = _inputs(3)
    w_u = rng.standard_normal(u.shape).astype(np.float32)
    w_p0 = rng.standard_normal(p0.shape).astype(np.float32)
    traj = soft_cuda.rollout(*map(torch.from_numpy, (p0, u)), TAU)
    lam = torch.from_numpy(rng.standard_normal(traj.shape).astype(np.float32))
    jw, _, _, _ = soft_cuda.rollout_hvp(torch.from_numpy(p0), torch.from_numpy(u), traj,
                                        soft_cuda.rollout_vjp(torch.from_numpy(p0),
                                                              torch.from_numpy(u), traj,
                                                              lam, TAU)[2],
                                        torch.from_numpy(w_u), torch.from_numpy(w_p0), TAU)
    _, tangent = torch.func.jvp(lambda a, b: _eager(a, b)[0], tuple(map(torch.from_numpy, (p0, u))),
                                (torch.from_numpy(w_p0), torch.from_numpy(w_u)))
    assert_f32(jw, tangent)

    target = torch.from_numpy(rng.random((64, 64)).astype(np.float32))

    def objective(rollout, a, b):
        final, traj = rollout(a, b)
        return ((final - target) ** 2).sum() + 0.5 * (traj * traj).mean() * traj.shape[0]

    def hvp(rollout):
        a, b = _leaves(p0, u)
        ga, gb = torch.autograd.grad(objective(rollout, a, b), (a, b), create_graph=True)
        return torch.autograd.grad((ga * torch.from_numpy(w_p0)).sum()
                                   + (gb * torch.from_numpy(w_u)).sum(), (a, b))

    got = hvp(lambda a, b: soft.soft_rollout(a, b, TAU))
    want = hvp(lambda a, b: (_eager(a, b)[1][-1], _eager(a, b)[0]))
    for g, e in zip(got, want):
        assert_f32(g, e)


def _slice_objective(dtype=torch.float64, steps=3, cands=2):
    """A scalar objective of 16 control entries and 4 start cells: the
    controls ``base + P theta`` inside a window, p0 ``base0 + Q phi``."""
    p0, u = (torch.from_numpy(a) for a in _inputs(4, np.float64, steps, cands))
    cells = [(t % steps, t % cands, 30 + t // 4, 30 + t % 4) for t in range(16)]
    starts = [(31, 31), (31, 32), (32, 31), (33, 33)]
    target = torch.from_numpy(np.random.default_rng(5).random((64, 64)))

    def objective(theta, phi):
        controls = u.clone()
        for k, idx in enumerate(cells):
            controls[idx] = controls[idx] + theta[k]
        start = p0.clone()
        for k, idx in enumerate(starts):
            start[idx] = start[idx] + phi[k]
        final, traj = soft.soft_rollout(start, controls, TAU)
        return ((final - target) ** 2).sum() + (traj ** 2).sum() / 7

    return objective


def test_gradcheck_and_gradgradcheck_in_float64():
    objective = _slice_objective()
    gen = torch.Generator().manual_seed(6)
    theta = (torch.rand(16, generator=gen, dtype=torch.float64) * 0.1).requires_grad_(True)
    phi = (torch.rand(4, generator=gen, dtype=torch.float64) * 0.1).requires_grad_(True)
    assert torch.autograd.gradcheck(objective, (theta, phi))
    assert torch.autograd.gradgradcheck(objective, (theta, phi))


def _cubic_hvp(rollout, create_graph=False):
    """(u, p0 leaves, the direction (v, v0), the HVP (h, h0)) of
    f = sum traj^3 at T=3, C=2, tau 0.5, in float64, from a numpy seed."""
    p0, u = _inputs(13, np.float64, steps=3, cands=2)
    rng = np.random.default_rng(14)
    v, v0 = (torch.from_numpy(rng.standard_normal(a.shape)) for a in (u, p0))
    uu, pp = _leaves(u, p0)
    traj = rollout(pp, uu)
    g, g0 = torch.autograd.grad((traj ** 3).sum(), (uu, pp), create_graph=True)
    h, h0 = torch.autograd.grad((g * v).sum() + (g0 * v0).sum(), (uu, pp),
                                create_graph=create_graph)
    return uu, pp, h, h0


def test_hvp_of_a_cubic_equals_the_eager_loops_in_float64():
    """The HVP sweep's second derivative against double backward of the
    eager loop, float64 (rtol 1e-9: the sweep's closed-form partials and
    autograd round differently)."""
    *_, h, h0 = _cubic_hvp(lambda a, b: soft.soft_rollout(a, b, 0.5)[1])
    *_, e, e0 = _cubic_hvp(lambda a, b: _eager(a, b, 0.5)[0])
    torch.testing.assert_close(h, e, rtol=1e-9, atol=1e-12 * float(e.abs().max()))
    torch.testing.assert_close(h0, e0, rtol=1e-9, atol=1e-12 * float(e0.abs().max()))


@pytest.mark.parametrize("wrt", ["controls", "p0"])
def test_a_third_derivative_through_soft_rollout_raises(wrt):
    """The HVP sweep has no derivative: a third ``autograd.grad`` through a
    second taken with ``create_graph`` raises instead of returning a
    number without the adjoints' dependence on the controls."""
    uu, pp, h, h0 = _cubic_hvp(lambda a, b: soft.soft_rollout(a, b, 0.5)[1],
                               create_graph=True)
    w = torch.from_numpy(np.random.default_rng(15).standard_normal(h.shape))
    with pytest.raises(RuntimeError, match="differentiates twice at most"):
        torch.autograd.grad((h * w).sum() + h0.sum(), uu if wrt == "controls" else pp)


def _problem(horizon=4):
    block = B.move(rle.parse("2o$2o!", device="cpu"), 10, 10)
    mask = torch.zeros((64, 64), dtype=torch.bool)
    mask[36:46, 36:46] = True
    target = LifeTarget.from_state(B.move(rle.parse("2o$2o!", device="cpu"), 40, 40))
    return MPCProblem(initial=block, target=target, horizon=horizon, control_mask=mask,
                      protected=B.to_dense(B.zoi(block)), background=block,
                      weights=CostWeights(target=1.0, control=0.01, stable=5.0, path=0.5))


def test_solver_objective_and_gradient_equal_the_eager_loops_bit_for_bit(monkeypatch):
    """Through the Functions the CPU gives the eager loop's objective and
    gradient to the last bit: a replaced ``soft_step`` (here the same map
    under another name) makes ``soft_rollout`` loop it eagerly."""
    problem = _problem()
    logits = solver.init_logits(torch.Generator().manual_seed(0), problem, C)

    def objective(x):
        return solver.soft_objective(x, problem)

    got = solver.value_and_grad(objective, logits)
    monkeypatch.setattr(soft, "soft_step", lambda p, tau=0.2: soft_cuda.soft_step(p, tau))
    want = solver.value_and_grad(objective, logits)
    for g, e in zip(got, want):
        assert torch.equal(g, e)


def test_a_replaced_map_is_looped_eagerly(monkeypatch):
    p0, u = map(torch.from_numpy, _inputs(7))
    monkeypatch.setattr(soft, "soft_step", lambda p, tau=0.2: soft_cuda.soft_step(p, tau) * 0.5)
    _, traj = soft.soft_rollout(p0, u, TAU)
    assert torch.equal(traj[0], soft_cuda.soft_step(soft.soft_toggle(p0, u[0]), TAU) * 0.5)


@pytest.mark.parametrize("tau", [0.15, 0.25, 0.6])
def test_rollout_value_gradient_and_hvp_match_jax(tau):
    p0, u = _inputs(8, cands=2, window=12)
    rng = np.random.default_rng(9)
    g_traj = rng.standard_normal((T, 2, 64, 64)).astype(np.float32)
    v = rng.standard_normal(u.shape).astype(np.float32)

    jp0 = jnp.broadcast_to(jnp.asarray(p0), u.shape[1:])  # JAX's carry keeps its shape

    def jax_obj(uu):
        final, traj = jsoft.soft_rollout(jp0, uu, tau=tau)
        return jnp.sum(traj * g_traj) + jnp.sum(final ** 2)

    jgrad = jax.grad(jax_obj)
    jg = jgrad(jnp.asarray(u))
    _, jhv = jax.jvp(jgrad, (jnp.asarray(u),), (jnp.asarray(v),))

    uu = torch.from_numpy(u).requires_grad_(True)
    final, traj = soft.soft_rollout(torch.from_numpy(p0), uu, tau)
    assert_jax(traj.detach().numpy(),
               np.asarray(jsoft.soft_rollout(jp0, jnp.asarray(u), tau=tau)[1]), VALUE)
    obj = (traj * torch.from_numpy(g_traj)).sum() + (final ** 2).sum()
    (g,) = torch.autograd.grad(obj, uu, create_graph=True)
    (hv,) = torch.autograd.grad(g, uu, torch.from_numpy(v))
    assert_jax(g.detach().numpy(), np.asarray(jg), GRAD)
    assert_jax(hv.numpy(), np.asarray(jhv), GRAD)


def test_candidates_broadcast_from_either_side():
    """p0 per candidate and controls shared, and a 2-D candidate shape: the
    gradients of broadcast inputs are summed back to their shapes."""
    p0, u = _inputs(10)
    pc = torch.from_numpy(np.stack([p0, 1 - p0])).requires_grad_(True)  # [2, 64, 64]
    shared = torch.from_numpy(u[:, 0]).requires_grad_(True)  # [T, 64, 64]
    _, traj = soft.soft_rollout(pc, shared, TAU)
    want, _ = _eager(pc, shared)
    assert traj.shape == (T, 2, 64, 64) and torch.equal(traj, want)
    got = torch.autograd.grad(traj.sum(), (pc, shared))
    expect = torch.autograd.grad(want.sum(), (pc, shared))
    for g, e in zip(got, expect):
        assert g.shape == e.shape
        assert_f32(g, e)
    grid = torch.from_numpy(u[:, :2]).reshape(T, 2, 1, 64, 64).expand(T, 2, 3, 64, 64)
    _, traj = soft.soft_rollout(torch.from_numpy(p0), grid, TAU)
    assert traj.shape == (T, 2, 3, 64, 64)
    assert torch.equal(traj[:, :, 2], _eager(torch.from_numpy(p0), torch.from_numpy(u[:, :2]))[0])


def test_the_wrappers_check_their_inputs():
    p0, u = map(torch.from_numpy, _inputs(11))
    with pytest.raises(ValueError):
        soft_cuda.rollout(p0[:32], u, TAU)
    with pytest.raises(TypeError):
        soft_cuda.rollout(p0.numpy(), u, TAU)
    traj = soft_cuda.rollout(p0, u, TAU)
    with pytest.raises(ValueError):
        soft_cuda.rollout_vjp(p0, u, traj[1:], traj, TAU)
    with pytest.raises(ValueError):
        soft_cuda.rollout_hvp(p0, u, traj, traj, traj[:, :1], None, TAU)


def test_launch_counters_stay_at_zero_on_the_cpu():
    soft_cuda.reset_launches()
    p0, u = _leaves(*_inputs(12))
    _, traj = soft.soft_rollout(p0, u, TAU)
    (g,) = torch.autograd.grad(traj.sum(), u, create_graph=True)
    torch.autograd.grad(g.sum(), u)
    assert soft_cuda.LAUNCHES == dict.fromkeys(soft_cuda.LAUNCHES, 0)


def test_the_kernels_read_the_solvers_views_in_place():
    """The layout the kernels are handed, worked out on the CPU: the
    controls' ``movedim`` view through its strides, a start board broadcast
    to every candidate at stride 0, and a copy only where a view cannot be
    read in 16-byte pieces."""
    logits = torch.zeros((C, T, 64, 64))
    controls = logits.movedim(-3, 0)
    flat, st, sc = soft_cuda._controls(controls, (C,))
    assert flat.data_ptr() == controls.data_ptr() and (st, sc) == (4096, T * 4096)
    rows, stride = soft_cuda._boards(torch.zeros((64, 64)), (C,))
    assert rows.shape == (C, 4096) and stride == 0
    odd = torch.zeros(4096 * C + 1)[1:].view(C, 64, 64)  # 4 bytes off 16
    rows, stride = soft_cuda._boards(odd, (C,))
    assert rows.data_ptr() % 16 == 0 and stride == 4096
    shared = torch.zeros((T, 64, 64))
    flat, st, sc = soft_cuda._controls(shared, (C,))
    assert flat.shape == (T, C, 4096) and (st, sc) == (4096, 0)


def test_soft_accuracy_compares_both_paths_at_the_same_logits(monkeypatch, capsys):
    """``soft_accuracy.py`` on the CPU at a small size: on the CPU the
    sweeps' gradient is the eager loop's bit for bit, so both paths read
    the same gradient errors."""
    import soft_accuracy
    from bench_torch import measure, run
    from lifeapi_tpu_torch import _device

    cell = run.workloads()[soft_accuracy.CELL]
    small = dict(cell, traffic=dict(cell["traffic"], candidates=2, horizon=2),
                 limits=dict(cell["limits"], soft_objective=7.5, gradient_rel_err=1e-4,
                             hvp_rel_err=1e-4))
    monkeypatch.setattr(_device, "resolve", lambda *a, **k: torch.device("cpu"))
    monkeypatch.setattr(measure, "card_line", lambda: "no card")
    monkeypatch.setattr(run, "workloads", lambda: {soft_accuracy.CELL: small})
    assert soft_accuracy.main(["--solves", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    sweeps, eager = (next(line for line in lines if f"] {path}:" in line)
                     for path in ("sweeps", "eager"))
    assert sweeps.split("; HVP")[0].split(": ", 1)[1] == eager.split("; HVP")[0].split(": ", 1)[1]
    assert soft.soft_step is soft_cuda.soft_step
