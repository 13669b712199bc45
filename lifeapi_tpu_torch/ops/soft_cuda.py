"""The soft-Life rollout and its derivatives: hand-written CUDA kernels and
their plain PyTorch twins.

No TPU kernel stands behind these: the JAX package leaves
:func:`lifeapi_tpu.mpc.soft.soft_rollout` to XLA, which fuses it.  Run
eagerly, every generation is a dozen small kernels, and autograd's double
backward multiplies them into thousands a Hessian-vector product.  Here
each sweep over the horizon is one launch.

The map of one generation t, from x_0 = p0 and the controls u_t:

    q_t     = x_t (1 - u_t) + (1 - x_t) u_t       soft_toggle
    c_t     = N(q_t)                               neighbour_sum: the 3x3
                                                   torus sum less the centre
    x_{t+1} = q_t s(c_t) + (1 - q_t) b(c_t)        soft_step, with the gates
                                                   of soft_gates

and ``traj[t] = x_{t+1}``.  N is symmetric, so it is its own transpose.
Write d_q = s - b and d_c = q s' + (1 - q) b' for the step's partial
derivatives in q and c.  The three sweeps:

- :func:`rollout`: ``traj`` from ``p0`` and the controls, forward in time.
- :func:`rollout_vjp`: the cotangents of the controls and of ``p0`` from
  ``g_traj``, reverse in time, recomputing q and c from ``traj``:
  a_T = g_traj[T-1]; aq_t = a_{t+1} d_q + N(a_{t+1} d_c);
  g_u[t] = aq_t (1 - 2 x_t); a_t = aq_t (1 - 2 u_t) + g_traj[t-1].
  It also returns the adjoints ``lam[t] = a_{t+1}``.
- :func:`rollout_hvp`: the derivative of the VJP along cotangents
  (w_u, w_p0) of its outputs, with ``traj`` and ``lam`` held fixed: one
  sweep forward in time, the tangent beta_0 = w_p0,
  gamma_t = beta_t (1 - 2 u_t) + w_t (1 - 2 x_t),
  beta_{t+1} = d_q gamma_t + d_c N(gamma_t) (so ``jw[t] = beta_{t+1}`` is
  the cotangent of ``g_traj``), and the partials in the controls and the
  states from the gates' second derivatives.  The states' own dependence
  on the controls is left to autograd, which carries the state partials
  back through the rollout's VJP.

On a CUDA tensor each entry point launches its kernel in
``csrc/soft_life.cu`` on the current stream, the horizon looped inside
the kernel, the stencil's rows exchanged through shared memory.  The three
sweeps share one design: their inputs arrive by TMA copies into a ring of
stages in shared memory, and a candidate splits over a thread-block cluster
of two CTAs of 1024 threads, 2 cells a thread, which store the rows at their
edges into each other's shared memory.  The forward kernel computes
in the eager ops' order with their roundings, so it equals
:func:`rollout_plain` bit for bit on the card.  On a CPU tensor each entry
takes its plain twin, the same sweep written per generation in plain
PyTorch.  A CUDA tensor never falls back to the twin: a float64 tensor, or
anything else the kernel does not take, raises.  Nothing is read back to
the host.

Shapes: ``p0`` is ``[*pb, 64, 64]`` and the controls ``[T, *ub, 64, 64]``;
the candidates' shape is ``broadcast(pb, ub)``, and every result carries it
in full (the caller sums a broadcast input's gradient).  ``LAUNCHES``
counts the kernel launches of each entry point.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build
from .step_cuda import _launch, _stream

LAUNCHES = {"soft_rollout": 0, "soft_rollout_vjp": 0, "soft_rollout_hvp": 0}

BOARD = 4096  # cells of a 64 x 64 board


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the per-generation map, in eager ops
# ---------------------------------------------------------------------------


def neighbour_sum(p):
    """Expected live neighbours (center excluded), float [..., 64, 64]."""
    v = p + torch.roll(p, 1, dims=-1) + torch.roll(p, -1, dims=-1)
    total = v + torch.roll(v, 1, dims=-2) + torch.roll(v, -1, dims=-2)
    return total - p


def soft_gates(count, tau):
    """(survive, birth) gate values for a neighbour count."""
    sig = torch.sigmoid
    survive = sig((count - 1.5) / tau) * sig((3.5 - count) / tau)
    birth = sig((count - 2.5) / tau) * sig((3.5 - count) / tau)
    return survive, birth


def soft_step(p, tau=0.2):
    """One soft-Life generation on probabilities [..., 64, 64]."""
    count = neighbour_sum(p)
    survive, birth = soft_gates(count, tau)
    return p * survive + (1.0 - p) * birth


def soft_toggle(p, u):
    """Smooth XOR: toggle each cell with probability u."""
    return p * (1.0 - u) + (1.0 - p) * u


def gate_derivatives(count, tau):
    """The step's partials at a count: d_q = s - b, and of s and b the first
    and second derivatives in the count, as (d_q, s', b', s'', b'').  With
    sa, sb, sc the sigmoids of (c - 1.5) / tau, (3.5 - c) / tau and
    (c - 2.5) / tau: s' = s (sb - sa) / tau and
    s'' = s ((sb - sa)^2 - sb (1 - sb) - sa (1 - sa)) / tau^2; b alike with
    sc for sa."""
    sa = torch.sigmoid((count - 1.5) / tau)
    sb = torch.sigmoid((3.5 - count) / tau)
    sc = torch.sigmoid((count - 2.5) / tau)
    s, b = sa * sb, sc * sb
    curve = sb * (1 - sb)
    s1, b1 = s * (sb - sa) / tau, b * (sb - sc) / tau
    s2 = s * ((sb - sa) ** 2 - curve - sa * (1 - sa)) / tau**2
    b2 = b * ((sb - sc) ** 2 - curve - sc * (1 - sc)) / tau**2
    return s - b, s1, b1, s2, b2


# ---------------------------------------------------------------------------
# the plain twins
# ---------------------------------------------------------------------------


def rollout_plain(p0, controls, tau):
    """``traj`` ``[T, *batch, 64, 64]``: each generation toggled by its
    controls, then stepped."""
    p, traj = p0, []
    for u in controls:
        p = soft_step(soft_toggle(p, u), tau)
        traj.append(p)
    return torch.stack(traj)


def _state(p0, traj, t, batch):
    """x_t: ``p0`` at t = 0, else ``traj[t - 1]``, over the batch."""
    x = traj[t - 1] if t else p0
    return x.expand(*batch, 64, 64)


def _step_vjp(q, a, tau):
    """The cotangent of q from a, the cotangent of ``soft_step(q)``, by
    autograd of the eager step."""
    with torch.enable_grad():
        q = q.detach().requires_grad_(True)
        (g_q,) = torch.autograd.grad(soft_step(q, tau), q, a)
    return g_q


def rollout_vjp_plain(p0, controls, traj, g_traj, tau, want_p0):
    """(g_u ``[T, *batch, 64, 64]``, g_p0 ``[*batch, 64, 64]`` or None,
    lam ``[T, *batch, 64, 64]``), reverse in time.  Each generation's step
    is differentiated by autograd, and the toggle's cotangents are summed in
    the order autograd sums them through the eager loop, so on the CPU the
    gradient equals eager autograd's bit for bit."""
    batch = traj.shape[1:-2]
    steps = controls.shape[0]
    g_u, lam = [None] * steps, [None] * steps
    a = g_traj[steps - 1]
    for t in reversed(range(steps)):
        lam[t] = a
        x, u = _state(p0, traj, t, batch), controls[t]
        g_q = _step_vjp(soft_toggle(x, u), a, tau)
        # q = x (1 - u) + (1 - x) u
        g_u[t] = g_q * (1.0 - x) + -(g_q * x)
        a = -(g_q * u)
        a = (g_traj[t - 1] + a if t else a) + g_q * (1.0 - u)
    return torch.stack(g_u), (a if want_p0 else None), torch.stack(lam)


def rollout_hvp_plain(p0, controls, traj, lam, w_u, w_p0, tau, want_p0):
    """(jw, pu, px, px0): the cotangents of ``g_traj``, the controls,
    ``traj`` (each ``[T, *batch, 64, 64]``) and ``p0`` (``[*batch, 64, 64]``
    or None), forward in time.  ``w_p0`` None is zero."""
    batch = traj.shape[1:-2]
    steps = controls.shape[0]
    beta = torch.zeros_like(traj[0]) if w_p0 is None else w_p0.expand_as(traj[0])
    jw, pu, px = [], [], []
    px0 = None
    for t in range(steps):
        x, u, w, a = _state(p0, traj, t, batch), controls[t], w_u[t], lam[t]
        q = soft_toggle(x, u)
        dq, s1, b1, s2, b2 = gate_derivatives(neighbour_sum(q), tau)
        dc, dcq, dcc = q * s1 + (1 - q) * b1, s1 - b1, q * s2 + (1 - q) * b2
        gamma = beta * (1 - 2 * u) + w * (1 - 2 * x)
        m = neighbour_sum(gamma)
        aq = a * dq + neighbour_sum(a * dc)
        h = m * a * dcq + neighbour_sum(a * (gamma * dcq + m * dcc))
        pu.append(h * (1 - 2 * x) - 2 * aq * beta)
        px_t = h * (1 - 2 * u) - 2 * aq * w
        if t:
            px.append(px_t)
        elif want_p0:
            px0 = px_t
        beta = dq * gamma + dc * m
        jw.append(beta)
    px.append(torch.zeros_like(beta))  # traj[T - 1] is no generation's input
    return torch.stack(jw), torch.stack(pu), torch.stack(px), px0


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _batch_shape(p0, controls):
    for name, t, lead in (("p0", p0, 0), ("controls", controls, 1)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.dim() < 2 + lead or tuple(t.shape[-2:]) != (64, 64):
            raise ValueError(f"{name}: expected [{'T, ' * lead}..., 64, 64], "
                             f"got {tuple(t.shape)}")
    if controls.device != p0.device:
        raise ValueError(f"controls on {controls.device}, p0 on {p0.device}")
    return torch.broadcast_shapes(p0.shape[:-2], controls.shape[1:-2])


def _check(name, t, shape, like):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name}: on {t.device}, the controls on {like.device}")


def _kernel_dtype(*tensors):
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the soft-Life kernels take float32, got {t.dtype}")


def _aligned(t):
    """``t``, or a contiguous copy where its data does not start on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def _readable(flat):
    """``flat``, boards of 4096 cells along its last dimension, as the
    kernels read it: in 16-byte pieces through its outer strides; a copy
    where it cannot be read so."""
    if flat.stride(-1) != 1 or any(s % 4 for s in flat.stride()[:-1]):
        flat = flat.contiguous()
    return _aligned(flat)


def _boards(t, lead):
    """``t`` broadcast to ``[*lead, 64, 64]`` as ``[prod(lead), 4096]``
    (``_readable``), and its board stride in elements: 0 for a board
    broadcast to every candidate."""
    rows = _readable(t.expand(*lead, 64, 64).reshape(-1, BOARD))
    return rows, rows.stride(0)


def over_batch(t, batch):
    """A generation-major ``t`` ``[T, *tb, 64, 64]`` broadcast to
    ``[T, *batch, 64, 64]``: the batch dims line up from the right."""
    lead = (1,) * (len(batch) - (t.dim() - 3))
    return t.view(t.shape[0], *lead, *t.shape[1:]).expand(t.shape[0], *batch, 64, 64)


def sum_over_batch(g, shape):
    """The inverse of :func:`over_batch` for a gradient: ``g``
    ``[T, *batch, 64, 64]`` summed to a generation-major ``shape``."""
    extra = g.dim() - len(shape)
    if extra:
        g = g.sum(dim=tuple(range(1, 1 + extra)))
    return g.sum_to_size(shape)


def _controls(u, batch):
    """The controls ``[T, *batch, 64, 64]`` as a view ``[T, C, 4096]`` read
    through its two outer strides (``soft_objective`` hands over a
    ``movedim`` view), copied only where none exists; with those strides."""
    flat = _readable(over_batch(u, batch).reshape(u.shape[0], -1, BOARD))
    return flat, flat.stride(0), flat.stride(1)


def _inv_tau(tau):
    """1 / tau in float32, as aten scales by a Python scalar divisor: it
    multiplies by the float reciprocal of the float divisor."""
    tau = float(tau)
    if not tau > 0 or math.isinf(tau):
        raise ValueError(f"tau {tau} must be positive and finite")
    return ctypes.c_float(float(np.float32(1.0) / np.float32(tau)))


def _dense(t):
    """``t`` contiguous and starting on 16 bytes, copied where it is not."""
    return _aligned(t.contiguous())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _grid(batch):
    c = math.prod(batch)
    if not 0 < c < 2**31:
        raise ValueError(f"{c} candidates out of range")
    return c


SWEEP_KERNELS = {"rollout": 0, "rollout_vjp": 1, "rollout_hvp": 2}


def sweep_info(name):
    """How the current CUDA device runs the ``name`` sweep (``rollout``,
    ``rollout_vjp`` or ``rollout_hvp``), two CTAs a candidate: {threads and
    shared (dynamic bytes) a CTA, as launched; ctas_per_sm and clusters
    (resident at once over the card), from the runtime's occupancy
    calculator}."""
    info = (ctypes.c_int * 4)()
    _launch(_build.library().life_soft_sweep_info, SWEEP_KERNELS[name], info)
    return dict(zip(("threads", "shared", "ctas_per_sm", "clusters"), info))


def rollout(p0, controls, tau):
    """``traj`` ``[T, *batch, 64, 64]`` of :func:`rollout_plain`; on the card
    one launch, equal to the twin bit for bit."""
    batch = _batch_shape(p0, controls)
    if not controls.is_cuda:
        return rollout_plain(p0, controls, tau)
    _kernel_dtype(p0, controls)
    steps, c = controls.shape[0], _grid(batch)
    traj = torch.empty((steps, *batch, 64, 64), dtype=torch.float32, device=controls.device)
    if steps == 0:
        return traj
    p0_rows, p0_stride = _boards(p0, batch)
    u, u_st, u_sc = _controls(controls, batch)
    with torch.cuda.device(controls.device):
        _launch(_build.library().life_soft_rollout, p0_rows.data_ptr(), p0_stride, u.data_ptr(),
                u_st, u_sc, traj.data_ptr(), c, steps, _inv_tau(tau),
                _stream(controls.device))
    LAUNCHES["soft_rollout"] += 1
    return traj


def rollout_vjp(p0, controls, traj, g_traj, tau, want_p0=False):
    """(g_u, g_p0, lam) of :func:`rollout_vjp_plain`: the cotangents of the
    controls and, when ``want_p0``, of ``p0`` (else None), each over the
    full batch, and the adjoints.  On the card one launch."""
    batch = _batch_shape(p0, controls)
    steps = controls.shape[0]
    full = (steps, *batch, 64, 64)
    _check("traj", traj, full, controls)
    _check("g_traj", g_traj, full, controls)
    if steps == 0:
        raise ValueError("the VJP of an empty horizon is not defined here")
    if not controls.is_cuda:
        return rollout_vjp_plain(p0, controls, traj, g_traj, tau, want_p0)
    _kernel_dtype(p0, controls, traj, g_traj)
    c = _grid(batch)
    p0_rows, p0_stride = _boards(p0, batch)
    u, u_st, u_sc = _controls(controls, batch)
    traj, g_traj = _dense(traj), _dense(g_traj)
    g_u, lam = torch.empty_like(traj), torch.empty_like(traj)
    g_p0 = torch.empty(full[1:], dtype=torch.float32, device=traj.device) if want_p0 else None
    with torch.cuda.device(controls.device):
        _launch(_build.library().life_soft_rollout_vjp, p0_rows.data_ptr(), p0_stride,
                u.data_ptr(), u_st, u_sc, traj.data_ptr(), g_traj.data_ptr(),
                lam.data_ptr(), g_u.data_ptr(), _ptr(g_p0), c, steps, _inv_tau(tau),
                _stream(controls.device))
    LAUNCHES["soft_rollout_vjp"] += 1
    return g_u, g_p0, lam


def rollout_hvp(p0, controls, traj, lam, w_u, w_p0, tau, want_p0=False):
    """(jw, pu, px, px0) of :func:`rollout_hvp_plain`: ``w_u`` is
    ``[T, *batch, 64, 64]`` and ``w_p0`` broadcasts to ``[*batch, 64, 64]``
    or is None (zero).  On the card one launch."""
    batch = _batch_shape(p0, controls)
    steps = controls.shape[0]
    full = (steps, *batch, 64, 64)
    for name, t in (("traj", traj), ("lam", lam), ("w_u", w_u)):
        _check(name, t, full, controls)
    if w_p0 is not None:
        _check("w_p0", w_p0, w_p0.shape, controls)
    if steps == 0:
        raise ValueError("the VJP of an empty horizon is not defined here")
    if not controls.is_cuda:
        return rollout_hvp_plain(p0, controls, traj, lam, w_u, w_p0, tau, want_p0)
    _kernel_dtype(p0, controls, traj, lam, w_u, *([] if w_p0 is None else [w_p0]))
    c = _grid(batch)
    p0_rows, p0_stride = _boards(p0, batch)
    u, u_st, u_sc = _controls(controls, batch)
    traj, lam, w_u = _dense(traj), _dense(lam), _dense(w_u)
    w_rows, w_stride = (None, 0) if w_p0 is None else _boards(w_p0, batch)
    jw, pu, px = (torch.empty_like(traj) for _ in range(3))
    px0 = torch.empty(full[1:], dtype=torch.float32, device=traj.device) if want_p0 else None
    with torch.cuda.device(controls.device):
        _launch(_build.library().life_soft_rollout_hvp, p0_rows.data_ptr(), p0_stride,
                u.data_ptr(), u_st, u_sc, traj.data_ptr(), lam.data_ptr(), w_u.data_ptr(),
                _ptr(w_rows), w_stride, jw.data_ptr(), pu.data_ptr(), px.data_ptr(),
                _ptr(px0), c, steps, _inv_tau(tau), _stream(controls.device))
    LAUNCHES["soft_rollout_hvp"] += 1
    return jw, pu, px, px0
