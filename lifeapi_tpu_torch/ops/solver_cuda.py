"""The SQP solve's per-iteration updates: conjugate gradients' update and
adam's step, each a hand-written CUDA kernel and its plain PyTorch twin.

No TPU kernel stands behind these: the JAX package leaves
``jax.vmap(jax.scipy.sparse.linalg.cg)`` and ``optax.adam``
(:mod:`lifeapi_tpu.mpc.solver`) to XLA, which fuses them.  Run eagerly, a
CG iteration's update is about 19 launches and an adam step 14, each a pass
over the logits' ``[C, T, 64, 64]``; on the card each is one launch of
``csrc/solver_update.cu`` on the current stream.

- :func:`cg_update`: one iteration of conjugate gradients on a batch of
  independent systems, one per leading index, in place: the step
  ``alpha = gamma / <p, ap>``, ``x += alpha p``, ``r -= alpha ap``, the
  next ``gamma = <r, r>`` and direction ``p = r + (gamma' / gamma) p``,
  each system frozen once ``gamma <= stop``.  The kernel runs a system on
  a cluster of CTAs that keep their share of ``p`` and ``ap`` in shared
  memory and of ``x`` and ``r`` in registers across both dot products, so
  it reads each element once and writes it once (up to horizon 32 at
  64 x 64 cells; a longer system is walked in tiles); :func:`cg_update_info` gives its
  launch shape.  It reduces both dot products in a fixed order, so a solve
  gives the same iterates from run to run; it sums them in another order
  than ``torch.sum``, so it is held to its twin within a tolerance.
- :func:`adam_update`: optax's adam step, the moments and the logits into
  new tensors; the kernel rounds every operation as the eager ops do on the
  card and equals its twin bit for bit.

On a CPU tensor each entry takes its twin, which is the eager code the
solver ran before these kernels, operation for operation.  A CUDA tensor
never falls back to the twin: anything the kernel does not take raises.
Nothing is read back to the host.  ``LAUNCHES`` counts the kernel launches
of each entry point.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .step_cuda import _aligned, _launch, _stream

LAUNCHES = {"cg_update": 0, "adam_update": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def batch_dot(a, b):
    """Per-system dot product over every dimension but the first."""
    return (a * b).flatten(1).sum(dim=1)


# ---------------------------------------------------------------------------
# the plain twins
# ---------------------------------------------------------------------------


def cg_update_plain(x, r, p, ap, gamma, stop):
    """One iteration of conjugate gradients, in place, as the eager loop
    computes it: every system's update, then ``torch.where`` keeps a
    frozen system's state (a mask multiplied in would carry its 0/0)."""
    view = (-1,) + (1,) * (x.dim() - 1)
    active = gamma > stop
    alpha = (gamma / batch_dot(p, ap)).view(view)
    x_new = x + alpha * p
    r_new = r - alpha * ap
    gamma_new = batch_dot(r_new, r_new)
    p_new = r_new + (gamma_new / gamma).view(view) * p
    a = active.view(view)
    x.copy_(torch.where(a, x_new, x))
    r.copy_(torch.where(a, r_new, r))
    p.copy_(torch.where(a, p_new, p))
    gamma.copy_(torch.where(active, gamma_new, gamma))


def adam_update_plain(logits, grads, mu, nu, count, lr, b1, b2, eps):
    """(logits, mu, nu) after adam's step ``count`` (from 1) with optax's
    numerics: bias-corrected moments, eps outside the square root."""
    mu = (1 - b1) * grads + b1 * mu
    nu = (1 - b2) * grads * grads + b2 * nu
    mu_hat = mu / (1 - b1 ** count)
    nu_hat = nu / (1 - b2 ** count)
    logits = logits - lr * (mu_hat / (torch.sqrt(nu_hat) + eps))
    return logits, mu, nu


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _float32_on(tensors, device, what):
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, {what} on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the {what} kernel takes float32, got {t.dtype}")


def cg_update(x, r, p, ap, gamma, stop):
    """One iteration of conjugate gradients on the systems of ``x``, ``r``,
    ``p`` and ``ap`` (``[S, ...]``, one system per leading index), in place
    on ``x``, ``r``, ``p`` and ``gamma`` (``[S]``); ``stop`` ``[S]`` is each
    system's stopping level.  ``x``, ``r`` and ``p`` must not overlap; ``ap``
    may be ``p``.  On the card one launch, on contiguous state; state that
    does not start on 16 bytes (the kernel's pieces) is updated in a copy
    and copied back."""
    if not x.is_cuda:
        return cg_update_plain(x, r, p, ap, gamma, stop)
    _float32_on({"x": x, "r": r, "p": p, "ap": ap, "gamma": gamma, "stop": stop}, x.device,
                "conjugate gradients'")
    systems = x.shape[0] if x.dim() else 0
    for name, t in (("r", r), ("p", p), ("ap", ap)):
        if t.shape != x.shape:
            raise ValueError(f"{name}: expected shape {tuple(x.shape)}, got {tuple(t.shape)}")
    for name, t in (("gamma", gamma), ("stop", stop)):
        if tuple(t.shape) != (systems,):
            raise ValueError(f"{name}: expected shape ({systems},), got {tuple(t.shape)}")
    for name, t in (("x", x), ("r", r), ("p", p), ("gamma", gamma)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: updated in place, so it must be contiguous")
    if not 0 < systems < 2**31 // 8:
        raise ValueError(f"{systems} systems out of range")
    n = x.numel() // systems
    if n == 0:
        return
    state = [_aligned(t) for t in (x, r, p)]
    ap = state[2] if ap is p else _aligned(ap.contiguous())
    stop = stop.contiguous()
    with torch.cuda.device(x.device):
        _launch(_build.library().life_cg_update, *(t.data_ptr() for t in state), ap.data_ptr(),
                gamma.data_ptr(), stop.data_ptr(), systems, n, _stream(x.device))
    LAUNCHES["cg_update"] += 1
    for t, copy in zip((x, r, p), state):
        if copy is not t:
            t.copy_(copy)


def cg_update_info(n, ap_is_p=False):
    """How the current CUDA device runs :func:`cg_update` on systems of
    ``n`` elements (``ap`` apart from ``p``, or ``p`` itself): {threads a
    CTA, ctas (a system's cluster), shared (dynamic bytes a CTA) and tile
    (16-byte pieces of ``p`` and of ``ap`` a CTA holds in shared memory), as
    launched; ctas_per_sm and clusters (resident at once over the card),
    from the runtime's occupancy calculator}."""
    info = (ctypes.c_int * 6)()
    _launch(_build.library().life_cg_update_info, n, int(ap_is_p), info)
    return dict(zip(("threads", "ctas", "shared", "tile", "ctas_per_sm", "clusters"), info))


def _f32(value):
    return ctypes.c_float(float(np.float32(value)))


def _reciprocal(divisor):
    """What aten multiplies by for a division by the Python scalar
    ``divisor``: its reciprocal, taken in double and rounded to float32."""
    return np.float32(1.0 / divisor)


def adam_update(logits, grads, mu, nu, count, lr, b1, b2, eps):
    """(logits, mu, nu) of :func:`adam_update_plain`, new tensors.  On the
    card one launch: the Python scalars enter as float32, as aten casts them,
    and each bias correction as the float32 reciprocal aten multiplies by."""
    if not logits.is_cuda:
        return adam_update_plain(logits, grads, mu, nu, count, lr, b1, b2, eps)
    _float32_on({"logits": logits, "grads": grads, "mu": mu, "nu": nu}, logits.device, "adam")
    for name, t in (("grads", grads), ("mu", mu), ("nu", nu)):
        if t.shape != logits.shape:
            raise ValueError(f"{name}: expected shape {tuple(logits.shape)}, got "
                             f"{tuple(t.shape)}")
    # contiguous and starting on 16 bytes: the kernel reads 16-byte pieces
    ins = [t.contiguous() for t in (logits, grads, mu, nu)]
    ins = [t if t.data_ptr() % 16 == 0 else t.clone() for t in ins]
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if logits.numel() == 0:
        return tuple(outs)
    with torch.cuda.device(logits.device):
        _launch(_build.library().life_adam_update, *(t.data_ptr() for t in ins + outs),
                logits.numel(), _f32(1 - b1), _f32(b1), _f32(1 - b2), _f32(b2),
                _f32(_reciprocal(1 - b1 ** count)), _f32(_reciprocal(1 - b2 ** count)),
                _f32(eps), _f32(lr),
                _stream(logits.device))
    LAUNCHES["adam_update"] += 1
    return tuple(outs)
