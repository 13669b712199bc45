"""Calibration kernel: a chain with a known op count, to measure the card's
ceiling in the port's integer mix.  Counterpart of
:mod:`lifeapi_tpu.ops.calibrate_pallas`.

An op below is one 64-bit integer operation on one ``int64`` word.  The
kernel in ``csrc/life_calibrate.cu`` runs, per iteration on every word,
:data:`UNITS_PER_ITER` units of ``a ^= b << 1; b += a >> 3``
(:data:`ELEMWISE_UNIT` ops each) and, in the ``"rolls"`` mix, first rolls
``a`` by +1 and ``b`` by -1 along the 64 words of a row (a shuffle and a
wrap select per word each, :data:`ROLL_OPS`).  :func:`calibrate` returns
``a ^ b`` and the op count; word-ops per second over the kernel's time is
the ceiling that ``chip_smoke.py`` divides the other kernels' op counts by.

A CUDA tensor launches the kernel, a CPU tensor takes the plain twin; no
fallback.  The twin also runs the chain on ``int32`` rows: that is the TPU
kernel's own function (``calibrate_pallas.calibrate`` on the transposed
``uint32[64, B]`` block), so the CPU tests hold the twin against the Pallas
kernel bit for bit.
"""

from __future__ import annotations

import torch

from ..core import bitops
from . import _build
from .step_cuda import _launch, _stream

LAUNCHES = {"calibrate": 0}

ELEMWISE_UNIT = 4  # xor + shl + add + shr
UNITS_PER_ITER = 4
ROLL_OPS = 4  # a and b: one shuffle and one wrap select each
MIXES = ("elemwise", "rolls")


def reset_launches():
    LAUNCHES["calibrate"] = 0


def ops_per_iter(mix):
    """Ops per word per iteration, counted by hand from the kernel."""
    if mix not in MIXES:
        raise ValueError(f"mix {mix!r} not in {MIXES}")
    return ELEMWISE_UNIT * UNITS_PER_ITER + (ROLL_OPS if mix == "rolls" else 0)


def _check(a, b, iters, mix, dtypes=(torch.int64,)):
    if not isinstance(a, torch.Tensor) or a.dtype not in dtypes:
        raise TypeError(f"a: expected {' or '.join(map(str, dtypes))} [B, 64] words")
    if a.dim() != 2 or a.shape[1] != 64 or not 0 < a.shape[0] < 2**31 // 64:
        raise ValueError(f"a: expected [B, 64], got {tuple(a.shape)}")
    if not isinstance(b, torch.Tensor) or b.dtype != a.dtype or b.shape != a.shape \
            or b.device != a.device:
        raise ValueError("b must match a in dtype, shape and device")
    if not 0 <= int(iters) < 2**31:
        raise ValueError(f"iters {iters} out of range")
    ops_per_iter(mix)
    return a.contiguous(), b.contiguous()


def _shr(x, s):
    """Logical right shift of int64 or int32 words."""
    if x.dtype == torch.int64:
        return bitops.shr64(x, s)
    return (x >> s) & (0x7FFFFFFF >> (s - 1))


def calibrate_plain(a, b, iters, mix="elemwise"):
    """The kernel's chain in plain PyTorch; ``a`` and ``b`` are ``[B, 64]``
    words, int64 or int32 (integer ops wrap, as on the card)."""
    a, b = _check(a, b, iters, mix, (torch.int64, torch.int32))
    for _ in range(int(iters)):
        if mix == "rolls":  # word i takes word i - 1 of a, word i + 1 of b
            a = torch.roll(a, 1, dims=-1)
            b = torch.roll(b, -1, dims=-1)
        for _ in range(UNITS_PER_ITER):
            a = a ^ (b << 1)
            b = b + _shr(a, 3)
    return a ^ b


def calibrate(a, b, iters, mix="elemwise"):
    """Run the chain on ``int64[B, 64]`` rows -> (``a ^ b`` after ``iters``
    iterations, the op count ``iters * ops_per_iter(mix) * B * 64``)."""
    a, b = _check(a, b, iters, mix)
    ops = int(iters) * ops_per_iter(mix) * a.numel()
    if not a.is_cuda:
        return calibrate_plain(a, b, iters, mix), ops
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        _launch(_build.library().life_calibrate, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), a.shape[0], int(iters), int(mix == "rolls"), _stream(a.device))
    LAUNCHES["calibrate"] += 1
    return out, ops
