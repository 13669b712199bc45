"""The rollout wrappers of ``lifeapi_tpu_torch.ops.step_cuda`` on CPU tensors
(their plain twins) against the JAX package's Pallas rollouts, run in
interpret mode as ``tests/test_step_pallas.py`` runs them.  Bit-exact.
The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda_kernels.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import bitops as jbits
from lifeapi_tpu.core import board as jb
from lifeapi_tpu.ops import step_pallas as K
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.ops import step_cuda
from lifeapi_tpu_torch.search import rollout_inputs
from oracle import random_dense
from torch_threads import one_torch_thread  # noqa: F401


def _boards(rng, batch, p):
    packed = jb.from_dense(jnp.asarray(random_dense(rng, p=p, batch=batch)))
    return packed, convert.board_from_packed(packed, device="cpu")


def _eo(packed):
    return jbits.interleave_split(*K.to_kernel_layout(packed))


def _from_eo(e, o):
    return np.asarray(K.from_kernel_layout(*jbits.interleave_merge(e, o)))


def test_rollout_matches_pallas(rng):
    packed, t = _boards(rng, (128,), 0.35)
    expect = K.rollout(packed, steps=8, batch_tile=128, interpret=True)
    got = step_cuda.rollout(t, 8)
    assert (convert.board_to_packed(got) == np.asarray(expect)).all()


def test_controlled_rollout_matches_pallas(rng):
    packed, t = _boards(rng, (128,), 0.3)
    T = 6
    tog_packed, tog = _boards(rng, (T, 128), 0.02)
    expect = K.controlled_rollout(packed, tog_packed, batch_tile=128, interpret=True)
    got = step_cuda.controlled_rollout(t, tog.contiguous())
    assert (convert.board_to_packed(got) == np.asarray(expect)).all()


def test_catalyst_rollout_matches_pallas(rng):
    glider = tb.from_cells([(8, 10), (9, 8), (9, 10), (10, 9), (10, 10)], device="cpu")
    eater = tb.from_cells([(24, 21), (24, 22), (25, 21), (25, 23), (26, 23),
                           (27, 23), (27, 24)], device="cpu")
    offsets = torch.from_numpy(rng.integers(-16, 4, size=(128, 2)))
    horizon = 16
    boards, placed, zoi, base = rollout_inputs(glider, eater, offsets, horizon)
    final, interacted = step_cuda.catalyst_rollout(boards, placed, zoi, base)

    bp = jnp.asarray(convert.board_to_packed(base))
    be, bo = jbits.interleave_split(bp[..., 0][:, :, None], bp[..., 1][:, :, None])
    planes = [_eo(jnp.asarray(convert.board_to_packed(x))) for x in (boards, placed, zoi)]
    fe, fo, ae, ao = K.catalyst_rollout_eo(
        be, bo, *planes[0], *planes[1], *planes[2], interpret=True)
    assert (convert.board_to_packed(final) == _from_eo(fe, fo)).all()
    expect_inter = np.asarray(jnp.any((ae | ao) != 0, axis=0))
    assert (interacted.numpy() == expect_inter).all()
    assert 0 < int(interacted.sum()) < 128  # the grid holds both kinds


def test_rollout_lohi_matches_pallas(rng):
    """The half-word layout helpers and the plain twin of ``rollout_lohi``
    against ``step_pallas.rollout_lohi`` in interpret mode, B=128, T=8."""
    packed, t = _boards(rng, (128,), 0.35)
    jlo, jhi = K.to_kernel_layout(packed)
    lo, hi = step_cuda.to_kernel_layout(t)
    assert lo.dtype == hi.dtype == torch.int32 and lo.shape == (64, 128)
    assert all((a == np.asarray(b)).all() for a, b in zip(convert.lohi_to_jax(lo, hi),
                                                          (jlo, jhi)))
    assert all(torch.equal(a, b) for a, b in zip(convert.lohi_from_jax(jlo, jhi, device="cpu"), (lo, hi)))
    assert torch.equal(step_cuda.from_kernel_layout(lo, hi), t)
    assert (convert.board_to_packed(step_cuda.from_kernel_layout(lo, hi))
            == np.asarray(K.from_kernel_layout(jlo, jhi))).all()
    want = K.rollout_lohi(jlo, jhi, steps=8, batch_tile=128, interpret=True)
    got = step_cuda.rollout_lohi(lo, hi, 8)
    assert all((a == np.asarray(b)).all() for a, b in zip(convert.lohi_to_jax(*got), want))
    assert torch.equal(step_cuda.from_kernel_layout(*got), step_cuda.rollout(t, 8))


@pytest.mark.parametrize("name", ["rollout", "controlled_rollout", "catalyst_rollout",
                                  "rollout_lohi"])
def test_cpu_tensors_take_plain_twin_without_launch(rng, name):
    """A CPU tensor is served by the plain twin: same result, no launch."""
    _, t = _boards(rng, (5,), 0.3)
    args = {
        "rollout": (t, 3),
        "controlled_rollout": (t, _boards(rng, (3, 5), 0.05)[1].contiguous()),
        "catalyst_rollout": (t, t & 7, tb.zoi(t & 7), _boards(rng, (4,), 0.3)[1]),
        "rollout_lohi": (*step_cuda.to_kernel_layout(t), 3),
    }[name]
    before = dict(step_cuda.LAUNCHES)
    got = getattr(step_cuda, name)(*args)
    expect = getattr(step_cuda, name + "_plain")(*args)
    got = got if isinstance(got, tuple) else (got,)
    expect = expect if isinstance(expect, tuple) else (expect,)
    assert all(torch.equal(g, e) for g, e in zip(got, expect))
    assert step_cuda.LAUNCHES == before


@pytest.mark.parametrize("bad, err", [
    (lambda t: t.to(torch.int32), TypeError),
    (lambda t: t[:, :32], ValueError),
    (lambda t: t.t(), ValueError),
    (lambda t: t[:0], ValueError),
    (lambda t: t[0], ValueError),
])
def test_wrappers_reject_bad_boards(rng, bad, err):
    _, t = _boards(rng, (64,), 0.3)
    with pytest.raises(err):
        step_cuda.rollout(bad(t), 2)
    with pytest.raises(err):
        step_cuda.controlled_rollout(bad(t), torch.zeros((2, 64, 64), dtype=torch.int64))
    with pytest.raises(err):
        step_cuda.catalyst_rollout(bad(t), t, t, t[:3])


def test_wrappers_reject_mismatched_operands(rng):
    _, t = _boards(rng, (8,), 0.3)
    with pytest.raises(ValueError):
        step_cuda.rollout(t, -1)
    with pytest.raises(ValueError):
        step_cuda.controlled_rollout(t, torch.zeros((2, 7, 64), dtype=torch.int64))
    with pytest.raises(ValueError):
        step_cuda.catalyst_rollout(t, t[:7], t, t[:3])
    with pytest.raises(ValueError):
        step_cuda.catalyst_rollout(t, t, t, t[0])


def test_rollout_lohi_rejects_bad_input(rng):
    _, t = _boards(rng, (8,), 0.3)
    lo, hi = step_cuda.to_kernel_layout(t)
    for bad_lo, bad_hi, err in (
            (lo.to(torch.int64), hi, TypeError),  # the words, not half-words
            (lo, hi.to(torch.int64), TypeError),
            (lo[:32], hi[:32], ValueError),  # 64 rows
            (lo[:, :0], hi[:, :0], ValueError),  # empty batch
            (lo, hi[:, :7], ValueError),  # mismatched batch
            (lo.t(), hi.t(), ValueError),  # [B, 64] layout
            (lo[:, ::2], hi[:, ::2], ValueError)):  # not contiguous
        with pytest.raises(err):
            step_cuda.rollout_lohi(bad_lo, bad_hi, 2)
    with pytest.raises(ValueError):
        step_cuda.rollout_lohi(lo, hi, -1)
