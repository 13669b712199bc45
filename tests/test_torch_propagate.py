"""The port's dense still-life propagation (``lifeapi_tpu_torch.stable.
propagate``) against :mod:`lifeapi_tpu.stable.propagate`: every rule, the
fixpoints, the lattice ops, the cell ops, ``vulnerable``, the lookahead and
the RLE writer, on the same numpy-seeded instances (partial still lifes
that propagate consistently, and noisy boards that end inconsistent).
Bit-exact.  Also the dense fixpoint against the port's bit-plane one."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.stable import host as JH
from lifeapi_tpu.stable import options as jopt
from lifeapi_tpu.stable import propagate as JP
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.stable import bitplane as BP
from lifeapi_tpu_torch.stable import propagate as P
from oracle import random_dense
from torch_threads import one_torch_thread  # noqa: F401

N = 64


def _noisy(rng, batch, p_ruled=0.1):
    """Random state / unknown / ruled planes: mostly inconsistent."""
    state = random_dense(rng, p=0.15, batch=(batch,))
    unknown = random_dense(rng, p=0.25, batch=(batch,)) & ~state
    bits = rng.random((batch, N, N, 8)) < p_ruled
    ruled = (bits.astype(np.uint8) << np.arange(8, dtype=np.uint8)).sum(-1).astype(np.uint8)
    return state, unknown, ruled


def _blocks(rng, batch, p_hide=0.3):
    """Scattered 2x2 blocks with hidden cells and a 2-ring of unknowns."""
    states, unknowns = [], []
    for _ in range(batch):
        truth = np.zeros((N, N), bool)
        for _ in range(6):
            x, y = rng.integers(4, 56, 2)
            truth[x:x + 2, y:y + 2] = True
        hide = (rng.random((N, N)) < p_hide) & JH.zoi(truth)
        states.append(truth & ~hide)
        unknowns.append(hide | (JH.zoi(JH.zoi(truth)) & ~truth))
    return np.stack(states), np.stack(unknowns), np.zeros((batch, N, N), np.uint8)


def _pair(state, unknown, ruled):
    """The same instances as a JAX and a port ``Stable``."""
    j = JP.Stable(jnp.asarray(state), jnp.asarray(unknown), jnp.asarray(ruled))
    return j, convert.stable_from_jax(j, device="cpu")


@pytest.fixture
def instances(rng):
    """8 boards: 4 block instances (p_hide 0.3 and 0.7), 4 noisy ones."""
    parts = [_blocks(rng, 2), _blocks(rng, 2, p_hide=0.7), _noisy(rng, 4)]
    return _pair(*(np.concatenate(x) for x in zip(*parts)))


def _same_stable(t, j):
    assert (t.state.numpy() == np.asarray(j.state)).all()
    assert (t.unknown.numpy() == np.asarray(j.unknown)).all()
    assert t.ruled.dtype == torch.uint8
    assert (t.ruled.numpy() == np.asarray(j.ruled)).all()


def _same_result(t, j):
    _same_stable(t.stable, j.stable)
    assert (t.consistent.numpy() == np.asarray(j.consistent)).all()
    assert (t.changed.numpy() == np.asarray(j.changed)).all()


def test_window_helpers(rng):
    d = random_dense(rng, p=0.3, batch=(3,))
    j, t = jnp.asarray(d), torch.from_numpy(d)
    assert (P.count9(t).numpy() == np.asarray(JP.count9(j))).all()
    assert (P.zoi_dense(t).numpy() == np.asarray(JP.zoi_dense(j))).all()
    assert (P.zoi_hollow_dense(t).numpy() == np.asarray(JP.zoi_hollow_dense(j))).all()


@pytest.mark.parametrize("name", ["synchronise_state_known", "update_options",
                                  "signal_neighbours", "propagate_simple_step",
                                  "propagate_step", "propagate", "stabilise_options",
                                  "propagate_simple"])
def test_rules_and_fixpoints(instances, name):
    j, t = instances
    _same_result(getattr(P, name)(t), getattr(JP, name)(j))


def test_fixpoint_flags_cover_both_kinds(instances):
    j, t = instances
    res = P.propagate(t)
    assert res.consistent.any() and not res.consistent.all()
    assert (P.center_code(t).numpy() == np.asarray(JP.center_code(j))).all()


def test_cell_ops(instances, rng):
    j, t = instances
    cells = random_dense(rng, p=0.1, batch=(8,))
    jc, tc = jnp.asarray(cells), torch.from_numpy(cells)
    _same_stable(P.set_on(t, tc), JP.set_on(j, jc))
    _same_stable(P.set_off(t, tc), JP.set_off(j, jc))
    for keep in (jopt.LIVE2, jopt.DEAD_MASK, 0xFF & ~jopt.DEAD4, 0):
        _same_stable(P.restrict_cells(t, tc, keep), JP.restrict_cells(j, jc, keep))
    _same_stable(P.set_cell_on(t, 5, 7), JP.set_cell_on(j, 5, 7))
    _same_stable(P.set_cell_off(t, 63, 0), JP.set_cell_off(j, 63, 0))
    assert (P.get_options(t, 3, 9).numpy() == np.asarray(JP.get_options(j, 3, 9))).all()
    assert (P.perturbed_unknowns(t).numpy() == np.asarray(JP.perturbed_unknowns(j))).all()


def test_lattice_ops(instances, rng):
    j, t = instances
    # b: the same boards propagated, and shuffled against a
    jr, tr_ = JP.propagate(j).stable, P.propagate(t).stable
    perm = rng.permutation(8)
    jb_ = JP.Stable(*(x[perm] for x in jr))
    tb_ = P.Stable(*(x[torch.from_numpy(perm)] for x in tr_))
    _same_stable(P.join(t, tb_), JP.join(j, jb_))
    _same_stable(P.graft(t, tb_), JP.graft(j, jb_))
    _same_stable(P.clear_unmodified(tr_), JP.clear_unmodified(jr))
    assert (P.differences(t, tb_).numpy() == np.asarray(JP.differences(j, jb_))).all()
    for x_t, y_t, x_j, y_j in ((t, tb_, j, jb_), (t, t, j, j), (tr_, t, jr, j), (t, tr_, j, jr)):
        assert (P.equal(x_t, y_t).numpy() == np.asarray(JP.equal(x_j, y_j))).all()
        assert (P.compatible_with(x_t, y_t).numpy()
                == np.asarray(JP.compatible_with(x_j, y_j))).all()
    desired = jb.from_dense(jnp.asarray(random_dense(rng, p=0.2)))
    got = P.compatible_with_state(tr_, convert.board_from_packed(desired, device="cpu"))
    assert (got.numpy() == np.asarray(JP.compatible_with_state(jr, desired))).all()


def test_vulnerable_and_lookahead(instances):
    j, t = instances
    jr, tr_ = JP.propagate(j).stable, P.propagate(t).stable
    assert (P.vulnerable(tr_).numpy() == np.asarray(JP.vulnerable(jr))).all()
    cand = P.vulnerable(tr_) & tr_.unknown
    cell = P._first_cell_mask(cand)
    assert (cell.numpy() == np.asarray(JP._first_cell_mask(jnp.asarray(cand.numpy())))).all()
    assert cell.any() and not P._first_cell_mask(torch.zeros_like(cand)).any()
    _same_result(P.test_cells(tr_, cell), JP.test_cells(jr, jnp.asarray(cell.numpy())))


def test_propagate_and_test(rng):
    j, t = _pair(*(np.concatenate(x) for x in zip(_blocks(rng, 3, 0.5), _noisy(rng, 1))))
    _same_result(P.propagate_and_test(t, max_cells=4), JP.propagate_and_test(j, max_cells=4))


def test_to_rle(instances):
    j, t = instances
    one_t = P.Stable(*(x[0] for x in t))
    one_j = JP.Stable(*(x[0] for x in j))
    assert P.to_rle(one_t) == JP.to_rle(one_j)
    assert P.to_rle_with_header(one_t) == JP.to_rle_with_header(one_j)


def test_make_matches_jax(rng):
    d_state = random_dense(rng, p=0.2)
    d_unknown = random_dense(rng, p=0.3)
    packed = jb.from_dense(jnp.asarray(d_state))
    _same_stable(P.make(state=convert.board_from_packed(packed, device="cpu"),
                        unknown=torch.from_numpy(d_unknown)),
                 JP.make(state=packed, unknown=jnp.asarray(d_unknown)))
    _same_stable(P.make(batch=(2,), device="cpu"), JP.make(batch=(2,)))


def test_dense_propagate_matches_bitplane(rng):
    """As tests/test_bitplane.py holds the JAX package's two paths: equal
    consistent flags, equal planes on consistent boards."""
    state, unknown, _ = _blocks(rng, 6)
    st = P.make(state=torch.from_numpy(state), unknown=torch.from_numpy(unknown))
    d = P.propagate(st)
    b = BP.propagate(BP.from_dense_stable(st))
    assert torch.equal(d.consistent, b.consistent) and d.consistent.any()
    back = BP.to_dense_stable(b.stable)
    ok = d.consistent
    for name in ("state", "unknown", "ruled"):
        assert torch.equal(getattr(back, name)[ok], getattr(d.stable, name)[ok])


def test_dense_propagate_on_device_of_input(rng):
    """The fixpoint follows its input's device and never mutates it."""
    j, t = _pair(*_blocks(rng, 2))
    before = [x.clone() for x in t]
    res = P.propagate(t)
    assert res.stable.state.device == t.state.device
    assert all(torch.equal(a, b) for a, b in zip(before, t))
    _same_result(res, JP.propagate(j))
