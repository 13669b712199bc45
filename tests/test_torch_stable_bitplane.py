"""The port's still-life bit-plane layer against :mod:`lifeapi_tpu.stable`,
bit for bit: nibble arithmetic, every propagation circuit, the three-pass
propagation and the branch priorities, and the converters.

Inputs are made with numpy from a seed and handed to both packages; every
comparison is exact (tolerance 0).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.stable import bitplane as JBP
from lifeapi_tpu.stable import nibble as jnb
from lifeapi_tpu.stable import propagate as JP
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.stable import bitplane as BP
from lifeapi_tpu_torch.stable import nibble as nb
from lifeapi_tpu_torch.stable import propagate as P
from oracle import random_dense
from torch_threads import one_torch_thread  # noqa: F401

N = 64


def _same(jax_out, torch_out):
    """Exact equality of JAX planes (or tuples/lists of them, or flags)
    and the port's."""
    if isinstance(jax_out, (tuple, list)):
        assert len(jax_out) == len(torch_out)
        for a, b in zip(jax_out, torch_out):
            _same(a, b)
        return
    a = np.asarray(jax_out)
    if a.dtype == np.uint32 and a.shape[-2:] == (64, 2):
        b = convert.board_to_packed(torch_out)
    else:
        b = torch_out.numpy()
    assert a.shape == b.shape
    assert (a == b).all()


def _random_planes(rng, n, batch=(3,)):
    """n random packed planes, as (jax tuple, port tuple)."""
    words = rng.integers(0, 2**32, size=(n, *batch, 64, 2), dtype=np.uint32)
    return (tuple(jnp.asarray(w) for w in words),
            tuple(convert.board_from_packed(w, device="cpu") for w in words))


def _eater_bst(batch=4, ring2=False, hide_cells=((20, 20), (21, 20))):
    eater = jb.move(jrle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = jb.from_cells(list(hide_cells))
    ring = jb.zoi(jb.zoi(eater)) if ring2 else jb.zoi(eater)
    unknown = (ring & ~eater) | hide
    return JBP.make(state=jnp.broadcast_to(eater & ~hide, (batch, 64, 2)),
                    unknown=jnp.broadcast_to(unknown, (batch, 64, 2)))


def _block_bst(rng, batch, p_hide):
    """Partial still lifes made of 2x2 blocks with hidden cells and a 2-ring
    of unknowns (tests/test_stable_pallas.py's instances)."""
    from lifeapi_tpu.stable import host as H

    states, unknowns = [], []
    for _ in range(batch):
        truth = np.zeros((N, N), bool)
        for _ in range(5):
            x, y = rng.integers(4, 56, 2)
            truth[x:x + 2, y:y + 2] = True
        hide = (rng.random((N, N)) < p_hide) & H.zoi(truth)
        states.append(truth & ~hide)
        unknowns.append(hide | (H.zoi(H.zoi(truth)) & ~truth))
    return JBP.make(state=jb.from_dense(jnp.asarray(np.stack(states))),
                    unknown=jb.from_dense(jnp.asarray(np.stack(unknowns))))


def _port(bst):
    return convert.bitstable_from_jax(bst, device="cpu")


def _same_bst(jbst, tbst):
    _same((jbst.state, jbst.unknown, *jbst.ruled),
          (tbst.state, tbst.unknown, *tbst.ruled))


# ---------------------------------------------------------------------------
# Nibble arithmetic, exhaustively over every pair of 4-bit values
# ---------------------------------------------------------------------------


def _all_pairs():
    """Every (x, y) pair of nibble values, 16 times over the 4096 cells."""
    idx = np.arange(N * N).reshape(N, N)
    xs, ys = idx % 16, (idx // 16) % 16
    jx, jy = jnb.encode(jnp.asarray(xs)), jnb.encode(jnp.asarray(ys))
    tx, ty = nb.encode(torch.from_numpy(xs)), nb.encode(torch.from_numpy(ys))
    return (jx, jy), (tx, ty), xs, ys


BINARY = ["add", "sub", "eq", "gt", "maximum", "minimum"]


@pytest.mark.parametrize("op", BINARY)
def test_nibble_binary_ops_all_pairs(op):
    (jx, jy), (tx, ty), _, _ = _all_pairs()
    _same(getattr(jnb, op)(jx, jy), getattr(nb, op)(tx, ty))


@pytest.mark.parametrize("op", ["sub_bit", "add_bit"])
def test_nibble_bit_ops_all_pairs(op):
    (jx, jy), (tx, ty), _, _ = _all_pairs()
    _same(getattr(jnb, op)(jx, jy[0]), getattr(nb, op)(tx, ty[0]))


@pytest.mark.parametrize("op", ["eq_const", "gt_const", "lt_const", "le_const", "ge_const"])
def test_nibble_const_compares_all_values(op):
    (jx, _), (tx, _), xs, _ = _all_pairs()
    for k in range(16):
        got = getattr(nb, op)(tx, k)
        _same(getattr(jnb, op)(jx, k), got)
        expect = {"eq_const": xs == k, "gt_const": xs > k, "lt_const": xs < k,
                  "le_const": xs <= k, "ge_const": xs >= k}[op]
        assert (BP.B.to_dense(got).numpy() == expect).all()


def test_nibble_select_const_width_and_decode():
    (jx, jy), (tx, ty), xs, ys = _all_pairs()
    _same(jnb.select(jy[0], jx, jy), nb.select(ty[0], tx, ty))
    for value in (0, 5, 13):
        _same(jnb.const(jx[0], value, width=5), nb.const(tx[0], value, width=5))
    _same(jnb.add(jx, jy, width=5), nb.add(tx, ty, width=5))
    assert (nb.decode(nb.add(tx, ty, width=5)).numpy() == xs + ys).all()
    assert (nb.decode(tx).numpy() == np.asarray(jnb.decode(jx))).all()
    _same(jnb.from_bit(jx[1]), nb.from_bit(tx[1]))


# ---------------------------------------------------------------------------
# Circuits on random planes
# ---------------------------------------------------------------------------


def test_threshold_and_count_class_helpers(rng):
    jn, tn = _random_planes(rng, 4)
    _same(JBP._gt_thresholds7(jn), BP._gt_thresholds7(tn))
    jp, tp = _random_planes(rng, 8)
    for name in ("_min_possible", "_max_possible", "_poss_counts", "_single_count"):
        _same(getattr(JBP, name)(list(jp)), getattr(BP, name)(list(tp)))
    ja, ta = _random_planes(rng, 10)
    _same(JBP._maximal_ruled_planes(ja[:4], ja[4:8], ja[8], ja[9]),
          BP._maximal_ruled_planes(ta[:4], ta[4:8], ta[8], ta[9]))


def test_sync_update_and_signal_circuits(rng):
    jp, tp = _random_planes(rng, 18)
    js, ju, jr, j9, jm = jp[0], jp[1], jp[2:10], jp[10:14], jp[14:18]
    ts, tu, tr, t9, tm = tp[0], tp[1], tp[2:10], tp[10:14], tp[14:18]
    _same(JBP.sync_circuit(js, ju, jr), BP.sync_circuit(ts, tu, tr))
    _same(JBP.update_circuit(js, ju, jr, j9, jm), BP.update_circuit(ts, tu, tr, t9, tm))
    _same(JBP.update_circuit_interval(js, ju, jr, j9, jm),
          BP.update_circuit_interval(ts, tu, tr, t9, tm))
    _same(JBP.signal_circuit(js, ju, jr, j9, jm), BP.signal_circuit(ts, tu, tr, t9, tm))
    jx, tx = _random_planes(rng, 4)
    _same(JBP.signal_circuit_post(js, ju, jr, j9, jm, jx),
          BP.signal_circuit_post(ts, tu, tr, t9, tm, tx))


def test_simple_and_vulnerable_circuits(rng):
    jp, tp = _random_planes(rng, 18)
    _same(JBP.simple_circuit(jp[0], jp[1], jp[2:6], jp[6:10]),
          BP.simple_circuit(tp[0], tp[1], tp[2:6], tp[6:10]))
    _same(JBP.vulnerable_circuit(jp[0], jp[1], jp[2:10], jp[10:14], jp[14:18]),
          BP.vulnerable_circuit(tp[0], tp[1], tp[2:10], tp[10:14], tp[14:18]))


# ---------------------------------------------------------------------------
# Propagation passes, the fixpoint and the branch priorities
# ---------------------------------------------------------------------------


def _consistent_and_noisy(rng):
    """Block instances plus random noise boards (mostly inconsistent)."""
    jbst = _block_bst(rng, 4, 0.3)
    state = random_dense(rng, p=0.15, batch=(4,))
    unknown = random_dense(rng, p=0.25, batch=(4,)) & ~state
    noisy = JBP.make(state=jb.from_dense(jnp.asarray(state)),
                     unknown=jb.from_dense(jnp.asarray(unknown)))
    cat = lambda a, b: jnp.concatenate([a, b])
    return JBP.BitStable(cat(jbst.state, noisy.state), cat(jbst.unknown, noisy.unknown),
                         tuple(cat(a, b) for a, b in zip(jbst.ruled, noisy.ruled)))


@pytest.mark.parametrize("name", ["synchronise_state_known", "update_options",
                                  "signal_neighbours", "propagate_simple_step"])
def test_single_passes_match(rng, name):
    jbst = _consistent_and_noisy(rng)
    if name != "synchronise_state_known":
        jbst = JBP.synchronise_state_known(jbst).stable
    expect = getattr(JBP, name)(jbst)
    got = getattr(BP, name)(_port(jbst))
    _same_bst(expect.stable, got.stable)
    _same((expect.consistent, expect.changed), (got.consistent, got.changed))


def test_propagate_step_matches_on_consistent_boards(rng):
    jbst = _consistent_and_noisy(rng)
    expect = JBP.propagate_step(jbst)
    got = BP.propagate_step(_port(jbst))
    _same(expect.consistent, got.consistent)
    ok = np.asarray(expect.consistent)
    assert ok.any() and not ok.all()
    for a, b in zip((expect.stable.state, expect.stable.unknown, *expect.stable.ruled),
                    (got.stable.state, got.stable.unknown, *got.stable.ruled)):
        assert (np.asarray(a)[ok] == convert.board_to_packed(b)[ok]).all()
    assert (np.asarray(expect.changed)[ok] == got.changed.numpy()[ok]).all()


@pytest.mark.parametrize("case", ["eater_1ring", "eater_2ring", "blocks"])
def test_propagate_fixpoint_matches(rng, case):
    jbst = {"eater_1ring": lambda: _eater_bst(),
            "eater_2ring": lambda: _eater_bst(ring2=True, hide_cells=()),
            "blocks": lambda: _block_bst(rng, 6, 0.3)}[case]()
    expect = JBP.propagate(jbst)
    got = BP.propagate(_port(jbst))
    _same_bst(expect.stable, got.stable)
    _same((expect.consistent, expect.changed), (got.consistent, got.changed))
    levels = BP.branch_levels(got.stable)
    _same(JBP.branch_levels(expect.stable), levels)
    _same(JBP.vulnerable(expect.stable), BP.vulnerable(got.stable))
    if case == "eater_2ring":
        # the solver bench's fixpoint: 49 unknown cells, 40 after it
        assert (BP.B.population(_port(jbst).unknown) == 49).all()
        assert (BP.B.population(got.stable.unknown) == 40).all()


def test_propagate_detects_contradiction():
    lone = jb.from_cells([(30, 30)])
    jbst = JBP.make(state=jnp.broadcast_to(lone, (2, 64, 2)),
                    unknown=jnp.zeros((2, 64, 2), jnp.uint32))
    got = BP.propagate(_port(jbst))
    assert not got.consistent.any()
    _same(JBP.propagate(jbst).consistent, got.consistent)


def test_set_on_set_off(rng):
    jbst = _block_bst(rng, 3, 0.3)
    jm, tm = _random_planes(rng, 1)
    _same_bst(JBP.set_on(jbst, jm[0]), BP.set_on(_port(jbst), tm[0]))
    _same_bst(JBP.set_off(jbst, jm[0]), BP.set_off(_port(jbst), tm[0]))


# ---------------------------------------------------------------------------
# Converters and dense forms
# ---------------------------------------------------------------------------


def test_bitstable_converters_roundtrip(rng):
    jp, _ = _random_planes(rng, 10)
    jbst = JBP.BitStable(jp[0], jp[1], tuple(jp[2:]))
    tbst = convert.bitstable_from_jax(jbst, device="cpu")
    assert tbst.state.dtype == torch.int64 and tbst.state.shape == (3, 64)
    back = convert.bitstable_to_jax(tbst)
    for a, b in zip((jbst.state, jbst.unknown, *jbst.ruled), (back[0], back[1], *back[2])):
        assert (np.asarray(a) == b).all()
    planes = BP.to_planes(tbst)
    assert planes.shape == (3, 10, 64)
    _same_bst(jbst, BP.from_planes(planes))


def test_dense_stable_converters(rng):
    jbst = JBP.propagate(_block_bst(rng, 3, 0.3)).stable
    jdense = JBP.to_dense_stable(jbst)
    tdense = convert.stable_from_jax(jdense, device="cpu")
    assert tdense.ruled.dtype == torch.uint8
    for a, b in zip(jdense, tdense):
        assert (np.asarray(a) == b.numpy()).all()
    _same_bst(jbst, BP.from_dense_stable(tdense))
    for a, b in zip(jdense, BP.to_dense_stable(_port(jbst))):
        assert (np.asarray(a) == b.numpy()).all()
    st = random_dense(rng, p=0.2, batch=(2,))
    un = random_dense(rng, p=0.3, batch=(2,))
    jmade = JP.make(state=jnp.asarray(st), unknown=jnp.asarray(un))
    tmade = P.make(state=torch.from_numpy(st), unknown=torch.from_numpy(un))
    for a, b in zip(jmade, tmade):
        assert (np.asarray(a) == b.numpy()).all()
    packed = jb.from_dense(jnp.asarray(st))
    _same_bst(JBP.make(state=packed), BP.make(state=convert.board_from_packed(packed, device="cpu")))
