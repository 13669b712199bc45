"""The port's three-state (ternary) bit-plane steps against
:mod:`lifeapi_tpu.stable.bitplane`.

Every output is a bit plane, so every comparison is exact: random planes,
the exhaustive input grids of ``tests/test_ternary_refined.py`` packed
into boards, and a propagated eater background.  ``step_ternary_packed``
is also held to the port's dense ``stable/ternary.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.stable import bitplane as JBP
from lifeapi_tpu.stable import nibble as jnb
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.stable import bitplane as BP
from lifeapi_tpu_torch.stable import nibble as nb
from lifeapi_tpu_torch.stable import ternary as TT
from torch_threads import one_torch_thread  # noqa: F401

N = 64
CLS_KON_T, CLS_KON_F, CLS_KOFF_T, CLS_KOFF_F, CLS_TU, CLS_FU = range(6)


def _same(jax_out, torch_out):
    """Exact equality of JAX packed planes (or tuples of them) and the
    port's boards."""
    if isinstance(jax_out, (tuple, list)):
        assert len(jax_out) == len(torch_out)
        for a, b in zip(jax_out, torch_out):
            _same(a, b)
        return
    a = np.asarray(jax_out)
    b = convert.board_to_packed(torch_out)
    assert a.shape == b.shape
    assert (a == b).all()


def _planes(rng, n, batch=(3,), p=None):
    """n packed planes, uniform words or cells ON with probability p, as
    (jax tuple, port tuple)."""
    if p is None:
        words = rng.integers(0, 2**32, size=(n, *batch, 64, 2), dtype=np.uint32)
    else:
        words = np.asarray(jb.from_dense(jnp.asarray(rng.random((n, *batch, N, N)) < p)))
    return (tuple(jnp.asarray(w) for w in words),
            tuple(convert.board_from_packed(w, device="cpu") for w in words))


def _random_stable(rng, batch=(3,)):
    """A random BitStable (unknown disjoint from state) and current
    planes over it: (jax stable, port stable, jax (state, unknown,
    tracking), port (...))."""
    (js, ju, *jr), (ts, tu, *tr) = _planes(rng, 10, batch, p=0.3)
    jst = JBP.BitStable(js, ju & ~js, tuple(jr))
    tst = BP.BitStable(ts, tu & ~ts, tuple(tr))
    (jcs, jcu, jtr), (tcs, tcu, ttr) = _planes(rng, 3, batch, p=0.3)
    return jst, tst, (jcs, jcu & ~jcs, jtr), (tcs, tcu & ~tcs, ttr)


def _eater_stable(hide_cells=((22, 20), (23, 20))):
    """The propagated eater background with hidden cells, unbatched, as
    (jax, port)."""
    eater = jb.move(jrle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = jb.from_cells(list(hide_cells))
    bst = JBP.make(state=eater & ~hide, unknown=hide)
    res = JBP.propagate(JBP.BitStable(bst.state[None], bst.unknown[None],
                                      tuple(r[None] for r in bst.ruled)))
    assert bool(res.consistent[0])
    jst = JBP.BitStable(res.stable.state[0], res.stable.unknown[0],
                        tuple(r[0] for r in res.stable.ruled))
    return jst, convert.bitstable_from_jax(jst, device="cpu")


# ---------------------------------------------------------------------------
# The seven functions on random planes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("naive", [False, True])
def test_step_ternary_packed_random(rng, naive):
    (js, ju), (ts, tu) = _planes(rng, 2, p=0.35)
    _same(JBP.step_ternary_packed(js, ju & ~js, naive=naive),
          BP.step_ternary_packed(ts, tu & ~ts, naive=naive))


def test_refined_step_circuit_random(rng):
    (jon, junk, *jr), (ton, tunk, *tr) = _planes(rng, 10)
    counts = rng.integers(0, 9, size=(3, 3, N, N))
    counts[2] = np.minimum(counts[2], 8 - counts[1])  # a_stab + u_stab <= 8
    jn = [jnb.encode(jnp.asarray(c)) for c in counts]
    tn = [nb.encode(torch.from_numpy(c)) for c in counts]
    _same(JBP.refined_step_circuit(jon, junk & ~jon, tuple(jr), *jn),
          BP.refined_step_circuit(ton, tunk & ~ton, tuple(tr), *tn))


def test_step_ternary_refined_random(rng):
    jst, tst, (jcs, jcu, _), (tcs, tcu, _) = _random_stable(rng)
    _same(JBP.step_ternary_refined(jcs, jcu, jst),
          BP.step_ternary_refined(tcs, tcu, tst))


def test_refined_step_tracked_circuit_random(rng):
    (jon, jt, jf, jtr, *jr), (ton, tt, tf, ttr, *tr) = _planes(rng, 12)
    counts = rng.integers(0, 9, size=(5, 3, N, N))  # a_cur, tn, f, a_stab, u_stab
    counts[4] = np.minimum(counts[4], 8 - counts[3])
    counts[1] = np.minimum(counts[1], counts[4])
    jn = [jnb.encode(jnp.asarray(c)) for c in counts]
    tn = [nb.encode(torch.from_numpy(c)) for c in counts]
    jf, tf = jf & ~jt, tf & ~tt
    _same(JBP.refined_step_tracked_circuit(jon & ~(jt | jf), jt, jf, jtr, tuple(jr), *jn),
          BP.refined_step_tracked_circuit(ton & ~(tt | tf), tt, tf, ttr, tuple(tr), *tn))


def test_initial_tracking_random(rng):
    jst, tst, (jcs, jcu, _), (tcs, tcu, _) = _random_stable(rng)
    _same(JBP.initial_tracking(jcs, jcu, jst), BP.initial_tracking(tcs, tcu, tst))


def test_step_ternary_tracked_random(rng):
    jst, tst, (jcs, jcu, jtr), (tcs, tcu, ttr) = _random_stable(rng)
    _same(JBP.step_ternary_tracked(jcs, jcu, jtr, jst),
          BP.step_ternary_tracked(tcs, tcu, ttr, tst))
    # and four steps from the initial tracking
    jtr = JBP.initial_tracking(jcs, jcu, jst)
    ttr = BP.initial_tracking(tcs, tcu, tst)
    for _ in range(4):
        jcs, jcu, jtr = JBP.step_ternary_tracked(jcs, jcu, jtr, jst)
        tcs, tcu, ttr = BP.step_ternary_tracked(tcs, tcu, ttr, tst)
        _same((jcs, jcu, jtr), (tcs, tcu, ttr))


def test_keep_stable_random(rng):
    jst, tst, (jcs, jcu, _), (tcs, tcu, _) = _random_stable(rng)
    _same(JBP.keep_stable(jcs, jcu, jst), BP.keep_stable(tcs, tcu, tst))


# ---------------------------------------------------------------------------
# The circuits on the exhaustive input grids, packed into boards
# ---------------------------------------------------------------------------


def _pack_cases(arr):
    """Rows of case columns -> [boards, 64, 64] grids per column, the last
    case repeated to fill the last board."""
    n = len(arr)
    nboards = -(-n // (N * N))
    arr = np.concatenate([arr, np.repeat(arr[-1:], nboards * N * N - n, axis=0)])
    return [arr[:, i].reshape(nboards, N, N) for i in range(arr.shape[1])]


def _both_boards(mask):
    return jb.from_dense(jnp.asarray(mask)), tb.from_dense(torch.from_numpy(mask))


def _both_nibbles(values):
    return jnb.encode(jnp.asarray(values)), nb.encode(torch.from_numpy(values))


def test_refined_step_circuit_exhaustive():
    """Every (ruled mask, center, a_cur, a_stab, u_stab) combination of
    ``test_refined_circuit_exhaustive``: 311,040 cells on 76 boards."""
    cases = [(rm, cur, a_cur, a_stab, u_stab)
             for rm in range(256) for cur in range(3)
             for a_stab in range(9) for u_stab in range(9 - a_stab) for a_cur in range(9)]
    rm, cur, a_cur, a_stab, u_stab = _pack_cases(np.array(cases, np.int32))
    (jon, ton), (junk, tunk) = _both_boards(cur == 1), _both_boards(cur == 2)
    ruled = [_both_boards((rm >> i) & 1 == 1) for i in range(8)]
    nibs = [_both_nibbles(v) for v in (a_cur, a_stab, u_stab)]
    _same(JBP.refined_step_circuit(jon, junk, tuple(r[0] for r in ruled), *(n[0] for n in nibs)),
          BP.refined_step_circuit(ton, tunk, tuple(r[1] for r in ruled), *(n[1] for n in nibs)))


def test_refined_step_tracked_circuit_exhaustive():
    """Every feasible (class, a_cur, tn, f, a_stab, u_stab) count
    combination x the structured ruled-mask sample of
    ``test_tracked_circuit_exhaustive_vs_enumerative_spec``."""
    rng = np.random.default_rng(0)
    masks = sorted({0, 0xFF} | {1 << i for i in range(8)}
                   | {0xFF ^ (1 << i) for i in range(8)}
                   | {int(x) for x in rng.integers(0, 256, 24)})
    counts = np.array([(a_cur, tn, f, a_stab, u_stab)
                       for a_stab in range(9) for u_stab in range(9 - a_stab)
                       for tn in range(u_stab + 1) for a_cur in range(9 - tn)
                       for f in range(9 - tn - a_cur)], np.int32)
    blocks = []
    for rm in masks:
        for cls in range(6):
            block = np.empty((len(counts), 7), np.int32)
            block[:, 0], block[:, 1], block[:, 2:] = rm, cls, counts
            blocks.append(block)
    rm, cls, a_cur, tn, f, a_stab, u_stab = _pack_cases(np.concatenate(blocks))
    planes = [_both_boards(m) for m in (
        (cls == CLS_KON_T) | (cls == CLS_KON_F), cls == CLS_TU, cls == CLS_FU,
        (cls == CLS_KON_T) | (cls == CLS_KOFF_T) | (cls == CLS_TU))]
    ruled = [_both_boards((rm >> i) & 1 == 1) for i in range(8)]
    nibs = [_both_nibbles(v) for v in (a_cur, tn, f, a_stab, u_stab)]
    _same(JBP.refined_step_tracked_circuit(*(p[0] for p in planes), tuple(r[0] for r in ruled),
                                           *(n[0] for n in nibs)),
          BP.refined_step_tracked_circuit(*(p[1] for p in planes), tuple(r[1] for r in ruled),
                                          *(n[1] for n in nibs)))


# ---------------------------------------------------------------------------
# Against the port's dense ternary step, and on the eater background
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("naive", [False, True])
def test_step_ternary_packed_matches_dense(rng, naive):
    state = torch.from_numpy(rng.random((4, N, N)) < 0.3)
    unknown = torch.from_numpy(rng.random((4, N, N)) < 0.2) & ~state
    ns, nu = BP.step_ternary_packed(tb.from_dense(state), tb.from_dense(unknown), naive=naive)
    ds, du = TT.step_ternary(state, unknown, naive=naive)
    assert torch.equal(tb.to_dense(ns), ds)
    assert torch.equal(tb.to_dense(nu), du)


def test_eater_background_steps_match():
    """The refined and tracked steps and ``keep_stable`` on the propagated
    eater with an active blinker (``test_refined_step_sound_on_completions``'
    instance), and the port's keep covering the quiescent background."""
    jst, tst = _eater_stable()
    jblink = jb.from_cells([(27, 26), (27, 27), (27, 28)])
    tblink = convert.board_from_packed(jblink, device="cpu")
    jcur, tcur = jst.state | jblink, tst.state | tblink
    _same(JBP.step_ternary_refined(jcur, jst.unknown, jst),
          BP.step_ternary_refined(tcur, tst.unknown, tst))
    jtr = JBP.initial_tracking(jcur, jst.unknown, jst)
    ttr = BP.initial_tracking(tcur, tst.unknown, tst)
    _same(jtr, ttr)
    js, ju, ts, tu = jcur, jst.unknown, tcur, tst.unknown
    for _ in range(6):
        js, ju, jtr = JBP.step_ternary_tracked(js, ju, jtr, jst)
        ts, tu, ttr = BP.step_ternary_tracked(ts, tu, ttr, tst)
        _same((js, ju, jtr), (ts, tu, ttr))
    keep = BP.keep_stable(tst.state, tst.unknown, tst)
    _same(JBP.keep_stable(jst.state, jst.unknown, jst), keep)
    region = tb.zoi(tst.state | tst.unknown)
    assert bool(tb.is_empty(region & ~keep))
