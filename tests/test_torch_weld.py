"""The port's LifeWeld (``lifeapi_tpu_torch.weld``) against
:mod:`lifeapi_tpu.weld`, on the reference LifeWeldTest fixtures: the weld
ops, the reaction replay, interaction offsets on every route, the batched
placement builder and UnweldableMask with both engines and every tier.
Bit-exact; the one intended difference is ``tier1_residue`` with
``escalate=False``, which the JAX package reports as 0 (a known fault of
the reference) and the port counts."""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu import weld as JW
from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.symmetry import transforms as jtr
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch import weld as W
from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.symmetry.transforms import SymmetryTransform as T
from torch_threads import one_torch_thread  # noqa: F401

REQUIRED_PAIRS = [
    ("2b2o$bobo$bo$2o!", "2b2o$b3o$b4o$5o$4o$4o!"),
    ("2o$o2bob2o$b3obobo$5bobo$b5ob3o$bo4bo3bo$4bobo2b2o$4b2o!",
     "4o$5o2bo$4o$5o4bo$b5ob5o$b12o$b12o$b12o$4b9o$4b4o!"),
    ("4b2ob2o$3bobobobo$b3o3bobo$o4bobob3o$b3ob2obo3bo$3bo4bo2b2o$5b3o$4b2o!",
     "4b2o$3b2o2bo2b2o$b4o6bo$6obob5o$15o$15o$b14o$3b12o$4b6o$4b4o!"),
]
BLOCK = "2o$2o!"


def _centered(s, dx=0, dy=0):
    return jb.move(jrle.parse(s), 20 + dx, 20 + dy)


def _weld_pair(i=0):
    s, req = REQUIRED_PAIRS[i]
    j = JW.from_required(_centered(s), _centered(req, -1, -1))
    return j, convert.weld_from_jax(j, device="cpu")


def _block_pair():
    j = JW.LifeWeld.from_state(_centered(BLOCK))
    return j, convert.weld_from_jax(j, device="cpu")


def _same_weld(t, j):
    for p, q in zip(convert.weld_to_jax(t), j):
        assert (p == np.asarray(q)).all()


def _same_board(t, j):
    assert (convert.board_to_packed(t) == np.asarray(j)).all()


def _same_stable(t, j):
    for name in ("state", "unknown", "ruled"):
        assert (getattr(t, name).numpy() == np.asarray(getattr(j, name))).all()


@pytest.mark.parametrize("i", range(3))
def test_from_required_and_step(i):
    s, req = REQUIRED_PAIRS[i]
    j, t = _weld_pair(i)
    got = W.from_required(convert.board_from_packed(_centered(s), device="cpu"),
                          convert.board_from_packed(_centered(req, -1, -1), device="cpu"))
    _same_weld(got, j)
    assert bool(W.step(t).equal(t))
    _same_weld(W.step(t), JW.step(j))
    _same_weld(W.step_n(t, 5), JW.step_n(j, 5))
    _same_board(t.all_frozen(), j.all_frozen())
    tt, jt = W.to_target(t), JW.to_target(j)
    _same_board(tt.wanted, jt.wanted)
    _same_board(tt.unwanted, jt.unwanted)
    for a, b in zip(W.interaction_counts(t), JW.interaction_counts(j)):
        _same_board(a, b)
    assert W.to_bellman_rle(t) == JW.to_bellman_rle(j)
    glider = jb.move(jrle.parse("bob$2bo$3o!"), 5, 5)
    assert (W.to_bellman_rle(t, convert.board_from_packed(glider, device="cpu"))
            == JW.to_bellman_rle(j, glider))
    for p, q in zip(convert.history_to_jax(W.to_history(t)), JW.to_history(j)):
        assert (p == np.asarray(q)).all()


def test_weld_ops():
    j, t = _weld_pair(1)
    jbk, tbk = _block_pair()
    _same_weld(t | tbk, j | jbk)
    _same_weld(t.moved(-3, 7), j.moved(-3, 7))
    _same_weld(t.transformed(T.Rotate90), j.transformed(jtr.SymmetryTransform.Rotate90))
    assert bool(t.equal(t)) and not bool(t.equal(t.moved(1, 0)))
    batch = t.moved(torch.tensor([0, 1, -5]), torch.tensor([0, 2, 9]))
    for k, (dx, dy) in enumerate(((0, 0), (1, 2), (-5, 9))):
        _same_weld(W.LifeWeld(*(p[k] for p in batch)), j.moved(dx, dy))
    glider = jb.move(jrle.parse("bob$2bo$3o!"), 30, 30)
    jg = JW.LifeWeld.from_state(glider)
    _same_weld(W.step_n(convert.weld_from_jax(jg, device="cpu"), 4), JW.step_n(jg, 4))
    plain = torch.from_numpy(np.random.default_rng(0).integers(-2**63, 2**63, 64))
    from lifeapi_tpu_torch.core import step as S
    assert torch.equal(W.step(W.LifeWeld.from_state(plain)).state, S.step(plain))


@pytest.mark.parametrize("i", range(3))
def test_to_stable(i):
    j, t = _weld_pair(i)
    _same_stable(W.to_stable(t), JW.to_stable(j))


def _bellman_weld(dy):
    def build(pat, pre=0):
        return jb.move(jtr.transform(jb.move(jrle.parse(pat), pre, pre),
                                     jtr.SymmetryTransform.Rotate270), 24, 24 + dy)

    catalyst = build("2b2o$bobo$bo$2o!")
    j = JW.from_required(catalyst, build("2b2o$b3o$b4o$5o$4o$4o!", -1))
    return j, convert.weld_from_jax(j, device="cpu")


@pytest.mark.parametrize("duration", [8, 64])
def test_to_stable_with_history(duration):
    """The Bellman example's reaction: glider against the eater at (0, 4)."""
    glider = jb.move(jrle.parse("bob$2bo$3o!"), 8, 8)
    j, t = _bellman_weld(4)
    tg = convert.board_from_packed(glider, device="cpu")
    _same_stable(W.to_stable_with_history(t, tg, duration),
                 JW.to_stable_with_history(j, glider, duration))
    mask = jb.from_dense(jnp.asarray(np.indices((64, 64)).sum(0) % 3 != 0))
    _same_stable(W.to_stable_with_history(t, tg, duration, convert.board_from_packed(mask, device="cpu")),
                 JW.to_stable_with_history(j, glider, duration, mask))


@pytest.mark.parametrize("method", [None, "sparse", "ntt_fused"])
def test_interaction_offsets_every_route(method):
    """The JAX package's default route against each of the port's."""
    for (ja, ta), (jb_, tb) in ((_weld_pair(1), _weld_pair(0)), (_block_pair(), _weld_pair(0)),
                                (_block_pair(), _block_pair())):
        _same_board(W.interaction_offsets(ta, tb, method=method),
                    JW.interaction_offsets(ja, jb_))


def test_build_placements_batch():
    (ja, ta), (jb_, tb) = _weld_pair(1), _weld_pair(0)
    xy = np.array([[0, 0], [3, -7], [60, 5], [-20, 23], [12, 12]], np.int32)
    want = JW._build_placements(ja, jb_, jnp.asarray(xy))
    got = W._build_placements(ta, tb, torch.from_numpy(xy).long())
    _same_stable(got, want)
    one = W.to_stable(ta | tb.moved(3, -7))
    assert all(torch.equal(getattr(one, n), getattr(got, n)[1]) for n in one._fields)


def _window(x0, x1, y0, y1):
    w = np.zeros((64, 64), bool)
    w[x0:x1, y0:y1] = True
    return jb.from_dense(jnp.asarray(~w))


def _prefilter(good, **kw):
    """examples/unweldable_prefilter.py's welds; the mask and stats of
    both packages."""
    ja = JW.from_required(jb.move(jrle.parse(REQUIRED_PAIRS[0][0]), 20, 20),
                          jb.move(jrle.parse(REQUIRED_PAIRS[0][1]), 19, 19))
    jb_ = JW.LifeWeld.from_state(jb.move(jrle.parse(BLOCK), 20, 20))
    want = JW.unweldable_mask(ja, jb_, starting_good=good, return_stats=True, **kw)
    got = W.unweldable_mask(convert.weld_from_jax(ja, device="cpu"), convert.weld_from_jax(jb_, device="cpu"),
                            starting_good=convert.board_from_packed(good, device="cpu"),
                            return_stats=True, **kw)
    _same_board(got[0], want[0])
    return got[1], want[1]


def test_unweldable_beam_tier1():
    """The example's 5x5 window, escalation off."""
    got, want = _prefilter(_window(1, 6, 1, 6), engine="beam", batch_size=32, beam_iters=24,
                           escalate=False)
    assert {**got, "tier1_residue": 0} == want
    # 17 placements: 5 proved, none completed, the other 12 undetermined
    assert got["placements"] == 17 and got["tier1_residue"] == 12


def test_unweldable_host_engine():
    """The example's window without its last row: the DFS of (5, 1) alone
    takes about 6 s, the other 12 placements 0.01-0.4 s each, so a 60 s
    budget determines every one of them under any load."""
    got, want = _prefilter(_window(1, 5, 1, 6), engine="host", solve_timeout=60.0)
    assert got == want == {"placements": 12, "host_determined": 12, "host_marked_bad": 5}


def test_tier1_residue_counted_without_escalation():
    """The port's fix of the reference's weld.py:368: ``tier1_residue``
    counts the undetermined placements whether or not ``escalate`` is set;
    the JAX package reports 0 without escalation."""
    _, ta = _weld_pair(0)
    tb = W.LifeWeld.from_state(B.move(convert.board_from_packed(jrle.parse(BLOCK), device="cpu"), 20, 20))
    good = convert.board_from_packed(_window(3, 4, 3, 6), device="cpu")
    _, off = W.unweldable_mask(ta, tb, starting_good=good, engine="beam", beam_iters=24,
                               escalate=False, return_stats=True)
    assert off["tier1_residue"] == 2 and off["tier2_completed"] == 0
    from lifeapi_tpu_torch.stable import complete as C
    sts = W._build_placements(ta, tb, torch.tensor([[3, 3], [3, 4], [3, 5]]))
    res = C.complete_stable_beam(sts, frontier=4, iters=24, minimise=False)
    assert int((~res.found & ~res.proved_inconsistent).sum()) == off["tier1_residue"]


def test_tier3_wall_budget_skips_are_counted_and_warned(monkeypatch):
    """With no wall budget left, tier 3 skips its instance, counts it and
    warns unless stats are returned.  The deep tier-2 beam is cut to 24
    rounds here: the tier-3 instance stays undetermined either way."""
    from lifeapi_tpu_torch.stable import complete as C

    deep = C.complete_stable_beam
    monkeypatch.setattr(C, "complete_stable_beam",
                        lambda *a, iters, **k: deep(*a, iters=min(iters, 24), **k))
    _, ta = _weld_pair(0)
    tb = W.LifeWeld.from_state(B.move(convert.board_from_packed(jrle.parse(BLOCK), device="cpu"), 20, 20))
    good = convert.board_from_packed(_window(3, 4, 3, 6), device="cpu")
    kw = dict(starting_good=good, engine="beam", beam_iters=24, escalate_dfs_wall_budget=0)
    _, stats = W.unweldable_mask(ta, tb, return_stats=True, **kw)
    assert stats["tier3_instances"] == stats["tier3_wall_budget_skipped"] >= 1
    n = stats["tier3_wall_budget_skipped"]
    with pytest.warns(UserWarning, match=f"{n} tier-3 DFS instances skipped"):
        W.unweldable_mask(ta, tb, **kw)


@pytest.mark.parametrize("engine", ["beam", "host"])
def test_unweldable_all_predetermined(engine):
    """Nothing left to test: both engines keep their stats keys."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, want = _prefilter(jb.full(), engine=engine)
    assert got == want


def test_prefilter_example_runs_on_cpu():
    """examples/unweldable_prefilter.py's port on one placement of its
    window, which tier 1 proves unweldable (the full window is the JAX
    example's output: 17 tested, 5 proved, 8 interacting)."""
    from lifeapi_tpu_torch.examples import unweldable_prefilter

    r = unweldable_prefilter.run("cpu", window=((3, 4), (3, 4)))
    assert (r["frozen_cells"], r["tested"], r["proved"], r["interacting"]) == (2, 1, 1, 0)
    assert r["marked"] == [(3, 3)]
