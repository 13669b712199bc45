"""UnweldableMask with escalation, the port (``lifeapi_tpu_torch.weld``)
against :mod:`lifeapi_tpu.weld`: the deep tier-2 beam (F=8) and the strict
tier-3 host DFS with an unlimited wall budget.  Mask and stats bit-exact.

The window is the part of examples/unweldable_prefilter.py's 5x5 window
that holds one placement of each tier.  Tier 2's depth, max(512, 4 x
beam_iters) rounds in both packages, is cut to 64 in both: a round costs
the same for 2 problems as for 12, and 512 rounds take about 35 s here;
(3, 5) completes within 64 rounds and (3, 4) stays open at 512.  The
tier-3 budget is raised so that the DFS of (3, 4), about 0.1 s, ends
within stage A whatever the load."""

import numpy as np
import jax.numpy as jnp

from lifeapi_tpu import weld as JW
from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.stable import complete as JC
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch import weld as W
from lifeapi_tpu_torch.stable import complete as C
from torch_threads import one_torch_thread  # noqa: F401

DEEP_ROUNDS = 64


def _shallow(beam):
    return lambda *a, iters, **k: beam(*a, iters=min(iters, DEEP_ROUNDS), **k)


def test_unweldable_beam_escalated(monkeypatch):
    """(3, 3) is proved by tier 1, (3, 5) completed by tier 2 and (3, 4)
    completed by the tier-3 DFS."""
    monkeypatch.setattr(JC, "complete_stable_beam", _shallow(JC.complete_stable_beam))
    monkeypatch.setattr(C, "complete_stable_beam", _shallow(C.complete_stable_beam))
    window = np.zeros((64, 64), bool)
    window[3, 3:6] = True
    good = jb.from_dense(jnp.asarray(~window))
    ja = JW.from_required(jb.move(jrle.parse("2b2o$bobo$bo$2o!"), 20, 20),
                          jb.move(jrle.parse("2b2o$b3o$b4o$5o$4o$4o!"), 19, 19))
    jb_ = JW.LifeWeld.from_state(jb.move(jrle.parse("2o$2o!"), 20, 20))
    kw = dict(engine="beam", batch_size=32, beam_iters=24, escalate=True,
              escalate_dfs_timeout=30.0, escalate_dfs_wall_budget=None, return_stats=True)
    want_mask, want = JW.unweldable_mask(ja, jb_, starting_good=good, **kw)
    got_mask, got = W.unweldable_mask(convert.weld_from_jax(ja, device="cpu"), convert.weld_from_jax(jb_, device="cpu"),
                                      starting_good=convert.board_from_packed(good, device="cpu"), **kw)
    assert (convert.board_to_packed(got_mask) == np.asarray(want_mask)).all()
    assert got == want
    assert (got["tier1_residue"], got["tier2_completed"], got["tier3_instances"],
            got["tier3_stage_a_determined"]) == (2, 1, 1, 1)
    assert convert.board_to_packed(got_mask).any()
