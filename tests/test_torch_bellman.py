"""The weld / dense-stable slice as a whole: the port's Bellman pipeline
(``lifeapi_tpu_torch.examples.bellman_pipeline.run`` on the CPU) against
the JAX package's, stage by stage (examples/bellman_pipeline.py): the
catalyst search's hits and chosen offset, the stripped stator, the
reaction-constrained problem bit for bit, the host DFS's background, and
the batched beam over every recovering placement (found, best_pop and the
boards, against the JAX jnp beam runner on the same problems).  Every
background found must recover.  The JAX host DFS runs once."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu import search as JSR
from lifeapi_tpu import weld as JW
from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.core.step import step_n as jstep_n
from lifeapi_tpu.stable import complete as JC
from lifeapi_tpu.stable import host as JHO
from lifeapi_tpu.stable import propagate as JP
from lifeapi_tpu.symmetry import transforms as jtr
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.examples import bellman_pipeline as BPL
from lifeapi_tpu_torch.examples import life_step_dense
from lifeapi_tpu_torch.stable import complete as C
from torch_threads import one_torch_thread  # noqa: F401


def _jbuild(pat, pre=0, dx=0, dy=0):
    b = jtr.transform(jb.move(jrle.parse(pat), pre, pre), jtr.SymmetryTransform.Rotate270)
    return jb.move(b, 24 + dx, 24 + dy)


@pytest.fixture(scope="module")
def port():
    return BPL.run("cpu")


@pytest.fixture(scope="module")
def jax_search():
    glider = jb.move(jrle.parse(BPL.GLIDER), 8, 8)
    eater0 = _jbuild(BPL.EATER)
    offsets = JSR.candidate_offsets(glider, eater0)
    res = JSR.catalyst_search(glider, eater0, offsets, BPL.HORIZON)
    hits = np.asarray(JSR.successful_catalysts(res))
    return glider, np.asarray(offsets), hits


def test_catalyst_search_stage(port, jax_search):
    _, offsets, hits = jax_search
    assert port["candidates"] == len(offsets) == 4025
    assert port["selected"] == [tuple(int(v) for v in o) for o in offsets[hits]]
    assert port["hits"] == int(hits.sum()) == 15
    assert port["offset"] == tuple(int(v) for v in offsets[hits.argmax()]) == (0, 4)


def test_weld_problem_and_dfs_stage(port, jax_search):
    glider = jax_search[0]
    dx, dy = port["offset"]
    catalyst = _jbuild(BPL.EATER, dx=dx, dy=dy)
    w = JW.from_required(catalyst, _jbuild(BPL.EATER_REQ, -1, dx, dy))
    for p, q in zip(convert.weld_to_jax(port["weld"]), w):
        assert (p == np.asarray(q)).all()
    assert port["stripped"] == int(jb.population(catalyst & ~w.state)) == 4
    stab = JW.to_stable_with_history(w, glider, BPL.HORIZON)
    stab = JP.set_off(stab, jb.to_dense(~jb.big_zoi(catalyst) & ~w.state))
    for name in ("state", "unknown", "ruled"):
        assert (getattr(port["problem"], name).numpy() == np.asarray(getattr(stab, name))).all()
    # the JAX package's host DFS, once, on its own problem
    result, best = JC.complete_stable(
        JHO.HostStable(*(np.asarray(x) for x in stab)), timeout=20.0, minimise=True)
    assert result.name == port["dfs_result"].name == "COMPLETED"
    assert (B.to_dense(port["background"]).numpy() == best).all()
    assert port["background_pop"] == int(best.sum()) == 7 and port["verified"]
    background = jb.from_dense(jnp.asarray(best))
    assert bool(jb.equal(jstep_n(background | glider, BPL.HORIZON), background))


def test_batched_stage(port):
    """The port's batched problems equal its per-placement ones (the first
    is held against JAX above); the batched beam equals the JAX jnp runner
    on the same problems; every background found recovers."""
    for k in (0, 7, 14):
        dx, dy = port["selected"][k]
        one = BPL.reaction_problems(port["glider"], dx, dy)[2]
        assert all(torch.equal(getattr(one, n), getattr(port["problems"], n)[k])
                   for n in one._fields)
    jst = JP.Stable(*(jnp.asarray(x.numpy()) for x in port["problems"]))
    want = JC.complete_stable_beam(jst, frontier=4, iters=24, minimise=False, dense=False,
                                   fused=False)
    got = convert.beam_result_to_numpy(port["beam"])
    assert (got["found"] == np.asarray(want.found)).all()
    assert (got["best_pop"] == np.asarray(want.best_pop)).all()
    assert (got["best"] == np.asarray(want.best)).all()
    assert port["batched_found"] == port["batched_verified"] == 15
    bgs = B.to_dense(port["beam"].best).numpy()
    g = bgs | B.to_dense(port["glider"]).numpy()
    for _ in range(BPL.HORIZON):
        g = life_step_dense(g)
    assert (g == bgs).all() and (life_step_dense(bgs) == bgs).all()


def test_stages_timed_and_cpu_only(port):
    assert set(port["stages"]) >= {"catalyst search", "host DFS completion", "batched beam"}
    assert port["background"].device.type == "cpu"
    assert isinstance(port["dfs_result"], C.CompletionResult)
