"""The seven sharded runners of ``lifeapi_tpu_torch.parallel.elite`` on
small fixed inputs, for comparing one mesh with another: the 2-rank gloo
test runs :func:`run_all` in each spawned rank and holds every rank's
results to a world-size-1 run of the same function.  Imports torch and the
port only, so a spawned rank does not load jax."""

import numpy as np
import torch

from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.core import rle
from lifeapi_tpu_torch.mpc import CostWeights, MPCProblem
from lifeapi_tpu_torch.parallel import elite
from lifeapi_tpu_torch.stable import bitplane as BP
from lifeapi_tpu_torch.symmetry import transforms as tr
from lifeapi_tpu_torch.target import LifeTarget

EATER_RLE = "2b2o$bobo$bo$2o!"
GLIDER_RLE = "bob$2bo$3o!"
# float32 costs and controls: the multichip dryrun's tolerance
COST_TOL = dict(rtol=1e-4, atol=1e-5)


def mpc_problem(horizon=3):
    target = LifeTarget.from_state(B.move(rle.parse("2o$2o!", device="cpu"), 31, 31))
    mask = torch.zeros(64, 64, dtype=torch.bool)
    mask[28:36, 28:36] = True
    return MPCProblem(initial=B.empty(device="cpu"), target=target, horizon=horizon, control_mask=mask,
                      weights=CostWeights(target=1.0, control=0.01))


def eater_instance():
    eater = B.move(rle.parse(EATER_RLE, device="cpu"), 20, 20)
    hide = B.from_cells([(20, 20), (21, 20)], device="cpu")
    return eater & ~hide, (B.zoi(eater) & ~eater) | hide


def run_all(mesh):
    """Every runner once on ``mesh``; returns name -> tuple of numpy values."""
    def np_(*xs):
        return tuple(np.asarray(x.cpu()) if isinstance(x, torch.Tensor) else x for x in xs)

    rng = np.random.default_rng(11)
    out = {}
    boards = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, size=(8, 64), dtype=np.int64))
    out["rollout"] = np_(*elite.sharded_rollout(boards, 6, mesh))

    glider = B.move(rle.parse(GLIDER_RLE, device="cpu"), 8, 8)
    eater = B.move(tr.transform(rle.parse(EATER_RLE, device="cpu"), tr.SymmetryTransform.Rotate270), 24, 24)
    offsets = torch.tensor([[dx, dy] for dx in range(-4, 4) for dy in range(-4, 4)])
    out["catalyst"] = np_(*elite.sharded_catalyst_search(glider, eater, offsets, 32, mesh))

    p = mpc_problem()
    logits0 = torch.from_numpy(rng.normal(-1.0, 2.0, size=(8, 3, 64, 64)).astype(np.float32))
    out["candidate_solve"] = np_(*elite.sharded_candidate_solve(p, logits0, mesh, iters=5,
                                                                topk=2))
    initials = torch.from_numpy(rng.integers(0, 2, size=(4, 64, 64)).astype(bool))
    initials = B.from_dense(initials) & B.solid_rect(26, 26, 12, 12, device="cpu")
    out["scenario_sweep"] = np_(*elite.sharded_scenario_sweep(
        initials, p.target, 3, p.control_mask, mesh, torch.Generator().manual_seed(1),
        candidates_per_scenario=4, iters=3, weights=p.weights))

    state, unknown = eater_instance()
    # the instance at four places: equal populations, different boards, so a
    # champion taken from the wrong rank shows
    shift = torch.arange(4) * 9
    bst = BP.make(state=B.move_dyn(state.expand(4, 64), shift, shift),
                  unknown=B.move_dyn(unknown.expand(4, 64), shift, shift))
    for two_phase in (False, True):
        out[f"beam_{two_phase}"] = np_(*elite.sharded_beam_complete(
            bst, mesh, frontier=2, iters=8, two_phase=two_phase))
    res = elite.sharded_portfolio(state, unknown, torch.Generator().manual_seed(3), mesh,
                                  replicas=8, frontier=2, iters=12)
    out["portfolio"] = np_(res.found, res.best, res.best_pop, res.found_fraction)
    return out


def assert_same(got, want):
    """Integer and boolean results equal; float32 ones within COST_TOL."""
    assert got.keys() == want.keys()
    for name in want:
        for g, w in zip(got[name], want[name]):
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape, name
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, **COST_TOL, err_msg=name)
            else:
                assert (g == w).all(), name
