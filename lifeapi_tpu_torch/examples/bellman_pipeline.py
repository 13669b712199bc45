"""The full Bellman-style workflow, end to end (the port of
``examples/bellman_pipeline.py``):

1. **Catalyst search**: find placements of an eater that interact with an
   incoming glider and recover.
2. **Weld**: strip the eater's stator, recording frozen neighbour counts
   (``from_required``, LifeWeld.hpp:133-159).
3. **Reaction-constrained completion** (``to_stable_with_history``,
   LifeWeld.hpp:327-400): replay the reaction, restricting still-life
   options so the required births happen and spurious ones don't, then
   complete a stator with the host DFS.
4. **Verify bit-exactly**: the completed background plus the glider,
   stepped through the whole horizon, must consume the glider and recover.
5. **Batched**: the reaction-constrained completion of every recovering
   placement as one beam call, each background verified the same way.

    python -m lifeapi_tpu_torch.examples.bellman_pipeline [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from .. import search as SR
from .. import weld as W
from .._device import resolve
from ..core import board, rle
from ..ops import step_cuda
from ..stable import complete as C
from ..stable import host as HO
from ..stable import propagate as P
from ..symmetry import transforms as tr
from ..symmetry.transforms import SymmetryTransform as T
from . import Stages, resolve_device

EATER = "2b2o$bobo$bo$2o!"
# the eater's required (non-stator) cells, at a (-1, -1) relative offset
# (the reference LifeWeldTest eater fixture)
EATER_REQ = "2b2o$b3o$b4o$5o$4o$4o!"
GLIDER = "bob$2bo$3o!"
HORIZON = 64


def build(pat, dx, dy, pre_dx=0, pre_dy=0, device=None):
    """The pattern moved by (pre_dx, pre_dy), rotated 270 degrees, then
    moved to (24 + dx, 24 + dy).  ``dx``/``dy`` are ints, or integer tensors
    for a batch of placements, whose device the board takes unless given
    another."""
    device = resolve(device, like=(dx, dy))
    b = tr.transform(board.move(rle.parse(pat, device=device), pre_dx, pre_dy), T.Rotate270)
    if torch.is_tensor(dx):
        return board.move_dyn(b, 24 + dx, 24 + dy)
    return board.move(b, 24 + dx, 24 + dy)


def reaction_problems(glider, dx, dy, horizon=HORIZON):
    """The weld of the eater at the given placement(s) and its
    reaction-constrained still-life problem, with the search kept to the
    catalyst's big ZOI (the glider's flight path stays OFF)."""
    device = glider.device
    catalyst = build(EATER, dx, dy, device=device)
    weld = W.from_required(catalyst, build(EATER_REQ, dx, dy, -1, -1, device=device))
    stab = W.to_stable_with_history(weld, glider, horizon)
    stab = P.set_off(stab, board.to_dense(~board.big_zoi(catalyst) & ~weld.state))
    return catalyst, weld, stab


def recovers(backgrounds, glider, horizon=HORIZON):
    """bool[B]: each background is a still life, and with the glider it
    recovers bit-exactly after ``horizon`` generations (stepped by the
    rollout kernel on a CUDA device)."""
    backgrounds = backgrounds.contiguous()
    still = board.equal(step_cuda.rollout(backgrounds, 1), backgrounds)
    final = step_cuda.rollout((backgrounds | glider).contiguous(), horizon)
    return still & board.equal(final, backgrounds)


def run(device, horizon=HORIZON, dfs_timeout=20.0, frontier=4, iters=24):
    """Run the workflow on ``device``; returns a dict of its results and
    ``stages``, the host seconds of each stage."""
    device = torch.device(device)
    clock = Stages(device)
    glider = board.move(rle.parse(GLIDER, device=device), 8, 8)
    out = {}

    with clock("catalyst search"):
        eater0 = build(EATER, 0, 0, device=device)
        offsets = SR.candidate_offsets(glider, eater0)
        res = SR.catalyst_search(glider, eater0, offsets, horizon)
        hits = SR.successful_catalysts(res)
        if not bool(hits.any()):
            raise RuntimeError("no recovering placement found")
        selected = [tuple(int(v) for v in o) for o in offsets[hits].tolist()]
    dx, dy = selected[0]
    out.update(candidates=int(offsets.shape[0]), hits=len(selected), offset=(dx, dy),
               selected=selected)

    with clock("weld and replay"):
        catalyst, weld, stab = reaction_problems(glider, dx, dy, horizon)
        if not bool(W.step(weld).equal(weld)):
            raise RuntimeError("the weld is not step-invariant")
    out.update(stripped=int(board.population(catalyst & ~weld.state)), weld=weld,
               problem=stab, catalyst_pop=int(board.population(catalyst)))

    with clock("host DFS completion"):
        host_st = HO.HostStable(*(t.cpu().numpy() for t in stab))
        result, best = C.complete_stable(host_st, timeout=dfs_timeout, minimise=True)
        background = board.from_dense(torch.from_numpy(best)).to(device)
    out.update(dfs_result=result, background=background,
               background_pop=int(board.population(background)))

    with clock("verify"):
        out["verified"] = bool(recovers(background[None], glider, horizon)[0])

    # the batched form: every recovering placement's reaction-constrained
    # completion in one beam call
    with clock("batched problems"):
        sel = torch.tensor(selected, dtype=torch.int64, device=device)
        _, _, problems = reaction_problems(glider, sel[:, 0], sel[:, 1], horizon)
    with clock("batched beam"):
        bres = C.complete_stable_beam(problems, frontier=frontier, iters=iters,
                                      minimise=False, dense=False)
    with clock("batched verify"):
        ok = recovers(bres.best, glider, horizon) & bres.found
    out.update(problems=problems, beam=bres, batched_found=int(bres.found.sum()),
               batched_verified=int(ok.sum()), glider=glider, stages=clock.seconds)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    r = run(resolve_device(args.device))
    print(f"catalyst search: {r['hits']} recovering placements of {r['candidates']} "
          f"candidates; using offset {r['offset']}")
    print(f"weld: stripped {r['stripped']} stator cells into frozen counts")
    if r["dfs_result"] != C.CompletionResult.COMPLETED:
        raise RuntimeError(f"completion failed: {r['dfs_result']}")
    print(f"completion: still life of pop {r['background_pop']} (original catalyst pop "
          f"{r['catalyst_pop']})")
    if not r["verified"]:
        raise RuntimeError("the reaction on the completed background failed to recover")
    print(f"verified: glider consumed, background recovered bit-exactly after {HORIZON} "
          f"generations")
    print(rle.to_rle(r["background"]))
    print(f"batched: {r['batched_found']}/{r['hits']} placements completed in one solver "
          f"call; {r['batched_verified']} verified recovering backgrounds")
    if not r["batched_verified"]:
        raise RuntimeError("no batched background verified")
    print("stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in r["stages"].items()))


if __name__ == "__main__":
    main()
