"""Catalyst compatibility prefiltering with UnweldableMask (the port of
``examples/unweldable_prefilter.py``).

The reference's compound search driver (LifeWeld.hpp:247-277): given two
catalysts with their stators stripped (welds), find every relative
placement at which NO stable stator can be rebuilt around the pair; a
downstream catalyst search can skip those placements.

Here: the reference eater fixture (stator stripped via ``from_required``)
against a block, over a small window of placements, with the batched beam
engine (every placement one problem of one batched search).

    python -m lifeapi_tpu_torch.examples.unweldable_prefilter [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from .. import weld as W
from ..core import board, rle
from . import resolve_device


def run(device, window=((1, 6), (1, 6)), batch_size=32, beam_iters=24):
    """UnweldableMask (beam engine, escalation on) of the eater weld against
    a block over the displacements ``window`` (x range, y range).  Returns
    a dict."""
    device = torch.device(device)
    eater = board.move(rle.parse("2b2o$bobo$bo$2o!", device=device), 20, 20)
    required = board.move(rle.parse("2b2o$b3o$b4o$5o$4o$4o!", device=device), 19, 19)
    a = W.from_required(eater, required)
    b = W.LifeWeld.from_state(board.move(rle.parse("2o$2o!", device=device), 20, 20))

    (x0, x1), (y0, y1) = window
    inside = torch.zeros((64, 64), dtype=torch.bool, device=device)
    inside[x0:x1, y0:y1] = True
    inter = board.to_dense(W.interaction_offsets(a, b))
    mask = W.unweldable_mask(a, b, starting_good=board.from_dense(~inside), engine="beam",
                             batch_size=batch_size, beam_iters=beam_iters)
    tested = inside & ~inter
    marked = board.to_dense(mask) & tested
    return {"frozen_cells": int(board.population(a.all_frozen())),
            "tested": int(tested.sum()), "proved": int(marked.sum()),
            "interacting": int((inside & inter).sum()),
            "marked": [tuple(c) for c in marked.nonzero().tolist()], "mask": mask}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    r = run(resolve_device(args.device))
    print("catalyst frozen cells:", r["frozen_cells"])
    print(f"placements tested: {r['tested']}, proved unweldable: {r['proved']}, "
          f"interacting (pre-marked): {r['interacting']}")
    for x, y in r["marked"]:
        print(f"  offset ({x}, {y}): no stable stator exists")


if __name__ == "__main__":
    main()
