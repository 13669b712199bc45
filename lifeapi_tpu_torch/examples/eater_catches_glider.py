"""Batched catalyst search: find eater placements that consume a glider
and recover (the classic LifeAPI-style search; the port of
``examples/eater_catches_glider.py``).  On the card the placements run
through the catalyst-rollout kernel.

    python -m lifeapi_tpu_torch.examples.eater_catches_glider [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from .. import search
from ..core import board, rle
from ..symmetry import transforms as tr
from ..symmetry.transforms import SymmetryTransform as T
from . import resolve_device


def run(device, horizon=100):
    """An eater (rotated 270 degrees, at (24, 24)) moved by every (dx, dy)
    in [-8, 8]^2 against a glider at (8, 8).  Returns a dict with the
    search result and the offsets of the working placements."""
    device = torch.device(device)
    glider = board.move(rle.parse("bob$2bo$3o!", device=device), 8, 8)
    eater = board.move(tr.transform(rle.parse("2b2o$bobo$bo$2o!", device=device),
                                    T.Rotate270), 24, 24)
    offsets = torch.tensor([[dx, dy] for dx in range(-8, 9) for dy in range(-8, 9)],
                           device=device)
    result = search.catalyst_search(glider, eater, offsets, horizon)
    hits = search.successful_catalysts(result)
    return {"result": result, "hits": offsets[hits].cpu().tolist()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    r = run(resolve_device(args.device))
    print(f"{len(r['hits'])} working placements out of {r['result'].offsets.shape[0]}")
    for dx, dy in r["hits"][:5]:
        print(f"  eater moved by ({dx}, {dy}) eats the glider and recovers")


if __name__ == "__main__":
    main()
