"""Minimal still-life completion of one hard instance, portfolio style (the
port of ``examples/portfolio_minimise.py``).

The reference answers deep single-instance searches with a recursive DFS
(LifeStable.hpp:1340-1458); the batched answer is a PORTFOLIO: many
orbit-randomized beam replicas of the same instance in one beam call, a
seeded re-minimise pass and, optionally, a champion-bounded host-DFS polish
that reaches the exact minimum.

    python -m lifeapi_tpu_torch.examples.portfolio_minimise [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..core import board, rle
from ..stable import complete
from . import life_step_dense, resolve_device

ANCHORS = ((20, 20), (22, 22))


def run(device, replicas=256, frontier=4, iters=192, dfs_polish_timeout=None, seed=0):
    """Complete the two-anchor instance (both anchors ON, their 2-ring
    unknown) with :func:`complete_stable_portfolio`, translations drawn
    from a CPU generator seeded with ``seed``.  Returns a dict with the
    result and an independent numpy check of the champion."""
    device = torch.device(device)
    a = board.from_cells(ANCHORS, device=device)
    unknown = board.zoi(board.zoi(a)) & ~a
    res = complete.complete_stable_portfolio(
        a, unknown, torch.Generator().manual_seed(seed), replicas=replicas,
        frontier=frontier, iters=iters, minimise=True, dfs_polish_timeout=dfs_polish_timeout)
    dense = board.to_dense(res.best).cpu().numpy()
    return {"result": res, "dense": dense,
            "still_life": bool((life_step_dense(dense) == dense).all()),
            "anchors_on": all(bool(dense[x, y]) for x, y in ANCHORS),
            "inside_area": bool(board.is_empty(res.best & ~(a | unknown)))}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--replicas", type=int, default=128)
    parser.add_argument("--iters", type=int, default=96)
    parser.add_argument("--polish", type=float, default=10.0,
                        help="seconds of champion-bounded host DFS (0: none)")
    args = parser.parse_args(argv)
    r = run(resolve_device(args.device), replicas=args.replicas, iters=args.iters,
            dfs_polish_timeout=args.polish or None)
    res = r["result"]
    print(f"found={res.found} population={res.best_pop} "
          f"(replicas that completed: {res.found_fraction:.0%})")
    print(rle.write_rle(r["dense"]))
    if not (r["still_life"] and r["anchors_on"]):
        raise RuntimeError("the champion is not a still life holding both anchors")
    print("verified: still life containing both anchors:", r["anchors_on"])


if __name__ == "__main__":
    main()
