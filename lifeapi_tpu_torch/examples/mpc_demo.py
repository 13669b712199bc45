"""MPC trajectory optimization: steer an empty torus into a target still
life (a block) with per-step cell toggles, then verify bit-exactly (the
port of ``examples/mpc_demo.py``).

    python -m lifeapi_tpu_torch.examples.mpc_demo [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core import board, rle
from ..mpc import CostWeights, MPCProblem, solver
from ..target import LifeTarget, hamming_cost
from . import life_step_dense, resolve_device

BLOCK_AT = (31, 31)


def problem(device, horizon=8):
    """The demo problem: an empty board, a block at (31, 31) as the target,
    toggles allowed in [24, 40)^2."""
    mask = torch.zeros((64, 64), dtype=torch.bool, device=device)
    mask[24:40, 24:40] = True
    target = board.move(rle.parse("2o$2o!", device=device), *BLOCK_AT)
    return MPCProblem(initial=board.empty(device=device),
                      target=LifeTarget.from_state(target), horizon=horizon,
                      control_mask=mask, weights=CostWeights(target=1.0, control=0.01))


def run(device):
    """Solve the demo problem (16 candidates, 150 iterations) from a CPU
    generator seeded with 0, the same draw on every device.  Returns a
    dict with the solution, its Hamming distance to the target, the
    toggles used and whether a numpy replay of the controls reaches the
    same final board."""
    device = torch.device(device)
    p = problem(device)
    sol = solver.solve(p, torch.Generator().manual_seed(0), n_candidates=16, iters=150)
    dense = np.zeros((64, 64), dtype=bool)
    for tog in board.to_dense(sol.controls).cpu().numpy():
        dense = life_step_dense(dense ^ tog)
    return {"solution": sol,
            "hamming": int(hamming_cost(sol.final_board, p.target)),
            "toggles": int(board.population(sol.controls).sum()),
            "replayed": bool((dense == board.to_dense(sol.final_board).cpu().numpy()).all())}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    r = run(resolve_device(args.device))
    print("hard cost:", float(r["solution"].cost))
    print("Hamming to target:", r["hamming"])
    print("toggles used:", r["toggles"])
    print("numpy replay equals the final board:", r["replayed"])


if __name__ == "__main__":
    main()
