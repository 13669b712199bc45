"""Receding-horizon MPC: replan every 2 generations while steering an
empty torus into a block, verified bit-exactly (the port of
``examples/receding_mpc.py``).

    python -m lifeapi_tpu_torch.examples.receding_mpc [--device cpu] [--fused]
"""

from __future__ import annotations

import argparse

import torch

from ..core import board
from ..mpc import CostWeights, receding
from . import life_step_dense, resolve_device
from .mpc_demo import problem as demo_problem


def problem(device, horizon=4):
    """The demo's problem at horizon 4 with a path weight of 1, so a plan
    acts inside the applied window instead of deferring to its end."""
    return demo_problem(device, horizon)._replace(
        weights=CostWeights(target=1.0, control=0.01, path=1.0))


def run(device, fused=False):
    """Drive the receding-horizon loop (8 steps, replanning every 2, 8
    candidates, 80 iterations; ``receding.run``, or ``receding.run_fused``
    with ``fused``) with logits drawn from a CPU generator seeded with 0,
    the same draw on every device.  Returns a dict with the run, its final
    Hamming distance and whether every visited board is the numpy step of
    the one before XOR its applied toggles."""
    device = torch.device(device)
    p = problem(device)
    drive = receding.run_fused if fused else receding.run
    result = drive(p, torch.Generator().manual_seed(0), steps=8, apply_horizon=2,
                   n_candidates=8, solve_iters=80)
    boards = board.to_dense(result.boards).cpu().numpy()
    applied = board.to_dense(result.applied).cpu().numpy()
    exact = all((life_step_dense(boards[i] ^ applied[i]) == boards[i + 1]).all()
                for i in range(len(applied)))
    return {"run": result, "hamming": int(receding.final_error(result, p.target)),
            "exact_dynamics": exact}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--fused", action="store_true",
                        help="receding.run_fused: no host sync in the loop")
    args = parser.parse_args(argv)
    r = run(resolve_device(args.device), fused=args.fused)
    print("per-solve costs:", [round(c, 3) for c in r["run"].costs.tolist()])
    print("final Hamming:", r["hamming"])
    print("exact dynamics:", r["exact_dynamics"])


if __name__ == "__main__":
    main()
