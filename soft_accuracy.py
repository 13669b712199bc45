#!/usr/bin/env python3
"""The soft objective's gradient and HVP by the soft-Life sweeps and by the
eager per-generation loop, at the same logits, each against the float64
reference of the benchmark's SQP gate.

    python3 soft_accuracy.py [--solves N] [--seed S]

Runs ``N`` solves of cell ``mpc-sqp-c64-h32`` (``BENCHMARK.json``) through
the gate as the benchmark does (``bench_torch/mpc_sqp.gated_window``) and
prints each solve's gate readings.  Then, at each solve's last Newton
logits, it computes the gradient and the HVP along the gate's direction
twice: through ``soft_rollout``'s sweeps, and with ``mpc.soft.soft_step``
replaced by the same map under another name, which makes ``soft_rollout``
loop it eagerly under autograd.  Each is printed as the gate reads it, the
median and the largest candidate's relative error against
``bench_torch/reference.py``'s float64 gradient and HVP.  The two paths
reach different logits in a solve, so the gate's reading of one path's
solves says nothing alone about its arithmetic; at the same logits the
two can be compared.  Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch import measure, mpc_sqp, reference, run  # noqa: E402

CELL = "mpc-sqp-c64-h32"


def eager_map(soft_step):
    """``soft_step`` under another name: ``soft_rollout`` loops it eagerly."""
    def same(p, tau=0.2):
        return soft_step(p, tau)

    return same


def readings(problem, port_problem, logits, seed):
    """The gate's (median, largest) relative errors of the gradient and the
    HVP at ``logits``, computed by the port as it stands."""
    from lifeapi_tpu_torch.mpc import solver

    _, g_ref = reference.soft_objective(problem, logits.cpu().numpy(), grad=True)
    rng = np.random.default_rng([seed, 1])
    v = rng.standard_normal(logits.shape).astype(np.float32) * problem.control_mask
    h_ref = reference.soft_hvp(problem, logits.cpu().numpy(), v)
    _, grads, hvp = solver.grad_and_hvp(lambda x: solver.soft_objective(x, port_problem), logits)
    hv = hvp(torch.from_numpy(v).to(logits.device))
    return (reference.candidate_errs(grads.cpu().numpy(), g_ref),
            reference.candidate_errs(hv.cpu().numpy(), h_ref))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--solves", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from lifeapi_tpu_torch._device import resolve
    from lifeapi_tpu_torch.mpc import soft
    from lifeapi_tpu_torch.utils import profiling

    dev = resolve(who="soft_accuracy.py")
    workload = run.workloads()[CELL]
    problem = reference.sqp_problem(workload["configuration"])
    traffic = {**workload["traffic"], "solves": args.solves, "warmup_solves": 0}
    print(f"[env] {measure.card_line()}; torch {torch.__version__}; seed {args.seed}", flush=True)
    _, gates, _, runner = mpc_sqp.gated_window(problem, dev, args.seed, traffic,
                                               workload["limits"], profiling.Timer())
    for i, (gate, record) in enumerate(zip(gates, runner.records)):
        print(f"[solve {i}] gate: " + json.dumps({k: gate.get(k) for k in (
            "correct", "soft_objective", "objective_rel_err", "gradient_rel_err",
            "gradient_rel_err_max")}), flush=True)
        got = {"sweeps": readings(problem, runner.problem, record["logits"], args.seed)}
        with measure.patched(soft, "soft_step", eager_map):
            got["eager"] = readings(problem, runner.problem, record["logits"], args.seed)
        for path, (grad, hvp) in got.items():
            print(f"[solve {i}] {path}: gradient median {grad[0]:.4g} largest {grad[1]:.4g}; "
                  f"HVP median {hvp[0]:.4g} largest {hvp[1]:.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
