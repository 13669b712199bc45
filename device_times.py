#!/usr/bin/env python3
"""Device times of the port's rollout and fixpoint entries on one CUDA card,
for one tree or several, so that two commits can be compared in one run.

    python3 device_times.py [TREE ...]

Each TREE (default: this checkout) is a directory holding a
``lifeapi_tpu_torch`` package, such as an unpacked ``git archive`` of
another commit.  Each is timed in a process of its own, in the order given
(give parent, change, change, parent to see the drift between runs), with
``chip_smoke.py``'s profiler, which reads the mean of the launches a trace
holds, so a launch the trace missed does not read low.  The shapes are ``chip_smoke.py``'s: [1] and [4] on
8192 random boards over 512 generations, [2] on 64 boards over 32
generations (random toggles: the kernel's work does not depend on them),
[3] on the glider and eater over the 4096 offsets of the full grid, [6]-[9]
on the 4096 fixpoint boards ([6] and [9] through their BitStable entries,
the whole call; [7] and [8] through the planes API).  Prints one JSON line a
tree, then the card's name and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def measure(tree):
    import chip_smoke as S  # this checkout's, before the tree goes on the path

    sys.path.insert(0, str(tree))
    from lifeapi_tpu_torch import search
    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.ops import stable_cuda as SC
    from lifeapi_tpu_torch.ops import step_cuda
    from lifeapi_tpu_torch.stable import bitplane as BP

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    boards = B.random(gen, (S.HEADLINE_B,), device=dev)
    lo, hi = step_cuda.to_kernel_layout(boards)
    starts = B.empty(device=dev).expand(64, 64).contiguous()
    toggles = B.random(gen, (32, 64), device=dev)
    offsets = torch.tensor([[dx, dy] for dx in range(64) for dy in range(64)], device=dev)
    inputs = search.rollout_inputs(B.from_cells(S.GLIDER, device=dev),
                                   B.from_cells(S.EATER, device=dev), offsets, 64)
    known, unknown = S.eater_problem(dev, hide_cells=(), ring2=True)
    fix_bst = BP.make(state=known.expand(S.FIX_B, 64), unknown=unknown.expand(S.FIX_B, 64))
    fix_planes = BP.to_planes(fix_bst).contiguous()
    cases = {  # name: (call, kernel pattern, counter, calls a trace, whole call)
        "rollout": (lambda: step_cuda.rollout(boards, S.HEADLINE_T), "rollout_kernel",
                    "rollout", 5, False),
        "rollout_lohi": (lambda: step_cuda.rollout_lohi(lo, hi, S.HEADLINE_T),
                         "rollout_lohi_kernel", "rollout_lohi", 5, False),
        "controlled_rollout": (lambda: step_cuda.controlled_rollout(starts, toggles),
                               "controlled_kernel", "controlled_rollout", 20, False),
        "catalyst_rollout": (lambda: step_cuda.catalyst_rollout(*inputs), "catalyst_kernel",
                             "catalyst_rollout", 20, False),
        # [6] is a host loop over kernel A before its redesign, kernel B after
        "propagate_fused": (lambda: SC.propagate_fused(fix_bst), "step_kernel|fixpoint_kernel",
                            "propagate_fused", 20, True),
        "propagate_fixpoint": (lambda: SC.propagate_fixpoint(fix_planes), "fixpoint_kernel",
                               "propagate_fixpoint", 20, False),
        "propagate_fixpoint_priorities": (lambda: SC.propagate_fixpoint_priorities(fix_planes),
                                          "fixpoint_kernel", "propagate_fixpoint_priorities",
                                          20, False),
        "propagate_fused_beam": (lambda: SC.propagate_fused_beam(fix_bst), "fixpoint_kernel",
                                 "propagate_fused_beam", 20, True),
    }
    out = {name: S.profiled_device_ms(fn, kernel, counter, n, whole)
           for name, (fn, kernel, counter, n, whole) in cases.items()}
    mhz = S.sm_clock_under(cases["rollout"][0])
    return {"tree": str(tree), "device_ms": out, "sm_clock_mhz_under_rollout": mhz}


def main():
    if not torch.cuda.is_available():
        print("device_times: no CUDA card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(Path(sys.argv[2]).resolve())))
        return 0
    for tree in sys.argv[1:] or [ROOT]:
        subprocess.run([sys.executable, __file__, "--one", str(tree)], check=True)
    import chip_smoke

    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
