#!/usr/bin/env python3
"""Device times of the port's rollout, fixpoint and peel entries on one CUDA
card, for one tree or several, so that two commits can be compared in one
run.

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
the whole call; [7] and [8] through the planes API), [11] on 4096 and on
65536 pairs of 7-cell boards (beside ``torch.bitwise_or`` on the same
tensors, which moves the same bytes and does no work: the floor of any
kernel of those bytes), [12] on the p=0.5 boards against a 7-cell operand
at 13 planes, and ``union_interacting(method="sparse")`` on the seven mask
pairs of ``interaction_offsets`` over 1024 7-cell pairs (the whole call);
and [11] and ``bitwise_or`` at 4096, [12] and the union again (``_l2``) with
each call's inputs and outputs one of copies that together pass 100 MB, so
that they come from device memory and not from the 50 MB L2; and the
soft-Life rollout, VJP and HVP sweeps at 8, 64 and 192 candidates x
horizon 32 (``soft_rollout_vjp_64`` etc.); and conjugate gradients'
update at 8 and 64 systems x horizon 32, at 64 with ``ap`` the direction
itself, and at 64 x horizon 64 (and at 15 and 60 systems: one and four
whole waves of the clusters an H100 holds at once), system 0 frozen and
the state restored before each call, as ``chip_smoke.py`` ``[update]``
times it (``cg_update_64`` etc.).  Each peel, sweep and update time has the SM
clock read under it.  Prints one JSON line a tree; then, in one more
process that loads every tree's package under a name of its own, the call
times of that union and of ``interaction_offsets(method="sparse")`` on the
same pairs, the trees timed in turns, whether each tree's rollouts [1]-[4]
and three soft-Life sweeps give the first tree's outputs bit for bit on the
same seeded inputs (the sweeps with the largest absolute difference), and
each tree's CG update against the first tree's (the largest relative
difference of each array); then the card's name and power limit.  Beside a
tree's rollout times, each rollout kernel's generation-loop mix of SASS
instructions a generation (LOP3, SHF, SHFL, SEL, other) and its ptxas
registers and spill bytes, from that tree's build.

    python3 device_times.py --only cg_update [TREE ...]

times only the cases whose names start with one of the comma-separated
prefixes given (``rollout``, ``conv_sparse``, ``soft_rollout``,
``cg_update``, ...), and of the last process's parts only those of the
groups named (the union's calls with ``union_sparse``).
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# the soft-Life sweeps at [sqp]'s horizon 32: fewer candidates than SMs,
# [sqp]'s 64 and the line search's 192
SOFT_C, SOFT_TAU = (8, 64, 192), 0.25
SOFT_KERNELS = {"soft_rollout": "soft_rollout_kernel", "soft_rollout_vjp": "soft_vjp_kernel",
                "soft_rollout_hvp": "soft_hvp_kernel"}
# conjugate gradients' update: (name, systems, horizon, ap is p); besides
# [sqp]'s 64 systems and SOFT_FEW_C's 8, one wave and four whole waves of
# the clusters an H100 holds at once (15)
CG_CASES = (("cg_update_8", 8, 32, False), ("cg_update_15", 15, 32, False),
            ("cg_update_60", 60, 32, False), ("cg_update_64", 64, 32, False),
            ("cg_update_64_ap_is_p", 64, 32, True), ("cg_update_64_h64", 64, 64, False))
# the peel at a batch where its bytes bound (100 MB, 0.030 ms) is above a
# launch's fixed cost
LARGE_B = 65536
TURNS = 10


def sparse_boards(n, k, rng, dev):
    """n boards of k random cells in [20, 28)^2 each (chip_smoke's 7-cell
    kind), made on the card from numpy-seeded cells."""
    from lifeapi_tpu_torch.core import board as B

    cells = torch.from_numpy(rng.integers(20, 28, (n, k, 2))).to(dev)
    dense = torch.zeros((n, 64, 64), dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)[:, None].expand(n, k)
    dense[rows, cells[..., 0], cells[..., 1]] = True
    return B.from_dense(dense)


def interaction_pairs(CV, a, b):
    """The seven mask pairs that ``CV.interaction_offsets`` (``CV``: a
    ``core.convolve`` module) hands to ``union_interacting``: its
    ``interaction_pairs``, or, in a tree that has none, the pairs caught by
    swapping ``union_interacting`` for one call."""
    if hasattr(CV, "interaction_pairs"):
        return CV.interaction_pairs(a, b)
    seen = {}
    union = CV.union_interacting
    CV.union_interacting = lambda pairs, method=None: seen.setdefault("pairs", pairs)
    try:
        CV.interaction_offsets(a, b, method="sparse")
    finally:
        CV.union_interacting = union
    return seen["pairs"]


def peel_cases(S, dev):
    """{name: (call, kernel pattern, counter, calls a trace, whole call)} of
    the peel entries, and {name: floor call} beside [11]."""
    import numpy as np

    from lifeapi_tpu_torch.core import convolve as CV
    from lifeapi_tpu_torch.ops import conv_cuda as CC

    x = S.ConvInputs(dev)
    rng = np.random.default_rng(1)
    big_a, big_b = sparse_boards(LARGE_B, 7, rng, dev), sparse_boards(LARGE_B, 7, rng, dev)
    pairs = interaction_pairs(CV, x.io_a, x.io_b)
    union = "union_sparse_fused" if "union_sparse_fused" in CC.LAUNCHES else "convolve_sparse_fused"
    cases = {
        "conv_sparse_4096": (lambda: CC.convolve_sparse_fused(x.tr_a, x.tr_b),
                             "conv_sparse_kernel", "convolve_sparse_fused", 20, False),
        f"conv_sparse_{LARGE_B}": (lambda: CC.convolve_sparse_fused(big_a, big_b),
                                   "conv_sparse_kernel", "convolve_sparse_fused", 10, False),
        "counts_sparse_4096_13": (lambda: CC.counts_sparse_fused(x.a, x.tr_b, n_planes=13),
                                  "counts_sparse_kernel", "counts_sparse_fused", 20, False),
        # the whole call: the parent's stack, where and OR kernels around [11]
        "union_sparse_1024": (lambda: CV.union_interacting(pairs, method="sparse"),
                              "conv_sparse_kernel|union_sparse_kernel", union, 20, True),
    }
    # the B = 4096 cases again from device memory: each call's inputs and
    # outputs one of copies that together pass the L2
    copies = {name: S.rotation_copies(n) for name, n in S.peel_bytes(len(pairs)).items()}
    n11, n12, nu = (copies[k] for k in ("convolve_sparse_fused", "counts_sparse_fused",
                                        "union_sparse_fused"))
    cases["conv_sparse_4096_l2"] = (
        S.rotating_call(CC.convolve_sparse_fused,
                        [(x.tr_a.clone(), x.tr_b.clone()) for _ in range(n11)]),
        "conv_sparse_kernel", "convolve_sparse_fused", 20, False)
    cases["counts_sparse_4096_13_l2"] = (
        S.rotating_call(lambda a, b: CC.counts_sparse_fused(a, b, n_planes=13),
                        [(x.a.clone(), x.tr_b.clone()) for _ in range(n12)]),
        "counts_sparse_kernel", "counts_sparse_fused", 20, False)
    cases["union_sparse_1024_l2"] = (
        S.rotating_call(lambda p: CV.union_interacting(p, method="sparse"),
                        [(interaction_pairs(CV, x.io_a.clone(), x.io_b.clone()),)
                         for _ in range(nu)]),
        "conv_sparse_kernel|union_sparse_kernel", union, 20, True)
    outs = {n: torch.empty_like(a) for n, a in (("4096", x.tr_a), (str(LARGE_B), big_a))}
    floors = {
        "bitwise_or_4096": lambda: torch.bitwise_or(x.tr_a, x.tr_b, out=outs["4096"]),
        f"bitwise_or_{LARGE_B}": lambda: torch.bitwise_or(big_a, big_b, out=outs[str(LARGE_B)]),
        "bitwise_or_4096_l2": S.rotating_call(
            lambda a, b, out: torch.bitwise_or(a, b, out=out),
            [(x.tr_a.clone(), x.tr_b.clone(), torch.empty_like(x.tr_a)) for _ in range(n11)]),
    }
    return cases, floors


def soft_case_inputs(dev, cands, seed=0):
    """The adjoint sweeps' inputs at [sqp]'s shapes (horizon 32) for
    ``cands`` candidates, from a seed, on the card: the start board, the
    controls as ``soft_objective`` hands them over (a ``movedim`` view of
    sigmoid of ``init_logits``'s draw inside a 10 x 10 window), a
    trajectory cotangent, an HVP direction in the window, and the
    trajectory and adjoints of the forward and VJP twins, so that every
    tree's sweeps read the same tensors."""
    import numpy as np

    from lifeapi_tpu_torch.ops import soft_cuda

    rng = np.random.default_rng(seed)
    mask = np.zeros((64, 64), np.float32)
    mask[36:46, 36:46] = 1.0
    p0 = (rng.random((64, 64)) < 0.3).astype(np.float32)
    logits = rng.normal(-3.0, 0.5, (cands, 32, 64, 64)).astype(np.float32)
    controls = torch.from_numpy(mask / (1 + np.exp(-logits))).to(dev).movedim(-3, 0)
    p0 = torch.from_numpy(p0).to(dev)
    g_traj = torch.from_numpy(rng.standard_normal((32, cands, 64, 64), np.float32) * 1e-2).to(dev)
    w = torch.from_numpy(rng.standard_normal((32, cands, 64, 64), np.float32) * mask).to(dev)
    traj = soft_cuda.rollout_plain(p0, controls, SOFT_TAU)
    lam = soft_cuda.rollout_vjp_plain(p0, controls, traj, g_traj, SOFT_TAU, False)[2]
    return p0, controls, traj, g_traj, w, lam


def soft_cases(dev):
    """{name: (call, kernel pattern, counter, calls a trace, whole call)} of
    the three soft-Life sweeps at SOFT_C candidates x horizon 32."""
    from lifeapi_tpu_torch.ops import soft_cuda

    cases = {}
    for cands in SOFT_C:
        calls = soft_calls(soft_cuda, *soft_case_inputs(dev, cands))
        for name, fn in calls.items():
            cases[f"{name}_{cands}"] = (fn, SOFT_KERNELS[name], name, 20, False)
    return cases


def soft_calls(soft_cuda, p0, controls, traj, g_traj, w, lam):
    """{counter: call} of the three sweeps on these inputs."""
    return {"soft_rollout": lambda: soft_cuda.rollout(p0, controls, SOFT_TAU),
            "soft_rollout_vjp": lambda: soft_cuda.rollout_vjp(p0, controls, traj, g_traj,
                                                              SOFT_TAU),
            "soft_rollout_hvp": lambda: soft_cuda.rollout_hvp(p0, controls, traj, lam, w, None,
                                                              SOFT_TAU)}


def needs(only, group):
    """Whether the name prefixes ``only`` (None: every case) take in a case
    of ``group``, the prefix of that group's names."""
    return only is None or any(group.startswith(o) or o.startswith(group) for o in only)


def cg_cases(S, dev):
    """{name: (call, kernel pattern, counter, calls a trace, whole call)} of
    the CG update at CG_CASES on ``chip_smoke.py``'s seeded state (system 0
    frozen), each call on the state restored first."""
    from lifeapi_tpu_torch.ops import solver_cuda

    cases = {}
    for name, systems, horizon, ap_is_p in CG_CASES:
        x, r, p, ap, gamma, stop = S.cg_state(dev, (systems, horizon, 64, 64), 9)
        state = [t.clone() for t in (x, r, p, gamma)]

        def call(state=state, start=(x, r, p, gamma), ap=ap, stop=stop, ap_is_p=ap_is_p):
            for t, t0 in zip(state, start):
                t.copy_(t0)
            solver_cuda.cg_update(*state[:3], state[2] if ap_is_p else ap, state[3], stop)

        cases[name] = (call, "cg_update_kernel", "cg_update", 20, False)
    return cases


def rollout_inputs(S, dev):
    """The rollouts' inputs, drawn from seed 0: the headline boards, 64
    empty boards and 32 generations of random toggles, and the catalyst
    rollout's inputs for the glider and eater over the 4096 offsets."""
    from lifeapi_tpu_torch import search
    from lifeapi_tpu_torch.core import board as B

    gen = torch.Generator(device=dev).manual_seed(0)
    boards = B.random(gen, (S.HEADLINE_B,), device=dev)
    starts = B.empty(device=dev).expand(64, 64).contiguous()
    toggles = B.random(gen, (32, 64), device=dev)
    offsets = torch.tensor([[dx, dy] for dx in range(64) for dy in range(64)], device=dev)
    inputs = search.rollout_inputs(B.from_cells(S.GLIDER, device=dev),
                                   B.from_cells(S.EATER, device=dev), offsets, 64)
    return boards, starts, toggles, inputs


def measure(tree, only=None):
    import chip_smoke as S  # this checkout's, before the tree goes on the path

    sys.path.insert(0, str(tree))
    from lifeapi_tpu_torch.ops import stable_cuda as SC
    from lifeapi_tpu_torch.ops import step_cuda
    from lifeapi_tpu_torch.stable import bitplane as BP

    dev = torch.device("cuda")
    boards, starts, toggles, inputs = rollout_inputs(S, dev)
    lo, hi = step_cuda.to_kernel_layout(boards)
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

    def wanted(name):
        return only is None or name.startswith(only)

    out = {name: S.profiled_device_ms(fn, kernel, counter, n, whole)
           for name, (fn, kernel, counter, n, whole) in cases.items() if wanted(name)}
    mhz = S.sm_clock_under(cases["rollout"][0]) if wanted("rollout") else None
    clocks, peels, floors = {}, {}, {}
    if any(needs(only, k) for k in ("conv_sparse", "counts_sparse", "union_sparse", "bitwise_or")):
        peels, floors = peel_cases(S, dev)
    timed = {**peels, **(soft_cases(dev) if needs(only, "soft_rollout") else {}),
             **(cg_cases(S, dev) if needs(only, "cg_update") else {})}
    for name, (fn, kernel, counter, n, whole) in timed.items():
        if wanted(name):
            out[name], clocks[name] = S.device_ms_at(fn, kernel, counter, n, whole)
    for name, fn in floors.items():
        if wanted(name):
            out[name], clocks[name] = S.operator_device_ms(fn), S.sm_clock_under(fn)
    return {"tree": str(tree), "device_ms": out, "sm_clock_mhz_under_rollout": mhz,
            "sm_clock_mhz": clocks, **rollout_sass(S, tree, wanted)}


def rollout_sass(S, tree, wanted):
    """The generation-loop mix (chip_smoke.generation_loop_mix) and the
    ptxas registers and spill bytes of each rollout kernel timed, from the
    tree's own build and its source's shuffles a generation."""
    from lifeapi_tpu_torch.ops import _build

    names = [name for name in S.ROLLOUT_KERNELS if wanted(name)]
    if not names:
        return {}
    lib = _build.library_path()
    funcs = S.library_sass(lib)
    shuffles = S.rollout_step_shuffles(
        (Path(tree) / "lifeapi_tpu_torch" / "csrc" / "life_rollout.cu").read_text())
    ptxas = {fn: (regs, spill) for fn, regs, spill in
             S.ptxas_report(lib.with_suffix(".log").read_text())}
    mixes, registers = {}, {}
    for name in names:
        fn = S.ROLLOUT_KERNELS[name][0]
        mixes[name] = S.generation_loop_mix(funcs[fn], shuffles[fn])
        registers[name] = ptxas[fn]
    return {"loop_mix_a_generation": mixes, "ptxas_registers_spill_bytes": registers}


def load_tree(tree, k, module="core.convolve"):
    """``module`` of the lifeapi_tpu_torch package of ``tree``, the package
    imported as ``tree<k>``, so several trees' packages live in one process
    (the package imports itself by relative imports only)."""
    name = f"tree{k}"
    if name not in sys.modules:
        init = Path(tree) / "lifeapi_tpu_torch" / "__init__.py"
        spec = importlib.util.spec_from_file_location(
            name, init, submodule_search_locations=[str(init.parent)])
        package = importlib.util.module_from_spec(spec)
        sys.modules[name] = package
        spec.loader.exec_module(package)
    return importlib.import_module(f"{name}.{module}")


def soft_outputs_agree(trees):
    """Each tree's three sweeps on the same seeded inputs at each of SOFT_C
    candidates, against the first tree's: whether every output is equal bit
    for bit, the largest absolute difference, and that over the first
    tree's largest magnitude."""
    dev = torch.device("cuda")
    sweeps = [load_tree(tree, k, "ops.soft_cuda") for k, tree in enumerate(trees)]
    out = {}
    for cands in SOFT_C:
        p0, controls, traj, g_traj, w, lam = soft_case_inputs(dev, cands, seed=1)
        results = []
        for soft_cuda in sweeps:
            g_u, _, lam_k = soft_cuda.rollout_vjp(p0, controls, traj, g_traj, SOFT_TAU)
            results.append((soft_cuda.rollout(p0, controls, SOFT_TAU), g_u, lam_k,
                            *soft_cuda.rollout_hvp(p0, controls, traj, lam, w, None,
                                                   SOFT_TAU)[:3]))
        torch.cuda.synchronize()
        for k, got in enumerate(results[1:], start=1):
            pairs = list(zip(("traj", "g_u", "lam", "jw", "pu", "px"), got, results[0]))
            out[f"{cands} tree{k} vs tree0"] = {
                "bit_equal": {what: bool(torch.equal(a, b)) for what, a, b in pairs},
                "max_abs_diff": {what: float((a.double() - b.double()).abs().max())
                                 for what, a, b in pairs},
                "max_rel_diff": {what: float((a.double() - b.double()).abs().max()
                                             / b.double().abs().max()) for what, a, b in pairs}}
    return out


def rollout_outputs_agree(trees):
    """Each tree's rollouts [1]-[4] on measure()'s inputs (rollout_inputs;
    the headline boards over 512 generations), against the first tree's:
    whether every output is equal bit for bit."""
    import chip_smoke as S

    boards, starts, toggles, inputs = rollout_inputs(S, torch.device("cuda"))
    results = []
    for k, tree in enumerate(trees):
        step_cuda = load_tree(tree, k, "ops.step_cuda")
        lo, hi = step_cuda.to_kernel_layout(boards)
        results.append((step_cuda.rollout(boards, S.HEADLINE_T),
                        *step_cuda.rollout_lohi(lo, hi, S.HEADLINE_T),
                        step_cuda.controlled_rollout(starts, toggles),
                        *step_cuda.catalyst_rollout(*inputs)))
    torch.cuda.synchronize()
    names = ("rollout", "rollout_lohi low", "rollout_lohi high", "controlled_rollout",
             "catalyst_rollout final", "catalyst_rollout interacted")
    return {f"tree{k} vs tree0": {name: bool(torch.equal(a, b))
                                  for name, a, b in zip(names, got, results[0])}
            for k, got in enumerate(results[1:], start=1)}


def cg_outputs_agree(trees):
    """Each tree's CG update on the same seeded state at CG_CASES, against
    the first tree's: the largest relative difference of each array over
    its largest magnitude."""
    import chip_smoke as S

    dev = torch.device("cuda")
    updates = [load_tree(tree, k, "ops.solver_cuda") for k, tree in enumerate(trees)]
    out = {}
    for name, systems, horizon, ap_is_p in CG_CASES:
        x, r, p, ap, gamma, stop = S.cg_state(dev, (systems, horizon, 64, 64), 1)
        results = []
        for solver_cuda in updates:
            state = [t.clone() for t in (x, r, p, gamma)]
            solver_cuda.cg_update(*state[:3], state[2] if ap_is_p else ap, state[3], stop)
            results.append(state)
        torch.cuda.synchronize()
        for k, got in enumerate(results[1:], start=1):
            out[f"{name} tree{k} vs tree0"] = {
                what: float((a.double() - b.double()).abs().max() / b.double().abs().max())
                for what, a, b in zip(("x", "r", "p", "gamma"), got, results[0])}
    return out


def call_turns(trees, only=None):
    """Median CUDA-event milliseconds a call of union_interacting and of
    interaction_offsets, method "sparse", on the 1024 io pairs, for each
    tree, the trees timed in turns after one warm-up call each; then the
    sweeps' and the CG update's outputs against the first tree's.  With
    ``only``, the parts its prefixes name."""
    import statistics

    import chip_smoke as S

    out = {"trees": [str(t) for t in trees]}
    if needs(only, "union_sparse"):
        dev = torch.device("cuda")
        x = S.ConvInputs(dev)
        convs = [load_tree(tree, k) for k, tree in enumerate(trees)]
        calls = {}
        for k, CV in enumerate(convs):
            pairs = interaction_pairs(CV, x.io_a, x.io_b)
            calls[f"union_interacting {k}"] = lambda CV=CV, p=pairs: CV.union_interacting(
                p, method="sparse")
            calls[f"interaction_offsets {k}"] = lambda CV=CV: CV.interaction_offsets(
                x.io_a, x.io_b, method="sparse")
        samples = {name: [] for name in calls}
        for fn in calls.values():
            fn()
        for _ in range(TURNS):
            for name, fn in calls.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                samples[name].append(start.elapsed_time(end))
        out["call_ms"] = {name: statistics.median(v) for name, v in samples.items()}
    if needs(only, "rollout"):
        out["rollouts_against_tree0"] = rollout_outputs_agree(trees)
    if needs(only, "soft_rollout"):
        out["soft_sweeps_against_tree0"] = soft_outputs_agree(trees)
    if needs(only, "cg_update"):
        out["cg_update_against_tree0"] = cg_outputs_agree(trees)
    return out


def main():
    if not torch.cuda.is_available():
        print("device_times: no CUDA card", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    only = None
    if args[:1] == ["--only"]:
        only, args = tuple(args[1].split(",")), args[2:]
    if args[:1] == ["--one"]:
        print(json.dumps(measure(Path(args[1]).resolve(), only)))
        return 0
    if args[:1] == ["--turns"]:
        print(json.dumps(call_turns([Path(t).resolve() for t in args[1:]], only)))
        return 0
    prefix = ["--only", ",".join(only)] if only else []
    trees = args or [ROOT]
    for tree in trees:
        subprocess.run([sys.executable, __file__, *prefix, "--one", str(tree)], check=True)
    distinct = list(dict.fromkeys(str(Path(t).resolve()) for t in trees))
    subprocess.run([sys.executable, __file__, *prefix, "--turns", *distinct], check=True)
    import chip_smoke

    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
