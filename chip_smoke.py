#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing what it saw:

1. environment: the card's name and power limit; build the CUDA kernels
   of ``lifeapi_tpu_torch/csrc`` with nvcc;
2. the main path, with the kernels' launch counters set to 0 just before:
   the headline rollout (8192 random boards, 512 generations), the MPC
   solver in its demo and bench configurations, and the catalyst search on
   the full 64x64 offset grid and on the example's grid;
3. checks: every kernel against its plain PyTorch twin on the same inputs
   (bit-exact), the rollout against an independent numpy B3/S23 oracle,
   the MPC demo at Hamming 0, the known catalyst hit counts, and every
   kernel launched by the main path;
4. timings on the card (CUDA events, medians after a warm-up).

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.  There is no CPU path: without
CUDA, or when any check fails, the script exits non-zero.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SOURCE = "lifeapi_tpu_torch/csrc/life_rollout.cu"
REPLACES = {
    "rollout": "lifeapi_tpu/ops/step_pallas.py:340",
    "controlled_rollout": "lifeapi_tpu/ops/step_pallas.py:160",
    "catalyst_rollout": "lifeapi_tpu/ops/step_pallas.py:243",
}
HEADLINE_B, HEADLINE_T = 8192, 512
GLIDER = [(8, 10), (9, 8), (9, 10), (10, 9), (10, 10)]
EATER = [(24, 21), (24, 22), (25, 21), (25, 23), (26, 23), (27, 23), (27, 24)]


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Independent numpy oracle (dense B3/S23 on the torus)
# ---------------------------------------------------------------------------


def oracle_dense(words):
    """int64 boards [..., 64] -> uint8 cells [..., 64, 64] indexed [x, y]."""
    w = np.ascontiguousarray(words).view(np.uint64)
    return ((w[..., None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)).astype(np.uint8)


def oracle_step(g):
    count = sum(
        np.roll(np.roll(g, dx, axis=-2), dy, axis=-1)
        for dx in (-1, 0, 1) for dy in (-1, 0, 1)
    ) - g
    return ((count == 3) | ((g == 1) & (count == 2))).astype(np.uint8)


def max_cell_err(a, b):
    """Largest |a - b| over the cells of two board tensors (0 or 1)."""
    return float((oracle_dense(a.cpu().numpy()) != oracle_dense(b.cpu().numpy())).max())


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def paired_ms(kernel_fn, plain_fn, reps):
    """Median milliseconds of kernel_fn and plain_fn on the card, timed with
    CUDA events in alternating turns after one warm-up call of each."""
    kernel_fn()
    plain_fn()
    times = {kernel_fn: [], plain_fn: []}
    for _ in range(reps):
        for fn in (kernel_fn, plain_fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[fn].append(start.elapsed_time(end))
    return statistics.median(times[kernel_fn]), statistics.median(times[plain_fn])


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1

    from lifeapi_tpu_torch.core import board as B
    from lifeapi_tpu_torch.core import rle
    from lifeapi_tpu_torch.mpc import CostWeights, MPCProblem, solver
    from lifeapi_tpu_torch.ops import _build, step_cuda
    from lifeapi_tpu_torch import search
    from lifeapi_tpu_torch.target import LifeTarget, hamming_cost

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # -- 1. environment ------------------------------------------------------
    print(f"[env] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.library()
    print(f"[env] built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[env] ptxas: {line.strip()}")

    # -- inputs of the main path ----------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    boards = B.random(gen, (HEADLINE_B,), device=dev)

    def block_target():
        return LifeTarget.from_state(B.move(rle.parse("2o$2o!", device=dev), 31, 31))

    def mask(lo, hi):
        m = torch.zeros((64, 64), dtype=torch.bool, device=dev)
        m[lo:hi, lo:hi] = True
        return m

    demo = MPCProblem(initial=B.empty(device=dev), target=block_target(),
                      horizon=8, control_mask=mask(24, 40),
                      weights=CostWeights(target=1.0, control=0.01))
    bench = MPCProblem(initial=B.empty(device=dev), target=block_target(),
                       horizon=32, control_mask=mask(20, 44),
                       weights=CostWeights())
    glider = B.from_cells(GLIDER, device=dev)
    eater = B.from_cells(EATER, device=dev)
    full_grid = torch.tensor([[dx, dy] for dx in range(64) for dy in range(64)],
                             device=dev)
    example_grid = torch.tensor(
        [[dx, dy] for dx in range(-8, 9) for dy in range(-8, 9)], device=dev)

    # -- 2. the main path -----------------------------------------------------
    torch.cuda.synchronize()
    step_cuda.reset_launches()
    t0 = time.perf_counter()
    rolled = step_cuda.rollout(boards, HEADLINE_T)
    demo_sol = solver.solve(demo, torch.Generator().manual_seed(0),
                            n_candidates=16, iters=150)
    bench_logits0 = solver.init_logits(torch.Generator().manual_seed(0), bench, 64)
    bench_logits, _ = solver.solve_gradient(bench_logits0, bench, iters=100)
    bench_sol = solver.rescore_and_select(bench_logits, bench)
    full = search.catalyst_search(glider, eater, full_grid, 64)
    example = search.catalyst_search(glider, eater, example_grid, 100)
    torch.cuda.synchronize()
    launches = dict(step_cuda.LAUNCHES)
    print(f"[path] main path ran in {time.perf_counter() - t0:.2f} s; "
          f"launches {launches}")
    check(all(launches[name] > 0 for name in REPLACES),
          f"a kernel of the main path was never launched: {launches}")
    err = dict.fromkeys(REPLACES, 0.0)

    # -- 3a. rollout ----------------------------------------------------------
    plain = step_cuda.rollout_plain(boards, HEADLINE_T)
    err["rollout"] = max_cell_err(rolled, plain)
    check(torch.equal(rolled, plain), "rollout kernel != plain twin")
    g = oracle_dense(boards[:64].cpu().numpy())
    for _ in range(HEADLINE_T):
        g = oracle_step(g)
    check((oracle_dense(rolled[:64].cpu().numpy()) == g).all(),
          "rollout kernel != numpy oracle")
    ragged = B.random(gen, (1000,), device=dev)
    got, want = step_cuda.rollout(ragged, 37), step_cuda.rollout_plain(ragged, 37)
    err["rollout"] = max(err["rollout"], max_cell_err(got, want))
    check(torch.equal(got, want), "ragged rollout kernel != plain twin")
    print(f"[rollout] B={HEADLINE_B} T={HEADLINE_T}: kernel == plain on all "
          f"boards, == numpy oracle on 64; ragged B=1000 T=37 kernel == plain")

    # -- 3b. MPC ----------------------------------------------------------------
    demo_ham = int(hamming_cost(demo_sol.final_board, demo.target))
    print(f"[mpc] demo: cost {float(demo_sol.cost)}, Hamming {demo_ham}, "
          f"{int((demo_sol.all_costs < 1).sum())}/16 candidates below 1")
    check(demo_ham == 0, f"MPC demo config missed the target: Hamming {demo_ham}")
    probs = torch.sigmoid(bench_logits) * bench.control_mask
    toggles = solver.candidate_toggles(probs, bench)
    starts = bench.initial.expand(64, 64).contiguous()
    finals_k = step_cuda.controlled_rollout(starts, toggles)
    finals_p = step_cuda.controlled_rollout_plain(starts, toggles)
    costs_k = solver.hard_cost(finals_k, toggles, bench)
    costs_p = solver.hard_cost(finals_p, toggles, bench)
    err["controlled_rollout"] = max_cell_err(finals_k, finals_p)
    check(torch.equal(finals_k, finals_p), "controlled kernel != plain twin")
    check(torch.equal(costs_k, costs_p), "MPC hard costs: kernel != plain twin")
    check(torch.equal(costs_k, bench_sol.all_costs), "MPC rescoring is not reproducible")
    print(f"[mpc] bench: 64 hard costs kernel == plain; best {float(bench_sol.cost)}, "
          f"Hamming {int(hamming_cost(bench_sol.final_board, bench.target))}")

    # -- 3c. catalyst search ------------------------------------------------------
    full_cpu = search.catalyst_search(glider.cpu(), eater.cpu(), full_grid.cpu(), 64)
    for field in ("interacted", "recovered", "reaction_changed", "final"):
        check(torch.equal(getattr(full, field).cpu(), getattr(full_cpu, field)),
              f"catalyst search {field}: kernel != plain twin")
    inputs = search.rollout_inputs(glider, eater, full_grid, 64)
    final_k, inter_k = step_cuda.catalyst_rollout(*inputs)
    final_p, inter_p = step_cuda.catalyst_rollout_plain(*inputs)
    err["catalyst_rollout"] = max(max_cell_err(final_k, final_p),
                                  float((inter_k != inter_p).any()))
    check(torch.equal(final_k, final_p) and torch.equal(inter_k, inter_p),
          "catalyst kernel != plain twin on the card")
    hits = int(search.successful_catalysts(full).sum())
    n_inter, n_rec = int(full.interacted.sum()), int(full.recovered.sum())
    example_hits = int(search.successful_catalysts(example).sum())
    print(f"[catalyst] 4096 offsets, horizon 64: {hits} hits, {n_inter} interacted, "
          f"{n_rec} recovered (kernel == plain); example grid, horizon 100: "
          f"{example_hits} hits")
    check((hits, n_inter, n_rec) == (16, 266, 3846), "catalyst counts differ from 16/266/3846")
    check(example_hits == 13, "example grid did not give 13 hits")
    print(f"[counters] {launches}")

    # -- 4. timings ---------------------------------------------------------------
    ms, plain_ms = {}, {}
    ms["rollout"], plain_ms["rollout"] = paired_ms(
        lambda: step_cuda.rollout(boards, HEADLINE_T),
        lambda: step_cuda.rollout_plain(boards, HEADLINE_T), reps=5)
    ms["controlled_rollout"], plain_ms["controlled_rollout"] = paired_ms(
        lambda: step_cuda.controlled_rollout(starts, toggles),
        lambda: step_cuda.controlled_rollout_plain(starts, toggles), reps=10)
    ms["catalyst_rollout"], plain_ms["catalyst_rollout"] = paired_ms(
        lambda: step_cuda.catalyst_rollout(*inputs),
        lambda: step_cuda.catalyst_rollout_plain(*inputs), reps=10)
    steps = HEADLINE_B * HEADLINE_T
    print(f"[time] card: {card}")
    print(f"[time] rollout B={HEADLINE_B} T={HEADLINE_T}: kernel {ms['rollout']:.4f} ms "
          f"({steps / ms['rollout'] * 1e3:.4g} steps/s), plain {plain_ms['rollout']:.4f} ms "
          f"({steps / plain_ms['rollout'] * 1e3:.4g} steps/s)")
    print(f"[time] catalyst rollout 4096 offsets, horizon 64: kernel "
          f"{ms['catalyst_rollout']:.4f} ms ({4096 / ms['catalyst_rollout'] * 1e3:.4g} "
          f"placements/s), plain {plain_ms['catalyst_rollout']:.4f} ms "
          f"({4096 / plain_ms['catalyst_rollout'] * 1e3:.4g} placements/s)")
    print(f"[time] controlled rollout 64 candidates, horizon 32: kernel "
          f"{ms['controlled_rollout']:.4f} ms, plain {plain_ms['controlled_rollout']:.4f} ms")
    search_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        search.catalyst_search(glider, eater, full_grid, 64)
        torch.cuda.synchronize()
        search_s.append(time.perf_counter() - t0)
    search_med = statistics.median(search_s)
    print(f"[time] catalyst_search end to end, 4096 offsets, horizon 64: median "
          f"{search_med * 1e3:.3f} ms ({4096 / search_med:.4g} placements/s) over "
          f"{len(search_s)}")
    solve_s = []
    for seed in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(bench, torch.Generator().manual_seed(seed), n_candidates=64, iters=100)
        torch.cuda.synchronize()
        solve_s.append(time.perf_counter() - t0)
    print(f"[time] MPC bench config (64 candidates, horizon 32, 100 iterations): "
          f"median {statistics.median(solve_s):.3f} s per solve over {len(solve_s)}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name]}
        for name in REPLACES
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
