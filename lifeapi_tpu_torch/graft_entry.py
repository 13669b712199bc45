"""The flagship forward step and the multi-device dry run (counterpart of
``__graft_entry__.py``).

* :func:`entry` returns ``(forward, (example_logits,))``: the MPC engine's
  batched soft-rollout objective and the bit-exact hard rescoring, which
  runs the controlled-rollout kernel [2] on the card.
* :func:`dryrun_multichip` runs the sharded runners of
  :mod:`lifeapi_tpu_torch.parallel.elite` once over ``n`` ranks, on tiny
  shapes, and holds every result to the same runners on a mesh of one
  rank, so that a wrong collective layout fails it instead of passing on
  shapes.  On the card its shards launch kernels [1], [2], [3] and [10].

Run on the card, which runs the forward step and then the dry run over
every card of the machine (NCCL)::

    python -m lifeapi_tpu_torch.graft_entry

Both default to CUDA and raise without it; ``device="cpu"`` runs them on
the CPU, the dry run over gloo.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from ._device import resolve

EATER_RLE = "2b2o$bobo$bo$2o!"
GLIDER_RLE = "bob$2bo$3o!"
# the dry run's float32 hard costs against the one-rank mesh's
COST_TOL = dict(rtol=1e-4, atol=1e-5)
# seconds a dry run waits for each spawned rank
RANKS_TIMEOUT_S = 600

# A spawned rank: the package's root, the rendezvous, the world, the rank,
# the device type.
_RANK = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from lifeapi_tpu_torch.graft_entry import _rank_run\n"
    "_rank_run(int(sys.argv[4]), int(sys.argv[3]), sys.argv[5], sys.argv[2])\n"
    "print(f'rank {sys.argv[4]} ok', flush=True)\n"
)


def _device(device):
    """The entry points' device: CUDA unless the caller names another."""
    return resolve(device, who="graft_entry runs")


def _block_target(dev):
    from .core import board as B
    from .core import rle
    from .target import LifeTarget

    return LifeTarget.from_state(B.move(rle.parse("2o$2o!", device=dev), 31, 31))


def _square_mask(lo, hi, dev):
    mask = torch.zeros((64, 64), dtype=torch.bool, device=dev)
    mask[lo:hi, lo:hi] = True
    return mask


def flagship_problem(device=None):
    """The flagship's MPC problem: steer the empty board to a block at
    (31, 31) in 8 generations through toggles in ``[24:40, 24:40]``, at the
    default weights."""
    from .core import board as B
    from .mpc import CostWeights, MPCProblem

    dev = _device(device)
    return MPCProblem(initial=B.empty(device=dev), target=_block_target(dev), horizon=8,
                      control_mask=_square_mask(24, 40, dev), weights=CostWeights())


def forward_step(problem):
    """``forward(logits)`` of an MPC problem: logits ``[C, T, 64, 64]`` ->
    (soft costs ``float32[C]``, hard costs ``float32[C]``, final boards
    ``int64[C, 64]``).  The hard costs and finals are the binarized
    controls' exact rollout (kernel [2] on the card)."""
    from .mpc import solver

    def forward(logits):
        soft_costs = solver.soft_objective(logits, problem)
        probs = torch.sigmoid(logits) * problem.control_mask
        hard_costs, finals = solver.hard_score_batch(probs, problem)
        return soft_costs, hard_costs, finals

    return forward


def entry(device=None):
    """(forward, (example_logits,)): the forward step of
    :func:`flagship_problem`.  The example logits are 4 candidates of
    ``init_logits`` from a CPU generator at seed 0, so they are the same
    draw on every device."""
    from .mpc import solver

    problem = flagship_problem(device)
    example_logits = solver.init_logits(torch.Generator().manual_seed(0), problem, 4)
    return forward_step(problem), (example_logits,)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------


def _expect(cond, what):
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def _runners(mesh, n_devices, dev):
    """Every sharded runner once on ``mesh``, on the inputs of an
    ``n_devices`` dry run (they do not depend on the mesh).  Returns the
    known cells of the completion instance and the runners' results by
    name."""
    from .core import board as B
    from .core import rle
    from .mpc import CostWeights
    from .parallel import elite
    from .stable import bitplane as BP
    from .symmetry import transforms as tr

    n_candidate = 2 if n_devices % 2 == 0 else 1
    n_scenario = n_devices // n_candidate
    target, mask = _block_target(dev), _square_mask(28, 36, dev)
    initials = B.empty(device=dev).expand(2 * n_scenario, 64)
    out = {"sweep": elite.sharded_scenario_sweep(
        initials, target, 3, mask, mesh, torch.Generator().manual_seed(0),
        candidates_per_scenario=2 * n_candidate, iters=2, weights=CostWeights())}

    eater = B.move(rle.parse(EATER_RLE, device=dev), 20, 20)
    hide = B.from_cells([(20, 20)], device=dev)
    known, unknown = eater & ~hide, (B.zoi(eater) & ~eater) | hide
    b = 2 * n_devices
    bst = BP.make(state=known.expand(b, 64), unknown=unknown.expand(b, 64))
    out["beam"] = elite.sharded_beam_complete(bst, mesh, frontier=2, iters=6, minimise=True)
    out["beam2"] = elite.sharded_beam_complete(bst, mesh, frontier=2, iters=6, minimise=True,
                                               two_phase=True)
    out["rollout"] = elite.sharded_rollout(eater.expand(b, 64), 4, mesh)

    glider = B.move(rle.parse(GLIDER_RLE, device=dev), 8, 8)
    catalyst = B.move(tr.transform(rle.parse(EATER_RLE, device=dev),
                                   tr.SymmetryTransform.Rotate270), 24, 24)
    offsets = torch.tensor([[dx, dy] for dx in range(-4, 4) for dy in range(-4, 4)],
                           device=dev)
    out["catalyst"] = elite.sharded_catalyst_search(glider, catalyst, offsets, 32, mesh)
    out["portfolio"] = elite.sharded_portfolio(
        known, unknown, torch.Generator().manual_seed(3), mesh, replicas=b, frontier=2,
        iters=12, two_phase=True)
    return known, out


def _is_still_life(board):
    from .core import step as S

    return torch.equal(S.step(board), board)


def _check(known, got, want, n_devices):
    """Every assertion of the JAX dry run: ``got`` from the n-rank mesh,
    ``want`` from the one-rank mesh."""
    from .core import board as B

    n_scenario = n_devices // (2 if n_devices % 2 == 0 else 1)
    b = 2 * n_devices
    (per, champion), (per1, champion1) = got["sweep"], want["sweep"]
    _expect(tuple(per.shape) == (2 * n_scenario,), f"scenario costs of shape {tuple(per.shape)}")
    _expect(torch.allclose(per, per1, **COST_TOL) and torch.allclose(champion, champion1,
                                                                     **COST_TOL),
            f"scenario sweep {per.tolist()} != the one-rank mesh's {per1.tolist()}")

    found, best, pop, champ, champ_pop = got["beam"]
    found1, best1, pop1, _, champ_pop1 = want["beam"]
    _expect(tuple(champ.shape) == (64,), f"beam champion of shape {tuple(champ.shape)}")
    _expect(torch.equal(found, found1) and torch.equal(pop, pop1) and torch.equal(best, best1),
            "beam found / pop / best differ from the one-rank mesh's")
    _expect(int(champ_pop) == int(champ_pop1),
            f"beam champion pop {int(champ_pop)} != the one-rank mesh's {int(champ_pop1)}")
    _expect(_is_still_life(champ) and bool(B.is_empty(known & ~champ)),
            "the beam champion is not a still life keeping the known cells")
    *_, champ2, champ2_pop = got["beam2"]
    _expect(int(champ2_pop) <= int(champ_pop) and _is_still_life(champ2),
            f"two-phase champion pop {int(champ2_pop)} (one pass {int(champ_pop)}) or not a "
            "still life")

    (finals, total), (finals1, total1) = got["rollout"], want["rollout"]
    _expect(tuple(finals.shape) == (b, 64) and int(total) == 7 * b,
            f"rollout population {int(total)} != {7 * b}")
    _expect(torch.equal(finals, finals1) and int(total) == int(total1),
            "rollout differs from the one-rank mesh's")

    (inter, rec, hits), (inter1, rec1, hits1) = got["catalyst"], want["catalyst"]
    _expect(int(hits) == int(hits1) and torch.equal(inter, inter1) and torch.equal(rec, rec1),
            f"catalyst search {int(hits)} hits != the one-rank mesh's {int(hits1)}")

    pf, pf1 = got["portfolio"], want["portfolio"]
    _expect(pf.found and pf1.found and pf.best_pop == pf1.best_pop
            and pf.found_fraction == pf1.found_fraction,
            f"portfolio pop {pf.best_pop} / {pf.found_fraction} != the one-rank mesh's "
            f"{pf1.best_pop} / {pf1.found_fraction}")
    _expect(_is_still_life(pf.best) and bool(B.is_empty(known & ~pf.best)),
            "the portfolio champion is not a still life keeping the known cells")


def _rank_run(rank, world, kind, rendezvous=None):
    """One rank of a dry run over ``world`` ranks: join the group (a new
    world-size-1 group when ``world`` is 1), run every runner on the
    (scenario, candidate) mesh, and tear the group down.  Rank 0 then runs
    the same runners on a mesh of one rank, in a world-size-1 group of its
    own, and checks the two."""
    from .parallel import destroy, initialize_distributed, make_mesh

    if kind == "cuda":
        torch.cuda.set_device(rank)
    elif world > 1:
        torch.set_num_threads(1)  # world ranks share the host's cores
    if world > 1:
        initialize_distributed(rendezvous, world, rank, device=kind)
    dev = torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")
    n_candidate = 2 if world % 2 == 0 else 1
    try:
        known, got = _runners(make_mesh(world // n_candidate, n_candidate, device=kind),
                              world, dev)
    finally:
        destroy()
    if rank == 0:
        try:
            _, want = _runners(make_mesh(1, 1, device=kind), world, dev)
        finally:
            destroy()
        _check(known, got, want, world)


def dryrun_multichip(n_devices, device=None):
    """Run the sharded runners over ``n_devices`` ranks on a (scenario,
    candidate) mesh, ``candidate`` 2 for an even count and 1 for an odd one,
    and hold every result to the same runners on a mesh of one rank:

    * the scenario sweep (horizon 3, 2 candidates a candidate rank, 2
      iterations): costs and champion at rtol 1e-4, atol 1e-5;
    * the beam on 2n copies of the eater with one hidden cell (F = 2, 6
      rounds, minimising): found, best and populations exactly, the
      champion a still life keeping the known cells, and the two-phase
      champion no larger;
    * the rollout of 2n eaters for 4 generations: boards exactly, total
      population 7 x 2n;
    * the catalyst search of a glider against the Rotate270 eater over the
      64 offsets in [-4, 4)^2, horizon 32: flags and hits exactly;
    * the portfolio (2n replicas, F = 2, 12 rounds, two phases): found,
      population and found fraction exactly, the champion a still life.

    One rank runs in this process.  More are spawned, one process a rank,
    meeting on a ``file://`` rendezvous in a temporary directory; with
    CUDA, rank r drives card r over NCCL, and the machine must hold
    ``n_devices`` cards; on the CPU the ranks use gloo.  The dry run makes
    and destroys its own process groups, so none may exist when it is
    called.  Raises on any difference."""
    kind = _device(device).type
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices {n} must be at least 1")
    if kind == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"a dry run over {n} cards, but this machine holds "
                           f"{torch.cuda.device_count()}")
    if dist.is_initialized():
        raise RuntimeError("dryrun_multichip makes its own process groups; destroy the "
                           "existing one first")
    if n == 1:
        _rank_run(0, 1, kind)
        return
    root = str(Path(__file__).resolve().parent.parent)
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = f"file://{tmp}/rendezvous"
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, root, rendezvous, str(n),
                                   str(r), kind],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        logs = []
        try:
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=RANKS_TIMEOUT_S)[0])
                except subprocess.TimeoutExpired:
                    for q in procs:  # a rank hung: stop them all, keep what they said
                        q.kill()
                    logs.append(p.communicate()[0] + "\n(killed at the time limit)")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [(r, log) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0 or f"rank {r} ok" not in log]
    if failed:
        raise RuntimeError("dryrun_multichip: ranks failed:\n" + "\n".join(
            f"rank {r} (exit {procs[r].returncode}):\n{log[-4000:]}" for r, log in failed))


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun ok")
