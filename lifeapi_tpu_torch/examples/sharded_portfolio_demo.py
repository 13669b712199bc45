"""One HARD still-life instance scaled over a device mesh (the port of
``examples/sharded_portfolio_demo.py``).

:func:`~lifeapi_tpu_torch.parallel.elite.sharded_portfolio` shards
orbit-randomized beam replicas of a single completion problem over every
rank, exchanges the champion with pmin/psum collectives, and feeds its
population back as a branch-and-bound incumbent for a second bounded pass
on every rank (SURVEY.md section 2.8 composed with the reference's deep
DFS, LifeStable.hpp:1340-1458).

    python -m lifeapi_tpu_torch.examples.sharded_portfolio_demo [--device cpu] [--ranks N]

On the card it runs at world size 1 over NCCL.  ``--ranks N`` (with
``--device cpu``) spawns N processes joined over gloo, as many ranks as a
multi-device mesh would have.
"""

from __future__ import annotations

import argparse
import multiprocessing
import tempfile
from pathlib import Path

import torch

from ..core import board, rle
from ..parallel import elite, mesh
from . import life_step_dense, resolve_device

EATER_RLE = "2b2o$bobo$bo$2o!"


def instance(device):
    """An eater with two cells knocked out and a ring of unknowns: the
    search must rediscover a stable background.  Returns (state, unknown)."""
    eater = board.move(rle.parse(EATER_RLE, device=device), 20, 20)
    hide = board.from_cells([(20, 20), (21, 20)], device=device)
    return eater & ~hide, (board.zoi(eater) & ~eater) | hide


def run(device, replicas_per_rank=8, frontier=4, iters=48, seed=0):
    """The portfolio over the mesh of every rank of this process's group
    (a world-size-1 group is started if there is none; the caller tears it
    down with :func:`lifeapi_tpu_torch.parallel.destroy`).  Returns a dict
    with the result, the mesh size and an independent numpy check."""
    device = torch.device(device)
    m = mesh.make_mesh(device=device)
    state, unknown = instance(device)
    res = elite.sharded_portfolio(state, unknown, torch.Generator().manual_seed(seed), m,
                                  replicas=replicas_per_rank * m.size(), frontier=frontier,
                                  iters=iters, two_phase=True)
    dense = board.to_dense(res.best).cpu().numpy()
    return {"result": res, "ranks": m.size(),
            "still_life": bool((life_step_dense(dense) == dense).all()),
            "keeps_state": bool(board.is_empty(state & ~res.best))}


def _report(r):
    res = r["result"]
    if not (res.found and r["still_life"] and r["keeps_state"]):
        raise RuntimeError("the portfolio found no still life completing the instance")
    print(f"mesh: {r['ranks']} ranks")
    print(f"champion population: {res.best_pop} "
          f"(replica success rate {res.found_fraction:.0%})")
    print(rle.to_rle(res.best))


def _rank_main(rank, ranks, rendezvous, kwargs):
    """One spawned CPU rank: join the gloo group, run, and report on rank 0."""
    torch.set_num_threads(1)
    mesh.initialize_distributed(rendezvous, ranks, rank, device="cpu")
    try:
        r = run("cpu", **kwargs)
        if rank == 0:
            _report(r)
    finally:
        mesh.destroy()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ranks", type=int, default=1,
                        help="CPU processes to spawn (needs --device cpu)")
    parser.add_argument("--iters", type=int, default=48)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    kwargs = {"iters": args.iters}
    if args.ranks == 1:
        try:
            _report(run(device, **kwargs))
        finally:
            mesh.destroy()
        return
    if device.type != "cpu":
        raise SystemExit("--ranks N spawns CPU processes: pass --device cpu")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = f"file://{Path(tmp) / 'rendezvous'}"
        procs = [ctx.Process(target=_rank_main, args=(r, args.ranks, rendezvous, kwargs))
                 for r in range(args.ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise SystemExit(f"ranks {failed} failed")


if __name__ == "__main__":
    main()
