"""Spawned gloo ranks run all seven sharded runners, and every rank's
results equal a world-size-1 run of the same calls (as
``__graft_entry__.dryrun_multichip`` holds the JAX package's runners to a
one-device mesh): boards, flags, counts and populations exactly, float32
costs at rtol 1e-4 / atol 1e-5.  Two ranks on a (2, 1) and a (1, 2) mesh;
four on a (2, 2) mesh, the one shape where both dimensions' groups hold
more than one rank.

The ranks join through ``initialize_distributed`` on a ``file://``
rendezvous under the test's own directory, so parallel test workers never
race for a TCP port.  The world-size-1 run uses an in-process store.
"""

import json
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from torch_parallel_cases import assert_same, run_all
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240

WORKER = textwrap.dedent(
    """
    import json, pickle, sys
    sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
    import torch
    torch.set_num_threads(1)
    from lifeapi_tpu_torch.parallel import destroy, initialize_distributed, make_mesh
    from torch_parallel_cases import run_all

    rendezvous, out, world, rank = sys.argv[2], sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
    shapes = [tuple(s) for s in json.loads(sys.argv[6])]
    initialize_distributed(rendezvous, world, rank, device="cpu")
    try:
        results = {}
        for shape in shapes:
            mesh = make_mesh(*shape, device="cpu")
            assert tuple(mesh.shape) == shape and mesh.size() == world
            results[shape] = run_all(mesh)
    finally:
        destroy()
    with open(out, "wb") as f:
        pickle.dump(results, f)
    print(f"rank {rank} ok", flush=True)
    """
)


@pytest.fixture(scope="module")
def world_size_one():
    from lifeapi_tpu_torch.parallel import destroy, make_mesh

    try:
        yield run_all(make_mesh(device="cpu"))
    finally:
        destroy()


@pytest.mark.parametrize("world,shapes", [(2, ((2, 1), (1, 2))), (4, ((2, 2),))],
                         ids=["2 ranks", "4 ranks"])
def test_gloo_ranks_equal_world_size_one(tmp_path, world_size_one, world, shapes):
    rendezvous = f"file://{tmp_path / 'rendezvous'}"
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(ROOT), rendezvous,
                               str(outs[r]), str(world), str(r), json.dumps(shapes)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:  # a rank hung: stop them all and report what they said
                q.kill()
            logs.append(p.communicate()[0])
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {r} ok" in log, f"rank {r}:\n{log[-4000:]}"
    for out in outs:
        results = pickle.loads(out.read_bytes())
        assert set(results) == set(shapes)
        for shape in shapes:
            assert_same(results[shape], world_size_one)
