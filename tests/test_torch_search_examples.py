"""The port's ``examples/complete_still_life``, ``eater_catches_glider`` and
``sharded_portfolio_demo`` on the CPU, with the known answers of the JAX
package's examples: the DFS completes the eater, 13 of 289 placements
catch the glider, and the portfolio's champion is a still life holding the
instance's known cells, at world size 1 and over two spawned gloo ranks."""

import torch

from lifeapi_tpu_torch.core import board
from lifeapi_tpu_torch.examples import (complete_still_life, eater_catches_glider,
                                        sharded_portfolio_demo)
from lifeapi_tpu_torch.parallel import destroy
from lifeapi_tpu_torch.stable.complete import CompletionResult
from torch_threads import one_torch_thread  # noqa: F401


def test_complete_still_life():
    r = complete_still_life.run("cpu")
    assert r["result"] == CompletionResult.COMPLETED
    assert r["eater"] and r["still_life"]


def test_eater_catches_glider():
    r = eater_catches_glider.run("cpu")
    assert r["result"].offsets.shape == (289, 2)
    assert len(r["hits"]) == 13
    assert r["hits"][:5] == [[-8, -4], [-7, -3], [-6, -2], [-5, -1], [-4, 0]]


def test_sharded_portfolio_demo_world_size_one():
    try:
        r = sharded_portfolio_demo.run("cpu", iters=24)
    finally:
        destroy()
    res = r["result"]
    assert r["ranks"] == 1 and res.found and r["still_life"] and r["keeps_state"]
    assert res.best_pop == 7 and res.found_fraction == 1.0
    assert isinstance(res.best, torch.Tensor) and int(board.population(res.best)) == 7


def test_sharded_portfolio_demo_two_ranks(capfd):
    sharded_portfolio_demo.main(["--device", "cpu", "--ranks", "2", "--iters", "24"])
    out = capfd.readouterr().out
    assert "mesh: 2 ranks" in out and "champion population: 7" in out
