"""The port's ``examples/portfolio_minimise`` against the JAX package's
``complete_stable_portfolio`` on the same two-anchor instance, at the JAX
example's size (128 replicas, frontier 4, 96 iterations, re-minimise on),
with JAX's translations handed to the port through ``draw_offsets``."""

import jax
import numpy as np

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.stable import complete as JC
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.examples import portfolio_minimise
from test_torch_portfolio import _jax_draws, use_jax_draws
from torch_threads import one_torch_thread  # noqa: F401

REPLICAS, ITERS = 128, 96


def test_portfolio_example_equals_jax(monkeypatch):
    a = jb.from_cells(list(portfolio_minimise.ANCHORS))
    key = jax.random.key(0)
    want = JC.complete_stable_portfolio(a, jb.zoi(jb.zoi(a)) & ~a, key, replicas=REPLICAS,
                                        frontier=4, iters=ITERS, fused=False)
    use_jax_draws(monkeypatch, _jax_draws(key, REPLICAS))
    r = portfolio_minimise.run("cpu", replicas=REPLICAS, iters=ITERS)
    got = convert.portfolio_result_to_numpy(r["result"])
    assert got["found"] and want.found
    assert got["best_pop"] == want.best_pop == 6  # the barge: no smaller one holds both
    assert got["found_fraction"] == want.found_fraction
    assert (got["best"] == np.asarray(want.best)).all()
    assert r["still_life"] and r["anchors_on"] and r["inside_area"]
