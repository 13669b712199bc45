"""The beam-search kernel's plain twin
(``lifeapi_tpu_torch.ops.stable_cuda.beam_search`` on CPU tensors) against
the JAX package's whole-search Pallas kernel in interpret mode
(``complete_stable_beam(fused=True, interpret=True)``).  Exact: found,
best, best_pop and proved inconsistent on every problem."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import rle as jrle
from lifeapi_tpu.stable import bitplane as JBP
from lifeapi_tpu.stable import complete as JC
from lifeapi_tpu.stable import host as H
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.ops import stable_cuda
from lifeapi_tpu_torch.stable import bitplane as BP
from torch_threads import one_torch_thread  # noqa: F401

N = 64


def _eater(hide_cells, ring2):
    eater = jb.move(jrle.parse("2b2o$bobo$bo$2o!"), 20, 20)
    hide = jb.from_cells(hide_cells)
    ring = jb.zoi(jb.zoi(eater)) if ring2 else jb.zoi(eater)
    return eater & ~hide, (ring & ~eater) | hide


def _mixed_problems(rng):
    """The bench problem, a lone ON cell with no unknowns (unsatisfiable)
    and a random block instance."""
    st0, un0 = _eater([(20, 20), (21, 20)], ring2=False)
    lone = jb.from_cells([(40, 40)])
    truth = np.zeros((N, N), bool)
    for _ in range(3):
        x, y = rng.integers(8, 52, 2)
        truth[x:x + 2, y:y + 2] = True
    hide = (rng.random((N, N)) < 0.35) & H.zoi(truth)
    st2 = jb.from_dense(jnp.asarray(truth & ~hide))
    un2 = jb.from_dense(jnp.asarray(hide | (H.zoi(truth) & ~truth)))
    return JBP.make(state=jnp.stack([st0, lone, st2]),
                    unknown=jnp.stack([un0, jnp.zeros_like(lone), un2]))


def _compare(jbst, frontier, iters, minimise, seed=None):
    expect = JC.complete_stable_beam(jbst, frontier=frontier, iters=iters,
                                     minimise=minimise, fused=True, interpret=True,
                                     dense=False, seed=seed)
    planes = BP.to_planes(convert.bitstable_from_jax(jbst, device="cpu")).contiguous()
    tseed = None if seed is None else convert.board_from_packed(seed, device="cpu").contiguous()
    best, best_pop, found, complete, exhausted = stable_cuda.beam_search(
        planes, frontier=frontier, iters=iters, minimise=minimise, seed=tseed)
    assert (expect.found == found.numpy()).all()
    assert (expect.best_pop == best_pop.numpy()).all()
    assert (expect.best == convert.board_to_packed(best)).all()
    proved = exhausted & complete & ~found
    assert (expect.proved_inconsistent == proved.numpy()).all()
    return found, proved


@pytest.mark.parametrize("minimise", [True, False])
def test_beam_twin_matches_pallas(rng, minimise):
    found, proved = _compare(_mixed_problems(rng), frontier=4, iters=10,
                             minimise=minimise)
    assert found[0] and not found[1] and proved[1]


def test_seeded_beam_twin_matches_pallas():
    st, un = _eater([(20, 20), (21, 20), (22, 21)], ring2=True)
    jbst = JBP.make(state=jnp.broadcast_to(st, (3, 64, 2)),
                    unknown=jnp.broadcast_to(un, (3, 64, 2)))
    _compare(jbst, frontier=4, iters=10, minimise=True,
             seed=jnp.broadcast_to(st, (3, 64, 2)))


def test_first_cell_mask_of_the_top_bit():
    assert torch.equal(stable_cuda.first_cell_mask(torch.tensor([[0] * 63 + [-2**63]])),
                       torch.tensor([[0] * 63 + [-2**63]]))
