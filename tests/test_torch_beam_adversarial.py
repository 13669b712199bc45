"""The adversarial beam-vs-DFS sweep (``tests/test_beam_adversarial.py``)
on the port: the JAX test's 224 instances at seed 0 through the port's
``complete_stable_beam`` (the plain twin of kernel [10] on the CPU,
frontier 8, 96 rounds) and the port's raw host DFS, with the four
properties of ``tests/torch_beam_sweep.py``, and the beam's ``found`` and
``proved_inconsistent`` equal to the JAX beam's on the same instances."""

import jax.numpy as jnp
import numpy as np
import torch

from lifeapi_tpu.stable import complete as JC
from lifeapi_tpu.stable import propagate as JP
from lifeapi_tpu_torch.stable import complete as C
from lifeapi_tpu_torch.stable import propagate as P
from test_beam_adversarial import _instances
from torch_beam_sweep import (FRONTIER, ITERS, N_INSTANCES, SEED, check_sweep, dfs_verdicts,
                              sweep_instances)
from torch_threads import one_torch_thread  # noqa: F401


def test_beam_vs_dfs_adversarial_sweep():
    states, unknowns = sweep_instances()
    want_states, want_unknowns = _instances(np.random.default_rng(SEED), N_INSTANCES)
    assert np.array_equal(states, want_states) and np.array_equal(unknowns, want_unknowns)

    st = P.make(state=torch.from_numpy(states), unknown=torch.from_numpy(unknowns))
    res = C.complete_stable_beam(st, frontier=FRONTIER, iters=ITERS, minimise=False)
    found, proved = res.found.numpy(), res.proved_inconsistent.numpy()
    n_found, n_proved = check_sweep(states, unknowns, found, res.best.numpy(), proved,
                                    dfs_verdicts(states, unknowns))
    print(f"{n_found} finds, {n_proved} proofs of {N_INSTANCES}")

    jst = JP.make(state=jnp.asarray(states), unknown=jnp.asarray(unknowns))
    jres = JC.complete_stable_beam(jst, frontier=FRONTIER, iters=ITERS, minimise=False)
    assert np.array_equal(found, np.asarray(jres.found))
    assert np.array_equal(proved, np.asarray(jres.proved_inconsistent))
