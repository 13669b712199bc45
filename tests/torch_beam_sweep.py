"""The adversarial beam-vs-DFS sweep of ``tests/test_beam_adversarial.py``
for the port: its instance generator, the host DFS verdicts and the four
properties the sweep asserts.  Imports torch, numpy and the port only, so
``chip_smoke.py`` runs the same sweep through kernel [10] on the card.

The four properties, for every instance:

1. a beam find is a still life (an independent numpy Life step) that keeps
   the instance's known ON cells and lies inside state | unknown;
2. a proved inconsistency is one the host DFS (the raw recursion,
   ``complete._Search.step``, the reference ``CompleteStableStep``) also
   returns;
3. an instance the DFS completes is never proved inconsistent;
4. the sweep is not vacuous: at least ``MIN_EACH`` finds and proofs.
"""

import time

import numpy as np

from lifeapi_tpu_torch.core import rle
from lifeapi_tpu_torch.examples import life_step_dense
from lifeapi_tpu_torch.stable import complete as C
from lifeapi_tpu_torch.stable import host as H

N = 64
N_INSTANCES, SEED = 224, 0
FRONTIER, ITERS = 8, 96
DFS_SECONDS = 10.0
MIN_EACH = 40

STILL_LIFES = [
    "2o$2o!",            # block
    "2b2o$bobo$bo$2o!",  # eater
    "b2o$o2bo$b2o!",     # beehive
    "bo$obo$bo!",        # tub
    "2o$obo$bo!",        # boat
    "b2o$o2bo$bobo$2bo!",  # loaf
    "b2o$o2bo$o2bo$b2o!",  # pond
]


def instances(rng, n):
    """The JAX test's ``_instances``, draw for draw: n random instances,
    (state bool[n, 64, 64], unknown bool[n, 64, 64]).  Small still lifes
    at random places with hidden cells and a repair ring, or with a
    spurious ON cell far from or inside their ring."""
    pats = [rle.parse_dense(s) for s in STILL_LIFES]
    states, unknowns = [], []
    for _ in range(n):
        pat = pats[rng.integers(len(pats))]
        dx, dy = rng.integers(8, 48, 2)
        truth = np.roll(np.roll(pat, dx, axis=0), dy, axis=1)
        kind = rng.integers(3)
        if kind == 0:
            hide = (rng.random((N, N)) < 0.35) & H.zoi(truth)
            state = truth & ~hide
            unknown = hide | (H.zoi(truth) & ~truth)
        elif kind == 1:
            state = truth.copy()
            x, y = rng.integers(8, 48, 2)
            state[(dx + 20 + x) % N, (dy + 20 + y) % N] = True
            unknown = (H.zoi(truth) & ~state) if rng.random() < 0.5 else (
                np.zeros((N, N), bool)
            )
        else:
            state = truth.copy()
            ring = H.zoi(H.zoi(truth)) & ~truth
            xs, ys = np.nonzero(ring)
            j = rng.integers(len(xs))
            state[xs[j], ys[j]] = True
            unknown = H.zoi(H.zoi(state)) & ~state
            unknown &= rng.random((N, N)) < 0.6
        unknown &= ~state
        states.append(state)
        unknowns.append(unknown)
    return np.stack(states), np.stack(unknowns)


def sweep_instances():
    return instances(np.random.default_rng(SEED), N_INSTANCES)


def dfs_verdicts(states, unknowns):
    """The raw host DFS's verdict on every instance.  The ``complete_stable``
    wrapper is not a fair oracle: it returns COMPLETED for an instance with
    no unknown cell without checking that it is stable, where the beam
    propagates and proves such an instance inconsistent."""
    out = []
    for state, unknown in zip(states, unknowns):
        search = C._Search(time.monotonic() + DFS_SECONDS, False, False,
                           np.zeros((N, N), bool))
        r = search.step(H.HostStable(state=state, unknown=unknown))
        if r == C.CompletionResult.COMPLETED and search.best is None:
            r = C.CompletionResult.INCONSISTENT  # cannot happen with no bound
        out.append(r)
    return out


def _expect(cond, what):
    if not cond:
        raise AssertionError(what)


def check_sweep(states, unknowns, found, best, proved, dfs):
    """The four properties; ``found``, ``proved`` bool[n] and ``best``
    bool[n, 64, 64] (numpy) from the beam.  Returns (finds, proofs)."""
    for i, verdict in enumerate(dfs):
        _expect(verdict != C.CompletionResult.TIMEOUT, f"DFS timeout @ {i}")
        if found[i]:
            _expect((life_step_dense(best[i]) == best[i]).all(), f"not a still life @ {i}")
            _expect((best[i] & states[i] == states[i]).all(), f"a known cell lost @ {i}")
            _expect(not (best[i] & ~(states[i] | unknowns[i])).any(),
                    f"a cell outside state | unknown @ {i}")
        if proved[i]:
            _expect(verdict == C.CompletionResult.INCONSISTENT,
                    f"unsound inconsistency proof @ {i}")
        if verdict == C.CompletionResult.COMPLETED:
            _expect(not proved[i], f"a completable instance proved inconsistent @ {i}")
    n_found, n_proved = int(np.sum(found)), int(np.sum(proved))
    _expect(n_found >= MIN_EACH and n_proved >= MIN_EACH,
            f"a vacuous sweep: {n_found} finds, {n_proved} proofs")
    return n_found, n_proved
