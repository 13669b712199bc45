"""The port's closed-form rules (``lifeapi_tpu_torch.stable.rules_vec``) and
ternary stepping (``stable.ternary``) against :mod:`lifeapi_tpu.stable.rules_vec`
and :mod:`lifeapi_tpu.stable.ternary`: exhaustively over every (center,
on9, unk9) a window can produce, with every options mask for the rules
that take one.  Bit-exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.stable import options as jopt
from lifeapi_tpu.stable import rules_vec as JR
from lifeapi_tpu.stable import ternary as JT
from lifeapi_tpu_torch.stable import rules_vec as R
from lifeapi_tpu_torch.stable import ternary as T
from oracle import random_dense
from torch_threads import one_torch_thread  # noqa: F401


def _grid(with_masks):
    """Every window the rules can see, as numpy int arrays (center, on9,
    unk9[, ruled mask])."""
    combos = [(c, o, u) for c in (jopt.OFF, jopt.ON, jopt.UNKNOWN)
              for o in range(10) for u in range(10 - o)
              if (nc := jopt._neighbour_counts(c, o, u)) is not None and sum(nc) <= 8]
    cols = np.array(combos, dtype=np.int32).T
    if not with_masks:
        return tuple(cols)
    masks = np.arange(256, dtype=np.uint8)
    rep = [np.repeat(c, 256) for c in cols]
    return (*rep, np.tile(masks, len(combos)))


def _both(fn_j, fn_t, *args):
    got = fn_t(*(torch.from_numpy(a) for a in args))
    want = fn_j(*(jnp.asarray(a) for a in args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert (g.numpy() == w).all()


def test_update_bits():
    _both(JR.update_bits, R.update_bits, *_grid(False))


def test_simple_bits():
    _both(JR.simple_bits, R.simple_bits, *_grid(False))


@pytest.mark.parametrize("naive", [False, True])
def test_ternary_code(naive):
    _both(lambda *a: JR.ternary_code(*a, naive=naive),
          lambda *a: R.ternary_code(*a, naive=naive), *_grid(False))


def test_signal_bits():
    center, on9, unk9, mask = _grid(True)
    _both(JR.signal_bits, R.signal_bits, center, mask, on9, on9 + unk9)


def test_vulnerable_bits():
    center, on9, unk9, mask = _grid(True)
    _both(JR.vulnerable_bits, R.vulnerable_bits, center, mask, on9, unk9)


@pytest.mark.parametrize("naive", [False, True])
def test_step_ternary(rng, naive):
    state = random_dense(rng, p=0.3, batch=(4,))
    unknown = random_dense(rng, p=0.2, batch=(4,)) & ~state
    for n in (1, 5):
        js, ju = JT.step_ternary_n(jnp.asarray(state), jnp.asarray(unknown), n, naive=naive)
        ts, tu = T.step_ternary_n(torch.from_numpy(state), torch.from_numpy(unknown), n,
                                  naive=naive)
        assert (ts.numpy() == np.asarray(js)).all() and (tu.numpy() == np.asarray(ju)).all()
    js, ju = JT.step_ternary(jnp.asarray(state), jnp.asarray(unknown), naive=naive)
    ts, tu = T.step_ternary(torch.from_numpy(state), torch.from_numpy(unknown), naive=naive)
    assert (ts.numpy() == np.asarray(js)).all() and (tu.numpy() == np.asarray(ju)).all()
