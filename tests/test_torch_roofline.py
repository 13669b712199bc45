"""The port's operation counters (``lifeapi_tpu_torch.utils.roofline``)
against :mod:`lifeapi_tpu.utils.roofline`: the dedup / dead-code case of
``tests/test_utils.py`` with its numbers, the same functions counted by
both packages (equal counts: one lane-op a 32-bit element), the matmul
FLOP of one product, and the canned counts over the kernels' plain
circuits, pinned."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifeapi_tpu.utils import roofline as JR
from lifeapi_tpu_torch.utils import roofline as R
from torch_threads import one_torch_thread  # noqa: F401

# per-board counts of the plain circuits (pre-CSE, post-CSE)
STEP_LANE_OPS = (3968, 3968)
FIXPOINT_STEP_LANE_OPS = (57472, 42112)
SIMPLE_STEP_LANE_OPS = (32896, 23680)


def dup(x, y):
    a = x & y
    b = y & x  # commuted duplicate
    dead = x ^ y  # dead code
    del dead
    return a | b


def clean(x, y):
    return (x & y) | (x ^ y)


def shifts(x, y):
    return ((x << 3) ^ (y >> 2)) + (x & 7) * y


def test_lane_ops_cse_dedups_and_dces():
    """The JAX test's case on int32[64, 8], with its numbers: the dead op
    counted before CSE, one AND and one OR after."""
    e = torch.zeros(64, 8, dtype=torch.int32)
    assert R.lane_ops(dup, e, e) == 4 * 64 * 8
    assert R.lane_ops_cse(dup, e, e) == 2 * 64 * 8
    assert R.lane_ops(clean, e, e) == R.lane_ops_cse(clean, e, e) == 3 * 64 * 8


@pytest.mark.parametrize("fn", [dup, clean, shifts], ids=lambda f: f.__name__)
def test_counts_equal_jax(fn):
    """One elementwise function, counted by both packages on 32-bit words,
    gives one count before CSE and one after."""
    rng = np.random.default_rng(0)
    x, y = (rng.integers(0, 2**31, (64, 8)).astype(np.int32) for _ in range(2))
    jx, jy = jnp.asarray(x.view(np.uint32)), jnp.asarray(y.view(np.uint32))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert R.lane_ops(fn, tx, ty) == JR.lane_ops(fn, jx, jy)
    assert R.lane_ops_cse(fn, tx, ty) == JR.lane_ops_cse(fn, jx, jy)


def test_int64_elements_count_two_lane_ops():
    e = torch.zeros(64, 8, dtype=torch.int64)
    assert R.lane_ops(clean, e, e) == 2 * 3 * 64 * 8


def test_matmul_flops_equal_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 64)).astype(np.float32)
    b = rng.normal(size=(64, 8)).astype(np.float32)
    want = JR.matmul_flops(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    assert want == 2 * 64 * 8 * 64
    assert R.matmul_flops(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b)) == want
    batched = torch.zeros(3, 64, 16)
    assert R.matmul_flops(torch.bmm, batched, torch.zeros(3, 16, 8)) == 3 * 2 * 64 * 8 * 16


def test_compiled_cost_analysis_keys():
    a, b = torch.ones(64, 64), torch.ones(64, 8)
    cost = R.compiled_cost_analysis(lambda x, y: x @ y, a, b)
    assert cost == {"flops": 2.0 * 64 * 8 * 64, "bytes accessed": 4.0 * (64 * 64 + 64 * 8 * 2)}


def test_step_count_has_no_cse_redundancy():
    """The plain step of [1] and [4] counts the same before and after CSE
    (the JAX step kernel's count, a different circuit on half-words, is
    3328)."""
    pre = R.step_lane_ops_per_board(device="cpu")
    post = R.step_lane_ops_per_board(post_cse=True, device="cpu")
    print(f"port step {pre} / {post} lane-ops a board; JAX's step_eo "
          f"{JR.step_lane_ops_per_board()}")
    assert (pre, post) == STEP_LANE_OPS


def test_fixpoint_and_simple_step_counts():
    fix = (R.fixpoint_step_lane_ops_per_board(device="cpu"),
           R.fixpoint_step_lane_ops_per_board(post_cse=True, device="cpu"))
    simple = (R.simple_step_lane_ops_per_board(device="cpu"),
              R.simple_step_lane_ops_per_board(post_cse=True, device="cpu"))
    assert fix == FIXPOINT_STEP_LANE_OPS and fix[1] < fix[0]
    assert simple == SIMPLE_STEP_LANE_OPS and simple[1] < simple[0]


def test_no_card_no_peak(monkeypatch):
    """Without CUDA the peak raises instead of falling back to a constant,
    and the counters default to the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        R.card_issue_peak()
    with pytest.raises(RuntimeError):
        R.pct_of_peak(1e12)
    with pytest.raises(RuntimeError):
        R.step_lane_ops_per_board()
    assert R.pct_of_peak(1e12, peak=4e12) == 25.0
