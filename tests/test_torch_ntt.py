"""The port's number-theoretic transform (``lifeapi_tpu_torch.core.ntt``),
the one definition of the primes, twiddles and CRT inverse that the dense
counts kernels, their plain twins and ``convolve``'s ``method="ntt"`` share:
its constants against the JAX package's, its exactness argument stage by
stage, and the twins against the packed kernel's popcount formula, bit for
bit."""

import numpy as np
import pytest
import torch

from lifeapi_tpu.core import convolve as jconv
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.core import convolve as conv
from lifeapi_tpu_torch.core import ntt
from lifeapi_tpu_torch.ops import conv_cuda
from torch_threads import one_torch_thread  # noqa: F401


def test_constants_match_the_jax_package():
    assert ntt.PRIMES == jconv._NTT_PRIMES
    for p, (w, v) in zip(ntt.PRIMES, jconv._ntt_matrices()):
        assert np.array_equal(ntt.matrix(p, False, device="cpu").numpy(), np.asarray(w))
        assert np.array_equal(ntt.matrix(p, True, device="cpu").numpy(), np.asarray(v))
    p1, p2 = ntt.PRIMES
    assert p1 * ntt.CRT_INVERSE % p2 == 1
    assert p1 * p2 > 64 * 64  # the CRT holds every count


@pytest.mark.parametrize("p", ntt.PRIMES)
def test_matrices_are_symmetric_inverses(p):
    w, v = ntt.matrix(p, False, device="cpu"), ntt.matrix(p, True, device="cpu")
    assert torch.equal(w, w.T) and torch.equal(v, v.T)
    assert torch.equal(w @ v % p, torch.eye(64, dtype=torch.int64))


def test_kernel_twiddles_are_the_matrices_exactly():
    """The kernels' bf16 twiddles hold W and V of each prime without
    rounding: every entry is below 257."""
    tw = conv_cuda._twiddles(torch.device("cpu"))
    assert tw.dtype == torch.bfloat16 and tw.shape == (4, 64, 64)
    want = torch.stack([ntt.matrix(p, inverse, device="cpu") for p in ntt.PRIMES
                        for inverse in (False, True)])
    assert torch.equal(tw.to(torch.int64), want)
    assert int(want.max()) <= 256


def _dense_pairs(rng):
    """p=0.5 pairs, an all-ON pair and a sparse operand against a dense one."""
    da = rng.random((4, 64, 64)) < 0.5
    db = rng.random((4, 64, 64)) < 0.5
    da[0] = db[0] = True
    db[3] = False
    db[3, rng.integers(0, 64, 9), rng.integers(0, 64, 9)] = True
    return torch.from_numpy(da), torch.from_numpy(db)


def test_every_stage_stays_exact(rng, monkeypatch):
    """Every value the transform reduces is an integer in [0, 2**24), the
    range f32 accumulation holds exactly, and every reduced value lies in
    [0, p), so it is exact in bf16 (at most 256)."""
    seen, reduce = [], ntt.reduce

    def spy(x, p):
        r = reduce(x, p)
        seen.append((p, x, r))
        return r

    monkeypatch.setattr(ntt, "reduce", spy)
    da, db = _dense_pairs(rng)
    got = conv_cuda.conv_counts_fused_plain(da, db)
    assert int(got[0].min()) == 4096
    # per prime: both forward transforms (2 stages each), the product, the
    # inverse transform (2 stages)
    assert len(seen) == 2 * 7
    for p, x, r in seen:
        assert bool((x == torch.round(x)).all())
        assert float(x.min()) >= 0 and float(x.max()) < 2**24
        assert int(r.min()) >= 0 and int(r.max()) < p <= 257
    assert max(float(x.max()) for _, x, _ in seen) > 2**16  # the bound is exercised


def test_twins_equal_the_popcount_formula(rng):
    """The NTT twins, the packed one included, against the popcount
    formula, bit for bit, on counts above 257 and on all-ON pairs (every
    count 4096)."""
    da, db = _dense_pairs(rng)
    packed = conv_cuda.packed_counts_plain(tb.from_dense(da), tb.from_dense(db))
    counts = conv_cuda.conv_counts_fused_plain(da, db)
    assert counts.dtype == torch.int32 and torch.equal(counts, packed)
    assert int(packed[1:3].max()) > 257 and bool((packed[0] == 4096).all())
    residue = conv_cuda.conv_small_fused_plain(da, db, out_or=False)
    assert torch.equal(residue, packed % 193)
    mask = conv_cuda.conv_small_fused_plain(da, db)
    assert mask.dtype == torch.int8 and torch.equal(mask, (packed % 193 != 0).to(torch.int8))
    boards = conv_cuda.conv_small_packed_plain(tb.from_dense(da), tb.from_dense(db))
    assert torch.equal(boards, tb.from_dense(packed % 193 != 0))


def test_ntt_route_of_convolve_counts_is_the_twin(rng):
    """``convolve_counts(method="ntt")`` and the dense counts kernel's twin
    run the same transform."""
    da, db = _dense_pairs(rng)
    a, b = tb.from_dense(da), tb.from_dense(db)
    assert torch.equal(conv.convolve_counts(a, b, method="ntt"),
                       conv_cuda.conv_counts_fused_plain(da, db))
