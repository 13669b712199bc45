"""The convolution and calibration wrappers of ``lifeapi_tpu_torch.ops`` on
CPU tensors (their plain twins) against the JAX package's Pallas kernels,
run in interpret mode as ``tests/test_convolve.py`` and
``tests/test_calibrate.py`` run them.  Bit-exact: every path is integer.
The CUDA kernels themselves are tested on the card by
``tests/test_torch_cuda_kernels.py``."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import convolve as jconv
from lifeapi_tpu.ops import calibrate_pallas as CAL
from lifeapi_tpu.ops import conv_pallas as CP
from lifeapi_tpu.ops import conv_sparse_pallas as CSP
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.ops import calibrate_cuda, conv_cuda
from torch_threads import one_torch_thread  # noqa: F401


def _packed(dense):
    return jb.from_dense(jnp.asarray(dense))


def _sparse_dense(rng, batch, k_max):
    """Boards of 0..k_max random cells each; board 0 stays empty."""
    d = np.zeros((batch, 64, 64), bool)
    for i in range(1, batch):
        k = int(rng.integers(1, k_max + 1))
        d[i, rng.integers(0, 64, k), rng.integers(0, 64, k)] = True
    return d


def _peel_operands(rng):
    """a: random p=0.3 boards; b: an empty operand, sparse operands and a
    denser one (about 200 cells), whose counts pass 63."""
    da = rng.random((6, 64, 64)) < 0.3
    db = _sparse_dense(rng, 6, 12)
    db[5] = rng.random((64, 64)) < 0.05
    return da, db


def test_convolve_sparse_fused_matches_pallas(rng):
    da, db = _peel_operands(rng)
    expect = CSP.convolve_sparse_fused(_packed(da), _packed(db), interpret=True)
    got = conv_cuda.convolve_sparse_fused(tb.from_dense(torch.from_numpy(da)),
                                          tb.from_dense(torch.from_numpy(db)))
    assert (convert.board_to_packed(got) == np.asarray(expect)).all()
    assert (got[0] == 0).all()  # empty operand


def test_convolve_sparse_fused_broadcasts(rng):
    da, db = _peel_operands(rng)
    a = tb.from_dense(torch.from_numpy(da[1]))
    b = tb.from_dense(torch.from_numpy(db))
    expect = CSP.convolve_sparse_fused(_packed(da[1]), _packed(db), interpret=True)
    got = conv_cuda.convolve_sparse_fused(a, b)
    assert got.shape == (6, 64)
    assert (convert.board_to_packed(got) == np.asarray(expect)).all()


@pytest.mark.parametrize("n_planes", [1, 6, 13])
def test_counts_sparse_fused_matches_pallas(rng, n_planes):
    da, db = _peel_operands(rng)
    expect = CSP.counts_sparse_fused(_packed(da), _packed(db), n_planes=n_planes,
                                     interpret=True)
    got = conv_cuda.counts_sparse_fused(tb.from_dense(torch.from_numpy(da)),
                                        tb.from_dense(torch.from_numpy(db)),
                                        n_planes=n_planes)
    assert len(got) == len(expect) == n_planes
    for g, e in zip(convert.planes_to_packed(got), expect):
        assert (g == np.asarray(e)).all()
    assert all(torch.equal(g, e) for g, e in zip(got, convert.planes_from_packed(expect, device="cpu")))
    exact = conv_cuda.conv_counts_fused(torch.from_numpy(da), torch.from_numpy(db))
    counts = sum(tb.to_dense(p).to(torch.int32) << i for i, p in enumerate(got))
    assert torch.equal(counts, exact % (1 << n_planes))  # wraps mod 2**n_planes
    if n_planes == 6:
        assert int(exact.max()) > 63


def _union_pair_operands(rng, n_pairs):
    """n_pairs (left, right) pairs of 4 boards each: empty boards on either
    side, each side the smaller on some board, and a right side of about 200
    cells against a sparse left."""
    pairs = []
    for k in range(n_pairs):
        left = _sparse_dense(rng, 4, 10)
        right = rng.random((4, 64, 64)) < 0.05
        right[k % 4] = False
        left[(k + 1) % 4] = rng.random((64, 64)) < 0.3
        pairs.append((left, right) if k % 2 else (right, left))
    return pairs


@pytest.mark.parametrize("n_pairs", [1, 7])
def test_union_sparse_fused_matches_pallas_union(rng, monkeypatch, n_pairs):
    """The union peel against the JAX package's union_interacting(method=
    "sparse") on its TPU route, the stacked Pallas peel with the per-lane
    swap, run in interpret mode."""
    monkeypatch.setattr(jconv, "_prefer_ntt", lambda: True)
    monkeypatch.setattr(CSP, "convolve_sparse_fused",
                        functools.partial(CSP.convolve_sparse_fused, interpret=True))
    pairs = _union_pair_operands(rng, n_pairs)
    expect = jconv.union_interacting([(_packed(l), _packed(r)) for l, r in pairs],
                                     method="sparse")
    tpairs = [(tb.from_dense(torch.from_numpy(l)), tb.from_dense(torch.from_numpy(r)))
              for l, r in pairs]
    got = conv_cuda.union_sparse_fused(tpairs)
    assert got.shape == (4, 64)
    assert (convert.board_to_packed(got) == np.asarray(expect)).all()


def test_conv_counts_fused_matches_pallas(rng):
    da = rng.random((4, 64, 64)) < 0.5
    db = rng.random((4, 64, 64)) < 0.5
    da[3] = db[3] = True  # all ones: every count is 4096
    expect = np.asarray(CP.conv_counts_fused(jnp.asarray(da), jnp.asarray(db),
                                             interpret=True))
    got = conv_cuda.conv_counts_fused(torch.from_numpy(da), torch.from_numpy(db))
    assert got.dtype == torch.int32
    assert (got.numpy() == expect).all()
    assert (expect[3] == 4096).all() and expect[:3].max() > 257  # the CRT matters


def _edge_pairs(rng):
    """An all-OFF pair, a single cell against a single cell, and single cells
    against p=0.5 boards (the counts are the board translated by the cell)."""
    da = np.zeros((4, 64, 64), bool)
    db = rng.random((4, 64, 64)) < 0.5
    db[0] = False
    cells = [(0, 0), (17, 63), (63, 5), (40, 22)]
    for i, (x, y) in enumerate(cells):
        da[i, x, y] = True
    db[1] = False
    db[1, 63, 63] = True
    return da, db, cells


@pytest.mark.parametrize("kernel", ["counts", "residue", "mask"])
def test_dense_counts_edge_pairs_match_pallas(rng, kernel):
    da, db, cells = _edge_pairs(rng)
    ta, tdb = torch.from_numpy(da), torch.from_numpy(db)
    if kernel == "counts":
        expect = CP.conv_counts_fused(jnp.asarray(da), jnp.asarray(db), interpret=True)
        got = conv_cuda.conv_counts_fused(ta, tdb)
    else:
        out_or = kernel == "mask"
        expect = CP.conv_small_fused(jnp.asarray(da), jnp.asarray(db), out_or=out_or,
                                     interpret=True)
        got = conv_cuda.conv_small_fused(ta, tdb, out_or=out_or)
    assert (got.numpy() == np.asarray(expect)).all()
    assert int(got[0].max()) == 0
    assert int(got[1].sum()) == 1 and int(got[1, 16, 62]) == 1  # (17, 63) + (63, 63)
    for i in (2, 3):  # a single cell translates the other board
        x, y = cells[i]
        moved = tb.to_dense(tb.move(tb.from_dense(tdb[i]), x, y))
        assert torch.equal(got[i] != 0, moved)


def test_dense_counts_take_any_non_zero_byte_as_on(rng):
    """Bytes other than 1 (unsigned and negative) are ON cells."""
    da = rng.random((3, 64, 64)) < 0.5
    db = rng.random((3, 64, 64)) < 0.5
    ta, tdb = torch.from_numpy(da), torch.from_numpy(db)
    wide = torch.from_numpy(da * rng.integers(1, 256, da.shape).astype(np.uint8))
    signed = torch.from_numpy(db * rng.integers(-128, 0, db.shape).astype(np.int8))
    assert torch.equal(conv_cuda.conv_counts_fused(wide, signed),
                       conv_cuda.conv_counts_fused(ta, tdb))
    for out_or in (True, False):
        assert torch.equal(conv_cuda.conv_small_fused(wide, signed, out_or=out_or),
                           conv_cuda.conv_small_fused(ta, tdb, out_or=out_or))


@pytest.mark.parametrize("out_or", [True, False])
def test_conv_small_fused_matches_pallas(rng, out_or):
    """Includes p=0.5 pairs whose counts pass 193: outside the kernel's
    contract, where both compute the counts mod 193."""
    da = rng.random((4, 64, 64)) < 0.5
    db = np.concatenate([rng.random((2, 64, 64)) < 0.5, _sparse_dense(rng, 2, 30)])
    expect = np.asarray(CP.conv_small_fused(jnp.asarray(da), jnp.asarray(db),
                                            out_or=out_or, interpret=True))
    got = conv_cuda.conv_small_fused(torch.from_numpy(da), torch.from_numpy(db),
                                     out_or=out_or)
    assert got.dtype == (torch.int8 if out_or else torch.int32)
    assert (got.numpy() == expect).all()
    exact = conv_cuda.conv_counts_fused(torch.from_numpy(da), torch.from_numpy(db))
    assert int(exact.max()) >= 193
    assert torch.equal(got, ((exact % 193 != 0).to(torch.int8) if out_or else exact % 193))


def test_conv_small_packed_matches_pallas(rng):
    da = rng.random((5, 64, 64)) < 0.4  # odd batch
    db = np.concatenate([_sparse_dense(rng, 3, 40), rng.random((2, 64, 64)) < 0.5])
    expect = CP.conv_small_packed(_packed(da), _packed(db), interpret=True)
    got = conv_cuda.conv_small_packed(tb.from_dense(torch.from_numpy(da)),
                                      tb.from_dense(torch.from_numpy(db)))
    assert (convert.board_to_packed(got) == np.asarray(expect)).all()


def test_conv_small_packed_unaligned_matches_pallas(rng):
    """Operands whose data starts 8 bytes past a 16-byte boundary (an
    ``int64[B, 64]`` slice may), with counts above 193."""
    da = rng.random((3, 64, 64)) < 0.5
    db = rng.random((3, 64, 64)) < 0.5
    expect = CP.conv_small_packed(_packed(da), _packed(db), interpret=True)
    store = torch.zeros((2, 3 * 64 + 2), dtype=torch.int64)
    a, b = (s[1:3 * 64 + 1].view(3, 64) for s in store)
    a.copy_(tb.from_dense(torch.from_numpy(da)))
    b.copy_(tb.from_dense(torch.from_numpy(db)))
    assert a.data_ptr() % 16 == 8 and b.data_ptr() % 16 == 8
    got = conv_cuda.conv_small_packed(a, b)
    assert (convert.board_to_packed(got) == np.asarray(expect)).all()
    exact = conv_cuda.conv_counts_fused(torch.from_numpy(da), torch.from_numpy(db))
    assert int(exact.max()) >= 193
    assert torch.equal(got, tb.from_dense(exact % 193 != 0))


@pytest.mark.parametrize("mix", ["elemwise", "rolls"])
def test_calibrate_32bit_matches_pallas(rng, mix):
    """With 32-bit words the twin's chain is the TPU kernel's own function,
    on the transposed block."""
    a = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    expect = np.asarray(CAL.calibrate(jnp.asarray(a), jnp.asarray(b), iters=5, mix=mix,
                                      batch_tile=8, interpret=True))
    words = [torch.from_numpy(np.ascontiguousarray(x.T).view(np.int32)) for x in (a, b)]
    got = calibrate_cuda.calibrate_plain(*words, iters=5, mix=mix)
    assert (got.numpy().view(np.uint32).T == expect).all()
    # the wrapper runs the port's 64-bit word only
    with pytest.raises(TypeError):
        calibrate_cuda.calibrate(*words, iters=5, mix=mix)


def test_calibrate_64bit_chain(rng):
    """The 64-bit chain on each word equals a numpy uint64 reference; the
    output depends on the inputs and the iteration count."""
    a = rng.integers(-2**63, 2**63, (3, 64), dtype=np.int64)
    b = rng.integers(-2**63, 2**63, (3, 64), dtype=np.int64)
    got, ops = calibrate_cuda.calibrate(torch.from_numpy(a), torch.from_numpy(b), 3,
                                        mix="rolls")
    assert ops == 3 * calibrate_cuda.ops_per_iter("rolls") * 3 * 64
    ua, ub = a.view(np.uint64), b.view(np.uint64)
    for _ in range(3):
        ua, ub = np.roll(ua, 1, axis=-1), np.roll(ub, -1, axis=-1)
        for _ in range(calibrate_cuda.UNITS_PER_ITER):
            ua = ua ^ (ub << np.uint64(1))
            ub = ub + (ua >> np.uint64(3))
    assert (got.numpy().view(np.uint64) == (ua ^ ub)).all()
    other, _ = calibrate_cuda.calibrate(torch.from_numpy(a), torch.from_numpy(b), 4,
                                        mix="rolls")
    assert not torch.equal(got, other)
    assert calibrate_cuda.ops_per_iter("rolls") > calibrate_cuda.ops_per_iter("elemwise")


def test_cpu_tensors_take_plain_twins_without_launch(rng):
    da, db = _peel_operands(rng)
    a, b = tb.from_dense(torch.from_numpy(da)), tb.from_dense(torch.from_numpy(db))
    ta, tdb = torch.from_numpy(da), torch.from_numpy(db)
    before = dict(conv_cuda.LAUNCHES), dict(calibrate_cuda.LAUNCHES)
    pairs = [
        (conv_cuda.convolve_sparse_fused(a, b), conv_cuda.convolve_sparse_fused_plain(a, b)),
        (conv_cuda.counts_sparse_fused(a, b, 4)[3],
         conv_cuda.counts_sparse_fused_plain(a, b, 4)[3]),
        (conv_cuda.union_sparse_fused([(a, b), (b, a[2])]),
         conv_cuda.union_sparse_fused_plain([(a, b), (b, a[2])])),
        (conv_cuda.conv_counts_fused(ta, tdb), conv_cuda.conv_counts_fused_plain(ta, tdb)),
        (conv_cuda.conv_small_fused(ta, tdb), conv_cuda.conv_small_fused_plain(ta, tdb)),
        (conv_cuda.conv_small_packed(a, b), conv_cuda.conv_small_packed_plain(a, b)),
        (calibrate_cuda.calibrate(a, b, 2)[0], calibrate_cuda.calibrate_plain(a, b, 2)),
    ]
    assert all(torch.equal(g, e) for g, e in pairs)
    assert (dict(conv_cuda.LAUNCHES), dict(calibrate_cuda.LAUNCHES)) == before


def test_wrappers_reject_bad_input(rng):
    a = tb.from_dense(torch.from_numpy(rng.random((4, 64, 64)) < 0.3))
    d = tb.to_dense(a)
    with pytest.raises(TypeError):
        conv_cuda.convolve_sparse_fused(a.to(torch.int32), a)
    with pytest.raises(RuntimeError):
        conv_cuda.convolve_sparse_fused(a, a[:3])  # shapes do not broadcast
    for n_planes in (0, 14):
        with pytest.raises(ValueError):
            conv_cuda.counts_sparse_fused(a, a, n_planes)
    for n_pairs in (0, 9):
        with pytest.raises(ValueError):
            conv_cuda.union_sparse_fused([(a, a)] * n_pairs)
    with pytest.raises(TypeError):
        conv_cuda.union_sparse_fused([(a, a.to(torch.int32))])
    with pytest.raises(RuntimeError):
        conv_cuda.union_sparse_fused([(a, a), (a, a[:3])])  # shapes do not broadcast
    with pytest.raises(TypeError):
        conv_cuda.conv_counts_fused(d.to(torch.float32), d)
    with pytest.raises(ValueError):
        conv_cuda.conv_small_fused(d, d[:3])
    with pytest.raises(ValueError):
        conv_cuda.conv_small_packed(a[0], a[0])
    with pytest.raises(ValueError):
        calibrate_cuda.calibrate(a, a, 2, mix="shuffles")
    with pytest.raises(ValueError):
        calibrate_cuda.calibrate(a, a[:3], 2)
