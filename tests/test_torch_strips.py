"""``core/strips`` and the ``core/bitops`` word helpers against the JAX
package, bit for bit.

The helpers take one ``int64`` word where the JAX package takes a
``(lo, hi)`` pair of ``uint32`` halves; strips are ``int64[..., width]``
where the JAX package's are ``uint32[..., width, 2]``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import bitops as jbits
from lifeapi_tpu.core import board as jb
from lifeapi_tpu.core import strips as jstrips
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import bitops as tbits
from lifeapi_tpu_torch.core import strips as tstrips
from oracle import random_dense
from torch_threads import one_torch_thread  # noqa: F401

EDGES = [0, 1, 0b1100, 2**64 - 1, 0x8000000000000001, 2**63, 2**63 - 1, 0xFFFFFFFF,
         0xFFFFFFFF00000000, 0x00000000FFFF0000]


def _words(rng):
    vals = [int(v) for v in rng.integers(0, 2**64, size=40, dtype=np.uint64)] + EDGES
    # sparse words, so runs and widths take every length
    vals += [int(v) for v in (rng.integers(0, 2**64, size=40, dtype=np.uint64)
                              & rng.integers(0, 2**64, size=40, dtype=np.uint64))]
    return np.asarray(vals, dtype=np.uint64)


def _halves(vals):
    return (jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)))


def _joined(lo, hi):
    return (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32)))


def _t(vals):
    return torch.from_numpy(vals.view(np.int64).copy())


def _longest_run_py(v):
    # tests/test_board.py's reference
    if v == 0:
        return 0
    bits = f"{v:064b}" * 2
    best = max(len(s) for s in bits.split("0")) if "0" in bits else 128
    return min(best, 64)


def test_longest_run_and_populated_width(rng):
    vals = _words(rng)
    lo, hi = _halves(vals)
    runs = tbits.longest_run64(_t(vals))
    assert runs.tolist() == np.asarray(jbits.longest_run64(lo, hi)).tolist()
    assert runs.tolist() == [_longest_run_py(int(v)) for v in vals]
    widths = tbits.populated_width64(_t(vals))
    assert widths.tolist() == np.asarray(jbits.populated_width64(lo, hi)).tolist()
    assert widths.tolist() == [0 if v == 0 else 64 - _longest_run_py(int(~v & (2**64 - 1)))
                               for v in map(int, vals)]


def test_bitrev32(rng):
    vals = rng.integers(0, 2**32, size=64, dtype=np.uint64)
    vals = np.concatenate([vals, np.asarray([0, 1, 2**31, 2**32 - 1], np.uint64)])
    got = tbits.bitrev32(_t(vals))
    want = np.asarray(jbits.bitrev32(jnp.asarray(vals.astype(np.uint32))))
    assert got.tolist() == want.astype(np.int64).tolist()
    assert got.tolist() == [int(f"{int(v):032b}"[::-1], 2) for v in vals]


def test_convolve_word64(rng):
    x, y = _words(rng), _words(np.random.default_rng(1))
    got = tbits.convolve_word64(_t(x), _t(y))
    want = _joined(*jbits.convolve_word64(*_halves(x), *_halves(y)))
    assert (got.numpy().view(np.uint64) == want).all()


def _board_pair(rng, batch=()):
    d = random_dense(rng, p=0.3, batch=batch)
    j = jb.from_dense(jnp.asarray(d))
    return j, convert.board_from_packed(np.asarray(j), device="cpu")


@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("column", [0, 10, 63])
def test_get_and_set_strip(rng, width, column):
    j, t = _board_pair(rng, batch=(3,))
    js = jstrips.get_strip(j, column, width)
    ts = tstrips.get_strip(t, column, width)
    assert ts.shape == (3, width)
    js = np.asarray(js)
    assert (ts.numpy().view(np.uint64) == _joined(js[..., 0], js[..., 1])).all()
    _, other = _board_pair(rng, batch=(3,))
    value = tstrips.get_strip(other, column + 7, width)
    jvalue = jnp.stack(_halves(value.numpy().view(np.uint64)), axis=-1)
    got = tstrips.set_strip(t, column, value)
    want = jstrips.set_strip(j, column, jvalue)
    assert torch.equal(got, convert.board_from_packed(np.asarray(want), device="cpu"))
    assert torch.equal(t, convert.board_from_packed(np.asarray(j), device="cpu"))  # input untouched


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_get_and_set_patch(rng, radius):
    j, t = _board_pair(rng)
    for cell in [(0, 0), (21, 40), (63, 5)]:
        val = tstrips.get_patch(t, cell, radius)
        assert val == jstrips.get_patch(j, cell, radius)
        _, base = _board_pair(rng)
        got = tstrips.set_patch(base, cell, radius, val)
        want = jstrips.set_patch(jnp.asarray(convert.board_to_packed(base)), cell, radius, val)
        assert torch.equal(got, convert.board_from_packed(np.asarray(want), device="cpu"))


@pytest.mark.parametrize("width", [2, 4, 6])
def test_strip_indices(rng, width):
    for mask in [0, 1, (1 << 5) | (1 << 6) | (1 << 40), 1 << 63, 2**64 - 1,
                 int(rng.integers(0, 2**63))]:
        assert tstrips.strip_indices(mask, width) == jstrips.strip_indices(mask, width)
