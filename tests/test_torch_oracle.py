"""The port's native C oracle (``lifeapi_tpu_torch/native``) and the port's
stepping held to it.

The oracle is the JAX package's ``oracle.c``, copied byte for byte and
built by the port into ``lifeapi_tpu_torch/_build/`` (never through
``lifeapi_tpu.native.load_oracle``, which writes into the JAX package).
``core.step.step``, ``step_n`` and the plain versions of the rollout [1]
and of the half-word rollout [4] must equal ``life_step_packed_n`` bit for
bit over 16 and more generations, as ``tests/test_oracle.py`` holds the
JAX package.
"""

import pathlib

import numpy as np
import pytest
import torch

from lifeapi_tpu.native import build as jnb
from lifeapi_tpu_torch import convert, native
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.core import step as ts
from lifeapi_tpu_torch.native import build as nb
from lifeapi_tpu_torch.ops import step_cuda
from oracle import life_step_dense, random_dense
from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _boards(rng, n, p):
    return tb.from_dense(torch.from_numpy(random_dense(rng, p=p, batch=(n,))))


def test_oracle_source_is_the_jax_packages():
    port = (ROOT / "lifeapi_tpu_torch" / "native" / "oracle.c").read_bytes()
    assert port == (ROOT / "lifeapi_tpu" / "native" / "oracle.c").read_bytes()


def test_oracle_builds_into_the_ports_build_directory():
    path = nb.library_path()
    assert path.parent == ROOT / "lifeapi_tpu_torch" / "_build"
    assert path.exists() and path == nb.library_file()


def test_c_dense_matches_numpy(rng):
    d = random_dense(rng, p=0.4, batch=(16,))
    assert (native.step_dense(d).astype(bool) == life_step_dense(d)).all()
    assert (native.step_dense(d[0], steps=0) == d[0]).all()


def test_c_packed_matches_c_dense(rng):
    d = random_dense(rng, p=0.5, batch=(8,))
    words = native.to_packed64(tb.from_dense(torch.from_numpy(d)))
    got = tb.to_dense(native.from_packed64(native.step_packed64(words, 3), device="cpu")).numpy()
    assert (got == native.step_dense(d, 3).astype(bool)).all()


def test_conversions_match_the_jax_packages(rng):
    """The port's board <-> oracle words equal the JAX package's packed32
    <-> packed64 on the same cells, and round-trip."""
    t = _boards(rng, 4, 0.3)
    words = native.to_packed64(t)
    assert words.dtype == np.uint64 and words.shape == (4, 64)
    assert (words == jnb.packed32_to_packed64(convert.board_to_packed(t))).all()
    assert (jnb.packed64_to_packed32(words) == convert.board_to_packed(t)).all()
    assert torch.equal(native.from_packed64(words, device="cpu"), t)


@pytest.mark.parametrize("bad", [np.zeros((3, 63), np.uint64), np.zeros((64, 63), np.uint8)])
def test_oracle_rejects_wrong_shapes(bad):
    step = native.step_packed64 if bad.dtype == np.uint64 else native.step_dense
    with pytest.raises(ValueError):
        step(bad)


@pytest.mark.parametrize("p", [0.3, 0.45])
def test_port_stepping_matches_c_oracle(rng, p):
    """256 random boards: step, step_n (16 and 37 generations), and the
    plain versions of [1] and [4] against ``life_step_packed_n``."""
    t = _boards(rng, 256, p)
    words = native.to_packed64(t)
    one = native.from_packed64(native.step_packed64(words, 1), device="cpu")
    assert torch.equal(ts.step(t), one)
    for n in (16, 37):
        want = native.from_packed64(native.step_packed64(words, n), device="cpu")
        assert torch.equal(ts.step_n(t, n), want)
        assert torch.equal(step_cuda.rollout_plain(t, n), want)
        lo, hi = step_cuda.rollout_lohi_plain(*step_cuda.to_kernel_layout(t), n)
        assert torch.equal(step_cuda.from_kernel_layout(lo, hi), want)
    assert torch.equal(step_cuda.rollout(t, 16), native.from_packed64(
        native.step_packed64(words, 16), device="cpu"))
