"""The port's ``utils``: ``prng``, ``profiling``, ``checkpoint`` and
``debug.check_board_packed`` (counterparts of ``tests/test_utils.py``).

``KeySequence`` and ``fold_in`` derive ``torch.Generator`` objects: they
are held to determinism and distinct draws, not to JAX's threefry bits.
"""

import json

import numpy as np
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.utils import checkpoint as jcheckpoint
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board
from lifeapi_tpu_torch.stable import propagate as P
from lifeapi_tpu_torch.utils import checkpoint, debug, prng, profiling
from torch_threads import one_torch_thread  # noqa: F401


def test_key_sequence_deterministic_and_distinct():
    ks1, ks2 = prng.KeySequence(42, device="cpu"), prng.KeySequence(42, device="cpu")
    a = torch.rand(8, generator=ks1())
    assert torch.equal(a, torch.rand(8, generator=ks2()))
    assert not torch.equal(torch.rand(8, generator=ks1()), a)
    splits = [torch.rand(8, generator=g) for g in prng.KeySequence(42, device="cpu").split(3)]
    assert torch.equal(splits[0], a)
    assert not torch.equal(splits[1], splits[2])
    own = torch.Generator().manual_seed(42)
    assert torch.equal(torch.rand(8, generator=prng.KeySequence(own)()), a)


def test_fold_in_is_pure_and_keyed():
    g = torch.Generator().manual_seed(7)
    state = g.get_state().clone()

    def draw(h):
        return torch.rand(4, generator=h)

    assert torch.equal(draw(prng.fold_in(g, 3)), draw(prng.fold_in(g, 3)))
    assert torch.equal(g.get_state(), state)  # the generator is not advanced
    assert not torch.equal(draw(prng.fold_in(g, 3)), draw(prng.fold_in(g, 4)))
    assert torch.equal(draw(prng.fold_in(g, 3, 5)), draw(prng.fold_in(prng.fold_in(g, 3), 5)))


def test_benchmark_and_timer():
    x = torch.ones(8, 8)
    assert profiling.benchmark(lambda a: a * 2, x, reps=3, warmup=1) > 0
    timer = profiling.Timer()
    for _ in range(3):
        with timer.measure():
            x @ x
    assert len(timer.times) == 3 and 0 < timer.best() <= timer.mean()
    assert profiling.steps_per_second(8192, 512, 2.0) == 8192 * 512 / 2.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "t") as d:
        board.zoi(board.from_cells([(1, 2)], device="cpu"))
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert str(d) == str(tmp_path / "t") and events


def test_checkpoint_roundtrip(tmp_path):
    state = {"boards": board.from_cells([(1, 2), (3, 4)], device="cpu"),
             "logits": torch.arange(12.0).reshape(3, 4),
             "incumbents": [torch.tensor([7], dtype=torch.int32), (torch.ones(2),)]}
    path = tmp_path / "ckpt.pt"
    checkpoint.save(path, state)
    back = checkpoint.restore(path, template=state)
    assert torch.equal(back["boards"], state["boards"])
    assert torch.equal(back["logits"], state["logits"])
    assert back["incumbents"][0].dtype == torch.int32
    assert torch.equal(back["incumbents"][1][0], torch.ones(2))
    template = {"boards": torch.zeros(64, dtype=torch.int64),
                "logits": torch.zeros(3, 4, dtype=torch.float64), "incumbents": None}
    cast = checkpoint.restore(path, template=template)
    assert cast["logits"].dtype == torch.float64
    assert torch.equal(checkpoint.restore(path, device="cpu")["boards"], state["boards"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            checkpoint.restore(path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            checkpoint.load_rle(path)


def test_checkpoint_rle(tmp_path):
    b = board.from_cells([(40, 40), (41, 41)], device="cpu")
    p = tmp_path / "b.rle"
    checkpoint.save_rle(p, b)
    assert torch.equal(checkpoint.load_rle(p, device="cpu"), board.move(b, -32, -32))


def test_load_rle_of_the_jax_packages_file(tmp_path):
    cells = [(40, 40), (41, 41), (42, 40), (3, 60)]
    p = tmp_path / "jax.rle"
    jcheckpoint.save_rle(p, jb.from_cells(cells))
    want = jcheckpoint.load_rle(p)
    assert torch.equal(checkpoint.load_rle(p, device="cpu"), convert.board_from_packed(np.asarray(want), device="cpu"))


def test_stable_invariants_and_board_check():
    st = P.make(state=board.to_dense(board.from_cells([(5, 5)], device="cpu")),
                unknown=torch.zeros(64, 64, dtype=torch.bool))
    debug.assert_stable_invariants(P.synchronise_state_known(st).stable)
    debug.check_board_packed(board.empty(device="cpu"))
    debug.check_board_packed(board.empty((3,), device="cpu"))
    for bad in (torch.zeros(64, 2, dtype=torch.int64), torch.zeros(64, dtype=torch.int32)):
        with pytest.raises(AssertionError):
            debug.check_board_packed(bad)
