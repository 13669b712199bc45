"""The port's LifeHistory (``lifeapi_tpu_torch.history``) against
:mod:`lifeapi_tpu.history`: the same RLE text out, the same planes in."""

import numpy as np
import pytest

from lifeapi_tpu import history as jhist
from lifeapi_tpu.core import board as jb
from lifeapi_tpu_torch import convert, history
from lifeapi_tpu_torch.core import board as tb
from torch_threads import one_torch_thread  # noqa: F401

EATER = [(0, 0), (1, 0), (0, 1), (2, 1), (2, 2), (2, 3), (3, 3)]


def _planes():
    """Cells for state, history, marked and original: every LifeHistory
    char and an unnamed combination ("F")."""
    return ([(1, 1), (2, 2), (5, 7), (9, 9)], [(3, 4), (4, 4), (9, 9)],
            [(1, 1), (6, 6)], [(2, 2), (9, 9)])


def _both():
    planes = _planes()
    jh = jhist.LifeHistory(*(jb.from_cells(c) for c in planes))
    th = history.LifeHistory(*(tb.from_cells(c, device="cpu") for c in planes))
    return jh, th


def _same(th, jh):
    for t, j in zip(th, jh):
        assert np.array_equal(convert.board_to_packed(t), np.asarray(j))


def test_rle_matches_jax():
    jh, th = _both()
    assert th.rle() == jh.rle()
    assert th.rle_with_header() == jh.rle_with_header()
    assert set("ABCDEF") <= set(th.rle())
    assert [history.state_to_char(m) for m in range(16)] == \
        [jhist.state_to_char(m) for m in range(16)]


@pytest.mark.parametrize("bellman", [False, True])
def test_parse_matches_jax(bellman):
    jh, _ = _both()
    text = jh.rle() if not bellman else "C2E$bC3E$!"
    parse, jparse = ((history.parse_bellman, jhist.parse_bellman) if bellman
                     else (history.parse, jhist.parse))
    _same(parse(text, device="cpu"), jparse(text))
    _same(parse(text, device="cpu").move(32, 32), jparse(text).move(32, 32))


def test_convert_and_align_with():
    jh, th = _both()
    _same(convert.history_from_jax(jh, device="cpu"), jh)
    back = jhist.LifeHistory(*convert.history_to_jax(th))
    assert back.rle() == jh.rle()
    pat_cells = EATER
    jstate = jb.move(jb.from_cells(pat_cells), 10, 20)
    tstate = tb.move(tb.from_cells(pat_cells, device="cpu"), 10, 20)
    jaligned = jhist.LifeHistory.create(state=jstate).align_with(jb.from_cells(pat_cells))
    taligned = history.LifeHistory.create(state=tstate).align_with(tb.from_cells(pat_cells, device="cpu"))
    _same(taligned, jaligned)
    assert tb.on_cells(taligned.state) == sorted(pat_cells)
