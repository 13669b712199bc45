"""Invariant checks of the port's data structures (counterpart of
:mod:`lifeapi_tpu.utils.debug`; the reference's ``SanityCheck`` is a
disabled stub, LifeStable.hpp:207-214, here the invariants are real)."""

from __future__ import annotations

import torch


def check_stable_invariants(st):
    """A dict of bool[...] invariant checks for a dense
    :class:`~lifeapi_tpu_torch.stable.propagate.Stable`: every violation
    is an internal inconsistency, not merely an unsatisfiable problem."""
    from ..stable import options as opt

    def none(mask):
        return ~mask.flatten(-2).any(dim=-1)

    return {
        "state_unknown_disjoint": none(st.state & st.unknown),
        "known_on_dead_ruled": none((st.state & ~st.unknown)
                                    & ((st.ruled & opt.DEAD_MASK) != opt.DEAD_MASK)),
    }


def assert_stable_invariants(st):
    for name, ok in check_stable_invariants(st).items():
        assert bool(ok.all()), f"stable invariant violated: {name}"


def check_board(board):
    """Boards are ``torch.int64[..., 64]``."""
    assert board.dtype == torch.int64, board.dtype
    assert board.shape[-1:] == (64,), board.shape


def check_board_packed(board):
    """The JAX package's name for :func:`check_board`: a board is one
    ``int64`` word per column here, where the JAX package packs
    ``uint32[..., 64, 2]``."""
    check_board(board)
