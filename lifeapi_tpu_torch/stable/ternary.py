"""Ternary (three-state) Life stepping: boards with UNKNOWN cells.

Counterpart of :mod:`lifeapi_tpu.stable.ternary`: stepping a board whose
cells are ON/OFF/UNKNOWN by propagating intervals of possible neighbour
counts, the vocabulary of the reference's dormant ``bitslicing/
unknown_step*.py`` generators.
"""

from __future__ import annotations

import torch

from . import options as opt
from . import rules_vec
from .propagate import count9


def step_ternary(state, unknown, naive=False):
    """One interval Life step.  ``state``/``unknown``: dense bool
    [..., 64, 64].  Returns (next_state, next_unknown).

    ``naive=True`` matches the reference's unknown_step.py netlist exactly
    (UNKNOWN centers stay UNKNOWN); the default also resolves unknown
    centers whose fate is independent of their value."""
    center = torch.where(unknown, opt.UNKNOWN, state.to(torch.int32))
    nxt = rules_vec.ternary_code(center, count9(state), count9(unknown), naive=naive)
    return nxt == opt.ON, nxt == opt.UNKNOWN


def step_ternary_n(state, unknown, n, naive=False):
    for _ in range(n):
        state, unknown = step_ternary(state, unknown, naive=naive)
    return state, unknown
