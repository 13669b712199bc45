"""Closed-form vectorized stable-propagation rules.

Counterpart of :mod:`lifeapi_tpu.stable.rules_vec`: the interval-reasoning
rules of the scalar specification (:mod:`lifeapi_tpu_torch.stable.options`)
as elementwise integer tensor arithmetic, with no tables and no gathers.

Inputs are integer tensors: ``center`` (0=OFF, 1=ON, 2=UNKNOWN), 9-cell
inclusive counts ``on9``/``unk9`` (and ``m9`` = on9+unk9), and the uint8
ruled-out options mask.  Arithmetic runs in int32; masks come back uint8.
"""

from __future__ import annotations

import torch

from . import options as opt

# per-option-bit semantics, index order = bit order
_BITS = (opt.LIVE2, opt.LIVE3, opt.DEAD0, opt.DEAD1, opt.DEAD2, opt.DEAD4,
         opt.DEAD5, opt.DEAD6)
_CNTS = (2, 3, 0, 1, 2, 4, 5, 6)
_LIVE = (True, True, False, False, False, False, False, False)

_BIG = 127
I32 = torch.int32


def _bits(cond, value):
    """``value`` where ``cond`` holds, else 0, as int32."""
    return cond.to(I32) * value


def _where(cond, a, b):
    """``where`` over int32 tensors or Python ints."""
    return torch.where(cond, torch.as_tensor(a, dtype=I32, device=cond.device),
                       torch.as_tensor(b, dtype=I32, device=cond.device))


def _nbhd_from_counts(center, on9, unk9):
    """Interval neighbourhood (count, unknown) of the cell, center
    excluded, from inclusive window counts."""
    count = on9.to(I32) - (center == opt.ON).to(I32)
    unknown = unk9.to(I32) - (center == opt.UNKNOWN).to(I32)
    return count, unknown


def _maximal_ruled(center, count, unknown):
    """Vector maximal_options: ruled-out mask (int32) from the interval
    [count, count+unknown] and the center three-state."""
    lo = count
    hi = count + unknown
    ruled = torch.zeros(torch.broadcast_shapes(center.shape, lo.shape), dtype=I32,
                        device=lo.device)
    for bit, cnt, live in zip(_BITS, _CNTS, _LIVE):
        out = (lo > cnt) | (hi < cnt)
        out = out | (center == (opt.OFF if live else opt.ON))
        ruled = ruled | _bits(out, bit)
    return ruled


def _nbhd_from_options(mask):
    """Vector options_to_nbhd: (three_state, min_count, max_count) of the
    possible options.  Only meaningful when mask != 0xFF."""
    min_c = torch.full(mask.shape, _BIG, dtype=I32, device=mask.device)
    max_c = torch.full(mask.shape, -_BIG, dtype=I32, device=mask.device)
    for bit, cnt, _ in zip(_BITS, _CNTS, _LIVE):
        possible = (mask & bit) == 0
        min_c = torch.where(possible, torch.clamp(min_c, max=cnt), min_c)
        max_c = torch.where(possible, torch.clamp(max_c, min=cnt), max_c)
    maybe_live = (mask & opt.LIVE_MASK) != opt.LIVE_MASK
    maybe_dead = (mask & opt.DEAD_MASK) != opt.DEAD_MASK
    three = _where(maybe_live & ~maybe_dead, opt.ON,
                   _where(maybe_dead & ~maybe_live, opt.OFF, opt.UNKNOWN))
    return three, min_c, max_c


def _meet(c1, cnt1, unk1, c2, cnt2, unk2):
    """Vector Nbhd.meet; returns (ok, center, count, unknown)."""
    conflict = (c1 != c2) & (c1 != opt.UNKNOWN) & (c2 != opt.UNKNOWN)
    center = torch.where(c1 == opt.UNKNOWN, c2, c1)
    known_ons = torch.maximum(cnt1, cnt2)
    known_offs = torch.maximum(8 - unk1 - cnt1, 8 - unk2 - cnt2)
    remaining = 8 - known_ons - known_offs
    return ~conflict, center, known_ons, remaining


def update_bits(center, on9, unk9):
    """Vector update_options_rule: (add_mask uint8, abort bool)."""
    count, unknown = _nbhd_from_counts(center, on9, unk9)
    ruled = _maximal_ruled(center, count, unknown)
    abort = ruled == 0xFF
    return torch.where(abort, 0, ruled).to(torch.uint8), abort


def simple_bits(center, on9, unk9):
    """Vector simple_rule: bits (1=set_off, 2=set_on, 4=signal_off,
    8=signal_on, 16=abort), the encoding of options.simple_lut."""
    on_n, unk_n = _nbhd_from_counts(center, on9, unk9)
    lo = on_n
    hi = on_n + unk_n

    # count values consistent with stability per center hypothesis:
    # live needs {2,3} in range, dead needs a non-3 in range
    def in_range(c):
        return (lo <= c) & (c <= hi)

    may_be_on = (center != opt.OFF) & (in_range(2) | in_range(3))
    # dead stable at any count != 3 within the interval: the interval
    # contains a non-3 value iff it's non-empty and not exactly {3}
    interval_nonempty = hi >= lo
    only_three = (lo == 3) & (hi == 3)
    may_be_off = (center != opt.ON) & interval_nonempty & ~only_three

    abort_known = ((center == opt.ON) & ~may_be_on) | ((center == opt.OFF) & ~may_be_off)

    set_on = (center == opt.UNKNOWN) & may_be_on & ~may_be_off
    set_off = (center == opt.UNKNOWN) & may_be_off & ~may_be_on

    # signals: for a known center, the only consistent count sits at an end
    # of the interval -> all unknown neighbours forced.
    # ON center: consistent counts = {2,3} ∩ [lo, hi].
    on_min = _where(in_range(2), 2, _where(in_range(3), 3, _BIG))
    on_max = _where(in_range(3), 3, _where(in_range(2), 2, -_BIG))
    on_unique = may_be_on & (on_min == on_max)
    sig_on_on = (center == opt.ON) & on_unique & (on_min == hi)
    sig_off_on = (center == opt.ON) & on_unique & (on_min == lo)

    # OFF center: consistent counts = [lo, hi] \ {3}; forced only when that
    # set is exactly {lo} or exactly {hi}
    off_hi_only = (center == opt.OFF) & (hi != 3) & ((lo == hi) | ((lo == hi - 1) & (lo == 3)))
    off_lo_only = (center == opt.OFF) & (lo != 3) & ((lo == hi) | ((lo + 1 == hi) & (hi == 3)))
    sig_on_off = off_hi_only & (hi > lo)
    sig_off_off = off_lo_only & (hi > lo)

    has_unknowns = unk_n > 0
    signal_on = (sig_on_on | sig_on_off) & has_unknowns
    signal_off = (sig_off_on | sig_off_off) & has_unknowns

    bits = (_bits(set_off, 1) | _bits(set_on, 2) | _bits(signal_off, 4)
            | _bits(signal_on, 8) | _bits(abort_known, 16))
    return bits.to(torch.uint8)


def signal_bits(center, ruled, on9, m9):
    """Vector signal_rule: bits (1=signal_on, 2=signal_off, 4=center_on,
    8=center_off), the encoding of options.signal_lut."""
    ruled = ruled.to(I32)
    unk9 = m9.to(I32) - on9.to(I32)
    count, unknown = _nbhd_from_counts(center, on9, unk9)

    o2 = ruled | _maximal_ruled(center, count, unknown)
    o2_ok = o2 != 0xFF

    c2, min2, max2 = _nbhd_from_options(o2)
    ok2, cen2, _, _ = _meet(center, count, unknown, c2, min2, max2 - min2)

    # n3 = n.restrict_to(o)  (the ORIGINAL mask; reference
    # stable_signal.py:12 reassigns after the guards)
    o_ok = ruled != 0xFF
    c3, min3, max3 = _nbhd_from_options(torch.where(o_ok, ruled, 0))
    ok3, _, cnt3, unk3 = _meet(center, count, unknown, c3, min3, max3 - min3)

    guards = (unknown != 0) & o2_ok & ok2 & o_ok & ok3
    decided = guards & (unk3 == 0)
    signal_off = decided & (cnt3 == count)
    signal_on = decided & ~signal_off & (cnt3 == count + unknown)

    # center forcing uses n2 = n.restrict_to(o2)
    cen_guards = (center == opt.UNKNOWN) & o2_ok & ok2
    center_on = cen_guards & (cen2 == opt.ON)
    center_off = cen_guards & (cen2 == opt.OFF)

    bits = (_bits(signal_on, 1) | _bits(signal_off, 2) | _bits(center_on, 4)
            | _bits(center_off, 8))
    return bits.to(torch.uint8)


def ternary_code(center, on9, unk9, naive=False):
    """Vector life_rule_interval: next three-state code (0/1/2), int32."""
    lo, unknown = _nbhd_from_counts(center, on9, unk9)
    hi = lo + unknown

    def inter(c):
        return (lo <= c) & (c <= hi)

    nonempty = hi >= lo
    has_23 = inter(2) | inter(3)
    has_3 = inter(3)
    has_not23 = nonempty & ~((lo >= 2) & (hi <= 3))
    has_not3 = nonempty & ~((lo == 3) & (hi == 3))

    on_like = center != opt.OFF  # ON or UNKNOWN hypothesis allowed
    off_like = center != opt.ON

    maybe_on = (on_like & has_23) | (off_like & has_3)
    maybe_off = (on_like & has_not23) | (off_like & has_not3)

    nxt = _where(maybe_on & ~maybe_off, opt.ON,
                 _where(maybe_off & ~maybe_on, opt.OFF, opt.UNKNOWN))
    if naive:
        nxt = torch.where(center == opt.UNKNOWN, opt.UNKNOWN, nxt)
    return nxt


def _is_forced(center, ruled, count, unknown):
    """Vector is_forced (stable_vulnerable semantics): True where the cell
    is forced or contradictory (the contradiction case counts as forced)."""
    o2 = ruled | _maximal_ruled(center, count, unknown)
    impossible = o2 == 0xFF
    c2, min2, max2 = _nbhd_from_options(torch.where(impossible, 0, o2))
    ok, cen, _, unk2 = _meet(center, count, unknown, c2, min2, max2 - min2)
    contradiction = impossible | ~ok
    forced = (unk2 == 0) | ((center == opt.UNKNOWN) & (cen != opt.UNKNOWN))
    return contradiction | forced


def vulnerable_bits(center, ruled, on9, unk9):
    """Vector vulnerable_rule + vulnerable_center_rule: bits (1=v_on,
    2=v_off, 4=vc_on, 8=vc_off), the encoding of options.vulnerable_lut
    (for inputs the reference generator enumerates)."""
    ruled = ruled.to(I32)
    count, unknown = _nbhd_from_counts(center, on9, unk9)

    neigh_ok = ~(((center != opt.UNKNOWN) & (unknown <= 1))
                 | ((center == opt.UNKNOWN) & (unknown == 0)))
    f_on = _is_forced(center, ruled, count + 1, unknown - 1)
    f_off = _is_forced(center, ruled, count, unknown - 1)
    v_on = neigh_ok & f_on
    v_off = neigh_ok & f_off

    cen_ok = (unknown != 0) & (center == opt.UNKNOWN)
    fc_on = _is_forced(torch.full_like(center, opt.ON), ruled, count, unknown)
    fc_off = _is_forced(torch.full_like(center, opt.OFF), ruled, count, unknown)
    vc_on = cen_ok & fc_on
    vc_off = cen_ok & fc_off

    bits = _bits(v_on, 1) | _bits(v_off, 2) | _bits(vc_on, 4) | _bits(vc_off, 8)
    return bits.to(torch.uint8)
