"""LifeWeld: stepping catalysts without their full stator.

Counterpart of :mod:`lifeapi_tpu.weld` (reference LifeWeld.hpp:18-404).
Stores per-cell *frozen* neighbour counts (a 3-bit field) that are added to
the live neighbour counts during stepping, so a catalyst's boundary behaves
as if the deleted stator were present.  Only non-active cells should carry
frozen counts.

Representation: ``int64[..., 64]`` boards for ``state`` and the frozen
bit-planes (``frozen2/1/0``), mirroring the reference, so stepping stays on
the bit-parallel path.  Every function is batched over leading dims.
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple

import torch

from .core import board as B
from .core import convolve as conv
from .core import step as S
from .stable import complete as C
from .stable import host as HO
from .stable import options as opt
from .stable import propagate as P
from .target import LifeTarget


class LifeWeld(NamedTuple):
    state: torch.Tensor
    frozen2: torch.Tensor
    frozen1: torch.Tensor
    frozen0: torch.Tensor

    @staticmethod
    def from_state(state):
        e = torch.zeros_like(state)
        return LifeWeld(state, e, e, e)

    def all_frozen(self):
        """Reference LifeWeld.hpp:40."""
        return self.frozen2 | self.frozen1 | self.frozen0

    def __or__(self, other):
        return LifeWeld(*(p | q for p, q in zip(self, other)))

    def moved(self, dx, dy):
        """Translate every plane; ``dx``/``dy`` are ints, or integer tensors
        of per-board offsets (:func:`lifeapi_tpu_torch.core.board.move_dyn`)."""
        move = B.move_dyn if torch.is_tensor(dx) else B.move
        return LifeWeld(*(move(p, dx, dy) for p in self))

    def transformed(self, t):
        from .symmetry import transforms

        return LifeWeld(*(transforms.transform(p, t) for p in self))

    def equal(self, other):
        out = B.equal(self.state, other.state)
        for p, q in zip(self[1:], other[1:]):
            out = out & B.equal(p, q)
        return out


def from_required(state, required):
    """Strip stator cells, recording their neighbour contributions as
    frozen counts (reference ``FromRequired``, LifeWeld.hpp:133-159)."""
    active = B.zoi(state) & ~required
    stator = state & ~B.zoi(active)

    new_state = state & ~stator

    frozen = B.zoi(active) & required
    frozen = frozen | (S.step(new_state) & ~new_state)

    _, bit2, bit1, bit0 = S.neighbour_counts(stator)
    return LifeWeld(new_state, bit2 & frozen, bit1 & frozen, bit0 & frozen)


def step(weld: LifeWeld):
    """Count neighbours, ripple-add the frozen counts, apply B3/S23
    (reference ``Step``, LifeWeld.hpp:169-186)."""
    _, bit2, bit1, bit0 = S.neighbour_counts(weld.state)
    sum0, carry0 = S.half_add(bit0, weld.frozen0)
    sum1, carry1 = S.full_add(bit1, weld.frozen1, carry0)
    sum2, _ = S.full_add(bit2, weld.frozen2, carry1)
    new_state = (sum0 ^ sum2) & (sum1 ^ sum2) & (weld.state | sum0)
    return weld._replace(state=new_state)


def step_n(weld: LifeWeld, n):
    for _ in range(n):
        weld = step(weld)
    return weld


def to_target(weld: LifeWeld):
    """Recovery-detection target (reference ``ToTarget``,
    LifeWeld.hpp:188-191)."""
    non_frozen = weld.state & ~weld.all_frozen()
    return LifeTarget(weld.state, B.zoi(non_frozen) & ~weld.state)


def interaction_counts(weld: LifeWeld):
    """Reference LifeWeld.hpp:193-204: plain interaction counts masked to
    the non-frozen ZOI."""
    out1, out2, out_more = S.interaction_counts(weld.state)
    nf_zoi = B.zoi(weld.state & ~weld.all_frozen())
    return out1 & nf_zoi, out2 & nf_zoi, out_more & nf_zoi


def interaction_offsets(a: LifeWeld, b: LifeWeld, method=None):
    """Frozen-aware variant of InteractionOffsets (reference
    LifeWeld.hpp:206-245): interactions involving frozen boundary cells are
    ignored.  Routing as in
    :func:`lifeapi_tpu_torch.core.convolve.union_interacting`."""

    def masks(state):
        bit3, bit2, bit1, bit0 = S.neighbour_counts(state)
        out1 = ~bit3 & ~bit2 & ~bit1 & bit0
        out2 = ~bit3 & ~bit2 & bit1 & ~bit0
        out3 = ~bit3 & ~bit2 & bit1 & bit0
        ge1 = bit3 | bit2 | bit1 | bit0
        ge2 = bit3 | bit2 | bit1
        ge4 = bit2 | bit3
        return out1, out2, out3, ge1, ge2, ge4

    a_state = a.state
    a_ignored = ~B.zoi(a.state & ~a.all_frozen())
    a1, a2, a3, a_ge1, a_ge2, a_ge4 = masks(a_state)

    b_state = B.mirrored(b.state)
    b_ignored = ~B.mirrored(B.zoi(b.state & ~b.all_frozen()))
    b1, b2, b3, b_ge1, b_ge2, b_ge4 = masks(b_state)

    pairs = [
        (a_state, b_state),
        (a1 & ~a_state & ~a_ignored, b2 & ~b_state & ~a_ignored),
        (b1 & ~b_state & ~b_ignored, a2 & ~a_state & ~b_ignored),
        (a3 & a_state & ~a_ignored, b_ge2 & ~b_state & ~b_ignored),
        (a_ge4 & a_state & ~a_ignored, b_ge1 & ~b_state & ~b_ignored),
        (b3 & b_state & ~b_ignored, a_ge2 & ~a_state & ~a_ignored),
        (b_ge4 & b_state & ~b_ignored, a_ge1 & ~a_state & ~a_ignored),
    ]
    return conv.union_interacting(pairs, method=method)


def to_stable(weld: LifeWeld):
    """Convert to a partial still-life with option restrictions derived
    from the frozen counts (reference ``ToStable``, LifeWeld.hpp:279-325)."""
    sums = S.add_counts(S.neighbour_counts(weld.state),
                        (torch.zeros_like(weld.frozen2), weld.frozen2, weld.frozen1,
                         weld.frozen0))
    frozen = weld.all_frozen()
    nf_zoi = B.zoi(weld.state & ~frozen)

    state = B.to_dense(weld.state)
    st = P.make(state=state, unknown=torch.ones_like(state))
    st = P.set_on(st, state)
    st = P.set_off(st, B.to_dense(~weld.state & nf_zoi))

    # the sum includes the center square (reference LifeWeld.hpp:307)
    for count, keep in [(3, opt.LIVE2), (4, opt.LIVE3)]:
        cells = frozen & weld.state & S.with_exactly(sums, count)
        st = P.restrict_cells(st, B.to_dense(cells), keep)
    for count, keep in [(1, opt.DEAD1), (2, opt.DEAD2), (4, opt.DEAD4), (5, opt.DEAD5),
                        (6, opt.DEAD6)]:
        cells = frozen & ~weld.state & S.with_exactly(sums, count)
        st = P.restrict_cells(st, B.to_dense(cells), keep)
    return st


# (neighbours now, neighbours in the weld's own state, options kept) of a
# cell that stays dead through a generation (reference LifeWeld.hpp:366-395)
_STAY_DEAD = (
    (1, 0, 0xFF & ~opt.DEAD2), (2, 0, 0xFF & ~opt.DEAD1), (2, 1, 0xFF & ~opt.DEAD2),
    (1, 2, 0xFF & ~opt.DEAD4), (0, 2, 0xFF & ~opt.DEAD5),
    (3, 4, 0xFF & ~opt.DEAD4), (2, 4, 0xFF & ~opt.DEAD5), (1, 4, 0xFF & ~opt.DEAD6),
    (3, 5, 0xFF & ~opt.DEAD5), (2, 5, 0xFF & ~opt.DEAD6),
    (3, 6, 0xFF & ~opt.DEAD6),
)


def to_stable_with_history(weld: LifeWeld, active, duration, mask=None):
    """Replay a reaction for ``duration`` steps, restricting stable options
    so required births happen and spurious ones don't (reference
    ``ToStable(active, duration, mask)``, LifeWeld.hpp:327-400)."""
    if mask is None:
        mask = B.full(device=weld.state.device)

    st = to_stable(weld)

    # pass 1: region that was ever active
    ever_active = torch.zeros_like(weld.state)
    current = weld._replace(state=weld.state | active)
    for _ in range(duration):
        ever_active = ever_active | (weld.state ^ current.state)
        current = step(current)

    st = P.set_off(st, B.to_dense(mask & ~weld.state & ever_active))

    # pass 2: births must happen, spurious ones must not
    state_counts = S.neighbour_counts(weld.state)
    state_is = {n: S.with_exactly(state_counts, n) for n in range(7)}
    current = weld._replace(state=weld.state | active)
    for _ in range(duration):
        nxt = step(current)
        stay_dead = ~weld.state & ~current.state & ~nxt.state
        gets_born = ~weld.state & ~current.state & nxt.state
        cur_counts = S.neighbour_counts(current.state)
        born3 = gets_born & S.with_exactly(cur_counts, 3)

        def restrict(st, cells, keep):
            return P.restrict_cells(st, B.to_dense(mask & cells), keep)

        for n, keep in ((0, opt.DEAD0), (1, opt.DEAD1), (2, opt.DEAD2)):
            st = restrict(st, born3 & state_is[n], keep)
        for now, own, keep in _STAY_DEAD:
            st = restrict(st, stay_dead & S.with_exactly(cur_counts, now) & state_is[own],
                          keep)
        current = nxt
    return st


def _build_placements(a: LifeWeld, b: LifeWeld, xy):
    """Per-offset welded stable problems: ``to_stable(a | b moved by o)``
    for every row o of the integer tensor ``xy`` [P, 2], in one batched
    call."""
    return to_stable(a | b.moved(xy[:, 0], xy[:, 1]))


def unweldable_mask(a: LifeWeld, b: LifeWeld, starting_good=None, starting_bad=None,
                    solve_timeout=0.05, engine="host", batch_size=256, beam_frontier=4,
                    beam_iters=48, escalate=True, escalate_frontier=8,
                    escalate_dfs_timeout=None, escalate_dfs_wall_budget=4.0,
                    return_stats=False):
    """For every untested relative placement, weld the two patterns and try
    to complete a stable background; INCONSISTENT placements are bad — an
    expensive compatibility prefilter (reference ``UnweldableMask``,
    LifeWeld.hpp:247-277).

    ``engine="host"`` is the faithful counterpart of the reference loop:
    one DFS completion per offset with a ``solve_timeout`` budget.
    ``engine="beam"``: all untested placements become one batched
    still-life problem set solved by ``complete_stable_beam`` in chunks of
    ``batch_size``; a placement is marked bad only on a sound
    inconsistency proof (``BeamResult.proved_inconsistent``), so every mark
    is correct.  ``stats['tier1_residue']`` counts the placements the first
    pass neither completes nor refutes.

    With ``escalate`` (default), that residue is re-run with a deep
    ``escalate_frontier``-wide beam, and what remains falls back to a host
    DFS, ``complete_stable(strict=True)`` (so a ring-restricted
    INCONSISTENT degrades to TIMEOUT and every mark refutes the full
    instance).  The DFS is staged: every instance first gets 5% of the
    per-instance budget (``escalate_dfs_timeout``, default
    ``solve_timeout``), then stage-A timeouts get the full budget.  Both
    stages share ``escalate_dfs_wall_budget`` seconds of wall clock (None =
    unlimited); instances skipped at the wall are counted in
    ``stats['tier3_wall_budget_skipped']`` and warned about unless
    ``return_stats=True``, which returns ``(mask, stats)``."""
    dev = a.state.device
    known_good = starting_good if starting_good is not None else B.empty(device=dev)
    known_bad = interaction_offsets(a, b)
    if starting_bad is not None:
        known_bad = known_bad | starting_bad

    to_test = ~known_good & ~known_bad
    bad_dense = B.to_dense(known_bad).cpu().numpy().copy()
    offsets = B.on_cells(to_test)

    def mask():
        return B.from_dense(torch.from_numpy(bad_dense)).to(dev)

    def build(xy):
        return _build_placements(a, b, torch.tensor(xy, dtype=torch.int64, device=dev))

    if engine == "beam":
        stats = {"placements": len(offsets), "tier1_residue": 0,
                 "tier2_proved": 0, "tier2_completed": 0,
                 "tier3_instances": 0, "tier3_stage_a_determined": 0,
                 "tier3_full_determined": 0, "tier3_wall_budget_skipped": 0}
    else:
        stats = {"placements": len(offsets), "host_determined": 0, "host_marked_bad": 0}
    if not offsets:
        return (mask(), stats) if return_stats else mask()

    def beam(chunk, frontier, iters):
        res = C.complete_stable_beam(build(chunk), frontier=frontier, iters=iters,
                                     minimise=False, return_boards=False)
        return res.proved_inconsistent.cpu().numpy(), res.found.cpu().numpy()

    if engine == "beam":
        undetermined = []
        for lo in range(0, len(offsets), batch_size):
            chunk = offsets[lo:lo + batch_size]
            proved, found = beam(chunk, beam_frontier, beam_iters)
            for i, (x, y) in enumerate(chunk):
                if proved[i]:
                    bad_dense[x, y] = True
                elif not found[i]:
                    undetermined.append((x, y))
        stats["tier1_residue"] = len(undetermined)

        if escalate and undetermined:
            # tier 2: wider frontier, deeper, just on the residue (lane
            # budget held at batch_size * beam_frontier); completions matter
            # as much as proofs here, since each one is a placement the
            # tier-3 DFS need not time out on
            cap = max(1, (batch_size * beam_frontier) // escalate_frontier)
            deep_iters = max(512, 4 * beam_iters)
            residue = []
            for lo in range(0, len(undetermined), cap):
                chunk = undetermined[lo:lo + cap]
                proved, found = beam(chunk, escalate_frontier, deep_iters)
                for i, (x, y) in enumerate(chunk):
                    if proved[i]:
                        bad_dense[x, y] = True
                        stats["tier2_proved"] += 1
                    elif found[i]:
                        stats["tier2_completed"] += 1
                    else:
                        residue.append((x, y))
            if residue:
                _tier3(residue, build, bad_dense, stats, solve_timeout,
                       escalate_dfs_timeout, escalate_dfs_wall_budget)
        if stats["tier3_wall_budget_skipped"] and not return_stats:
            warnings.warn(
                f"unweldable_mask: {stats['tier3_wall_budget_skipped']} tier-3 DFS "
                f"instances skipped at the {escalate_dfs_wall_budget} s wall budget; "
                f"pass escalate_dfs_wall_budget=None for full per-instance parity or "
                f"return_stats=True for details", stacklevel=2)
        return (mask(), stats) if return_stats else mask()

    # host engine (reference-faithful loop, LifeWeld.hpp:256-274): build
    # the problems in batches, read them back, DFS on numpy
    for lo in range(0, len(offsets), batch_size):
        chunk = offsets[lo:lo + batch_size]
        for (x, y), host_st in zip(chunk, _host_problems(build(chunk))):
            result, _ = C.complete_stable(host_st, timeout=solve_timeout, minimise=False)
            if result != C.CompletionResult.TIMEOUT:
                stats["host_determined"] += 1
            if result == C.CompletionResult.INCONSISTENT:
                bad_dense[x, y] = True
                stats["host_marked_bad"] += 1
    return (mask(), stats) if return_stats else mask()


def _host_problems(sts):
    """A batch of dense problems -> one HostStable each."""
    states, unknowns, ruleds = (t.cpu().numpy() for t in sts)
    return [HO.HostStable(s, u, r) for s, u, r in zip(states, unknowns, ruleds)]


def _tier3(residue, build, bad_dense, stats, solve_timeout, dfs_timeout, wall_budget):
    """Staged strict host DFS on what the beam tiers left open: stage A runs
    every instance at 5% of the budget (refutations are near-instant
    propagations), stage B gives stage-A timeouts the full budget; both
    share ``wall_budget`` seconds, and skips are counted."""
    stats["tier3_instances"] = len(residue)
    budget = solve_timeout if dfs_timeout is None else dfs_timeout
    problems = _host_problems(build(residue))

    def dfs(i, timeout):
        # strict: a ring-restricted INCONSISTENT degrades to TIMEOUT, so
        # every tier-3 mark is a sound refutation of the full instance
        return C.complete_stable(problems[i].copy(), timeout=timeout, minimise=False,
                                 strict=True)[0]

    t_wall = time.monotonic()

    def wall_left():
        if wall_budget is None:
            return float("inf")
        return wall_budget - (time.monotonic() - t_wall)

    stage_b = []
    for i, (x, y) in enumerate(residue):
        if wall_left() <= 0:
            stats["tier3_wall_budget_skipped"] += len(residue) - i + len(stage_b)
            stage_b = []
            break
        result = dfs(i, budget * 0.05)
        if result == C.CompletionResult.INCONSISTENT:
            bad_dense[x, y] = True
        if result == C.CompletionResult.TIMEOUT:
            stage_b.append((i, x, y))
        else:
            stats["tier3_stage_a_determined"] += 1

    for n, (i, x, y) in enumerate(stage_b):
        if wall_left() <= 0:
            stats["tier3_wall_budget_skipped"] += len(stage_b) - n
            break
        result = dfs(i, budget)
        if result == C.CompletionResult.INCONSISTENT:
            bad_dense[x, y] = True
        if result != C.CompletionResult.TIMEOUT:
            stats["tier3_full_determined"] += 1


def to_bellman_rle(weld: LifeWeld, active=None):
    """Reference ``BellmanRLE`` (LifeWeld.hpp:121-131)."""
    from .core import rle as rle_mod

    if active is None:
        active = B.empty(device=weld.state.device)
    frozen = weld.all_frozen()
    marked = B.zoi(weld.state & frozen) & ~B.zoi(weld.state & ~frozen)
    a, s, m = (B.to_dense(p).cpu().numpy() for p in (active, weld.state, marked))

    def char(x, y):
        if a[x, y] and not s[x, y]:
            return "A"
        if s[x, y]:
            return "C"
        if m[x, y]:
            return "E"
        return "."

    return rle_mod.write_rle_planes(char)


def to_history(weld: LifeWeld):
    """Debug view (reference ``ToHistory``, LifeWeld.hpp:402-404)."""
    from .history import LifeHistory

    return LifeHistory.create(state=weld.state, marked=weld.all_frozen())
