"""Still-life completion search: find a stable background consistent with a
partial board.

Counterpart of :mod:`lifeapi_tpu.stable.complete`.  Two engines with the
same result contract as the reference ``CompleteStable``
(LifeStable.hpp:1340-1458: return *a* valid still life, minimal population
when ``minimise``):

* :func:`complete_stable` — host-side DFS branch-and-bound, a faithful
  counterpart of the reference recursion, running on the NumPy kernel
  mirror (carried over unchanged).  The correctness oracle and the
  single-problem API.
* :func:`complete_stable_beam` — the batched engine: a frontier (beam)
  search where thousands of branch candidates advance per round.  A CUDA
  tensor runs the whole search in one kernel launch
  (:func:`lifeapi_tpu_torch.ops.stable_cuda.beam_search`), a CPU tensor
  its plain twin.
"""

from __future__ import annotations

import enum
import time
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve
from . import options as opt
from .host import HostStable, big_zoi, count9, zoi


class CompletionResult(enum.Enum):
    COMPLETED = 0
    INCONSISTENT = 1
    TIMEOUT = 2


def _first_on(mask):
    xs, ys = np.nonzero(mask)
    if len(xs) == 0:
        return None
    return int(xs[0]), int(ys[0])


def _branch_cell(st: HostStable, settable):
    """Branch-cell heuristic (reference LifeStable.hpp:1377-1391):
    vulnerable first, then cells with exactly 2 then 3 unknowns in their
    window, then anything settable."""
    cell = _first_on(st.vulnerable() & settable)
    if cell is not None:
        return cell
    unk9 = count9(st.unknown)
    cell = _first_on(settable & (unk9 == 2))
    if cell is not None:
        return cell
    cell = _first_on(settable & (unk9 == 3))
    if cell is not None:
        return cell
    return _first_on(settable)


def _branch_cell_win(st: HostStable, sett_w, xs, ys):
    """Windowed ``_branch_cell``: every settable cell lies in the window
    bbox (>= 2 cells from the window edge), where the window-local
    counts and vulnerability bits are exact; candidate ordering matches
    the full-board raw-index order because no candidate exists outside
    the window.  Returns full-board coordinates."""
    def first(mask):
        cell = _first_on(mask)
        if cell is None:
            return None
        return cell[0] + xs.start, cell[1] + ys.start

    cell = first(st.vulnerable_win(xs, ys) & sett_w)
    if cell is not None:
        return cell
    unk9 = count9(st.unknown[xs, ys])
    cell = first(sett_w & (unk9 == 2))
    if cell is not None:
        return cell
    cell = first(sett_w & (unk9 == 3))
    if cell is not None:
        return cell
    return first(sett_w)


class _Search:
    def __init__(self, deadline, minimise, use_seed, seed):
        self.deadline = deadline
        self.minimise = minimise
        self.use_seed = use_seed
        self.seed = seed
        self.best = None
        self.max_pop = np.inf

    def step(self, st: HostStable):
        """Reference ``CompleteStableStep`` (LifeStable.hpp:1340-1412)."""
        while True:  # manual tail call for the ON branch (:1409)
            if time.monotonic() > self.deadline:
                return CompletionResult.TIMEOUT
            ok, _ = st.propagate()
            if not ok:
                return CompletionResult.INCONSISTENT

            current_pop = int(st.state.sum())
            if current_pop >= self.max_pop:
                return CompletionResult.COMPLETED

            win = None if self.use_seed else st.query_window()
            if win is not None and win[0].stop > win[0].start:
                # windowed branch queries (reference strip-kernel
                # counterpart, LifeStable.hpp:731-1249): settable cells
                # all live in the window's bbox, where window-local
                # counts are exact
                xs, ys = win
                rl = st.ruled[xs, ys]
                sett_w = ((rl != 0) & st.unknown[xs, ys]
                          & zoi((rl & opt.DEAD0) != 0))
                if not sett_w.any():
                    self.best = st.state.copy()
                    self.max_pop = current_pop
                    return CompletionResult.COMPLETED
                cell = _branch_cell_win(st, sett_w, xs, ys)
            else:
                dead0_ruled = (st.ruled & opt.DEAD0) != 0
                settable = st.perturbed_unknowns() & zoi(dead0_ruled)
                if not settable.any():
                    self.best = st.state.copy()
                    self.max_pop = current_pop
                    return CompletionResult.COMPLETED

                if self.use_seed:
                    seed_zoi = self.seed.copy()
                    while not (settable & seed_zoi).any():
                        seed_zoi = zoi(seed_zoi)
                    settable = settable & seed_zoi

                cell = _branch_cell(st, settable)
            if cell is None:
                return CompletionResult.INCONSISTENT

            mask = np.zeros_like(st.state)
            mask[cell] = True

            off_branch = st.copy()
            off_branch.set_off(mask)
            result = self.step(off_branch)
            if result == CompletionResult.TIMEOUT:
                return CompletionResult.TIMEOUT
            if not self.minimise and result == CompletionResult.COMPLETED:
                return CompletionResult.COMPLETED

            st.set_on(mask)
            # loop = tail recursion on the ON branch


def complete_stable(st: HostStable, timeout=1.0, minimise=False, use_seed=False,
                    seed=None, strict=False):
    """Reference ``CompleteStable`` (LifeStable.hpp:1414-1458).  Returns
    (CompletionResult, dense bool[64, 64] best still life).

    ``strict``: the reference's ring-growing loop can break on a spent
    budget while holding an INCONSISTENT verdict from a ring-RESTRICTED
    search area — restricting unknowns to the ring forces outside cells
    OFF, so that verdict does not refute the full instance (the round-4
    "DFS marks are budget artifacts" measurement).  With ``strict=True``
    such a verdict degrades to TIMEOUT; INCONSISTENT is then always a
    sound refutation of the full instance.  Default False = faithful
    reference semantics."""
    empty = np.zeros((64, 64), bool)
    if not st.state.any():
        return CompletionResult.COMPLETED, empty
    if not st.unknown.any():
        return CompletionResult.COMPLETED, st.state.copy()

    deadline = time.monotonic() + timeout
    search = _Search(deadline, minimise, use_seed, seed if seed is not None else empty)

    result = CompletionResult.TIMEOUT
    restricted = False
    search_area = zoi(st.state)
    while (st.unknown & ~search_area).any():
        search_area = zoi(search_area)
        copy = st.copy()
        copy.unknown &= search_area
        # direct mutation of ``unknown`` must invalidate the propagation
        # cache: a caller may pass an already-propagated HostStable, and
        # the ring restriction converts unknown->known-off cells OUTSIDE
        # the window the next (windowed) propagate would compute from the
        # shrunken bbox (round-4 advisor finding)
        copy.invalidate()
        restricted = bool((st.unknown & ~search_area).any())
        result = search.step(copy)
        if (search.best is not None and search.best.any()) or time.monotonic() > deadline:
            break
    else:
        copy = st.copy()
        restricted = False
        result = search.step(copy)

    if (strict and restricted
            and result == CompletionResult.INCONSISTENT):
        result = CompletionResult.TIMEOUT

    best_empty = search.best is None or not search.best.any()
    if result == CompletionResult.TIMEOUT and best_empty:
        return CompletionResult.TIMEOUT, empty
    if result == CompletionResult.INCONSISTENT and best_empty:
        return CompletionResult.INCONSISTENT, empty

    if minimise:
        # re-minimise in a little more space (reference uses the BigZOI
        # dilation of the search area, LifeStable.hpp:1451-1456)
        copy = st.copy()
        copy.unknown &= big_zoi(search_area)
        copy.invalidate()
        search.use_seed = True
        search.seed = st.state | (search.best if search.best is not None else empty)
        search.step(copy)

    return CompletionResult.COMPLETED, (
        search.best if search.best is not None else empty
    )


# ---------------------------------------------------------------------------
# Batched beam search
# ---------------------------------------------------------------------------


class BeamResult(NamedTuple):
    found: "torch.Tensor"  # bool[B]
    best: "torch.Tensor"  # bool[B, 64, 64] (dense) or int64[B, 64]; None without boards
    best_pop: "torch.Tensor"  # int32[B]
    # True iff the search ran to exhaustion WITHOUT ever dropping an
    # active candidate (frontier never overflowed) and found nothing: a
    # sound proof the instance has no completion (reference
    # ``CompletionResult::INCONSISTENT``, LifeStable.hpp:186-190).
    proved_inconsistent: "torch.Tensor" = None  # bool[B]


def _problem_planes(stable, simple_phase):
    """A dense ``propagate.Stable`` or a ``bitplane.BitStable`` with one
    batch dim -> contiguous ``int64[B, 10, 64]`` planes."""
    from ..ops import stable_cuda as SC
    from . import bitplane as BP

    SC._no_simple_phase(simple_phase)
    bst = stable if isinstance(stable.ruled, tuple) else BP.from_dense_stable(stable)
    return BP.to_planes(bst).contiguous()


def complete_stable_beam(stable, frontier=8, iters=192, minimise=True, dense=True,
                         seed=None, init_bound=None, return_boards=True,
                         simple_phase=False):
    """Batched frontier search over ``[B]`` independent problems.

    Each problem keeps a frontier of up to ``frontier`` candidate partial
    boards; every round propagates all candidates to their fixpoint,
    records completed leaves into a per-problem incumbent
    (population-minimal if ``minimise``), and replaces each active
    candidate by its OFF/ON children on the heuristically chosen branch
    cell.  Children beyond capacity are kept by lowest population.  This
    trades the reference's DFS order for breadth (SURVEY.md section 7).
    The device of ``stable`` decides the engine: CUDA runs the search in
    one kernel launch, CPU its plain twin; both make the same decisions.

    ``dense=False`` returns ``best`` as ``int64[B, 64]`` boards instead of
    dense bools.  ``seed`` (``int64[B, 64]`` or one ``int64[64]`` board)
    enables the reference's seed-proximity branching (``useSeed``,
    LifeStable.hpp:1366-1375): branch cells are restricted to the smallest
    ZOI-dilation of the seed that touches the settable set.
    ``init_bound`` (int or ``int32[B]``) starts from a known incumbent
    population: only strictly smaller completions count as found.
    ``return_boards=False`` returns ``best=None``.  ``simple_phase`` is a
    TPU speed knob the port does not carry: True raises.
    """
    from ..core import board as BRD
    from ..ops import stable_cuda as SC

    planes = _problem_planes(stable, simple_phase)
    b, dev = planes.shape[0], planes.device
    seed_t = (None if seed is None
              else seed.to(dev, torch.int64).expand(b, 64).contiguous())
    bound_t = (None if init_bound is None
               else torch.as_tensor(init_bound, dtype=torch.int32, device=dev)
               .expand(b).contiguous())
    best, best_pop, found, complete, exhausted = SC.beam_search(
        planes, frontier=frontier, iters=iters, minimise=minimise, seed=seed_t,
        bound=bound_t)
    proved = exhausted & complete & ~found
    if not return_boards:
        return BeamResult(found, None, best_pop, proved)
    return BeamResult(found, BRD.to_dense(best) if dense else best, best_pop, proved)


def complete_stable_beam_queued(stable, chunk=8192, frontier=4, iters=24,
                                minimise=True, simple_phase=False):
    """Beam completion of a large problem set, with the results of
    per-chunk ``complete_stable_beam(return_boards=False)`` calls
    (found / best_pop / proved only).

    Problems are independent, so on a CUDA device the kernel takes the
    whole set in one launch (one block per problem; nothing on the card
    is chunk-sized).  On the CPU the plain twin runs ``chunk`` problems at
    a time, which bounds its working set.  An empty set gives empty
    results (the JAX package's version divides by zero there)."""
    from ..ops import stable_cuda as SC

    planes = _problem_planes(stable, simple_phase)
    chunk = int(chunk)
    if chunk <= 0:
        raise ValueError(f"chunk {chunk} must be positive")
    b, dev = planes.shape[0], planes.device
    if b == 0:
        none = torch.zeros(0, dtype=torch.bool, device=dev)
        return BeamResult(none, None, torch.zeros(0, dtype=torch.int32, device=dev), none)
    parts = [SC.beam_search(p.contiguous(), frontier=frontier, iters=iters,
                            minimise=minimise)
             for p in planes.split(b if planes.is_cuda else chunk)]
    _, best_pop, found, complete, exhausted = (
        torch.cat(col) for col in zip(*parts))
    return BeamResult(found, None, best_pop, exhausted & complete & ~found)


# ---------------------------------------------------------------------------
# Single-hard-instance portfolio search
# ---------------------------------------------------------------------------


class PortfolioResult(NamedTuple):
    found: bool
    best: "torch.Tensor"  # int64[64] board (original orientation)
    best_pop: int
    found_fraction: float  # fraction of replicas that found a completion


def draw_offsets(generator, replicas, device=None):
    """Per-replica random torus translations ``(dx, dy)``, each
    ``int64[replicas]`` in [0, 64), drawn on the generator's device and
    moved to ``device``."""
    dev = resolve(device)
    d = torch.randint(0, 64, (2, replicas), generator=generator, device=generator.device)
    return d[0].to(dev), d[1].to(dev)


def _build_replicas(state, unknown, dx, dy):
    """Replica boards for one instance: the 16 symmetry transforms cycled
    over the replica axis, then per-replica torus translations.  Returns
    ``int64[R, 64]`` state and unknown."""
    from ..core import board as BRD
    from ..symmetry import transforms as TR

    st16 = torch.stack([TR.transform(state, t) for t in range(16)])
    un16 = torch.stack([TR.transform(unknown, t) for t in range(16)])
    idx = torch.arange(dx.shape[0], device=state.device) % 16
    return BRD.move_dyn(st16[idx], dx, dy), BRD.move_dyn(un16[idx], dx, dy)


def _portfolio_champion(res, dx, dy):
    """Back-transform the best replica's board to the original
    orientation; returns (best_pop, champion board) or (None, None)."""
    found = res.found.cpu().numpy()
    if not found.any():
        return None, None
    pops = np.where(found, res.best_pop.cpu().numpy(), np.iinfo(np.int32).max)
    i = int(np.argmin(pops))
    return int(pops[i]), _unreplicate(res.best[i], i, dx, dy)


def _unreplicate(board, i, dx, dy):
    """Replica ``i``'s board in the instance's own orientation: undo the
    translation and symmetry transform of :func:`_build_replicas`."""
    from ..core import board as BRD
    from ..symmetry import transforms as TR

    back = BRD.move(board, -int(dx[i]), -int(dy[i]))
    return TR.transform(back, TR.transform_inverse(i % 16))


def complete_stable_portfolio(state, unknown, generator=None, replicas=256, frontier=4,
                              iters=192, minimise=True, reminimise=True, explore=False,
                              dfs_polish_timeout=None):
    """ONE hard completion problem searched by ``replicas`` randomized beam
    replicas in one batched beam call (the counterpart of the reference's
    deep single-instance DFS, LifeStable.hpp:1340-1412).

    Replica r solves the instance transformed by symmetry transform
    ``r % 16`` composed with a random torus translation.  Life stability is
    invariant under the D8 transforms and translations, so solutions map
    back exactly; the lexicographic first-cell branch heuristic sees a
    different coordinate order per replica, so the replicas explore
    different branch sequences, like randomized DFS restarts.

    ``reminimise`` (with ``minimise``) runs a second seeded pass after a
    champion is found (the reference's BigZOI re-search,
    LifeStable.hpp:1451-1456): unknowns restricted to
    ``big_zoi(state | champion)``, branch cells to the champion's
    proximity, only strictly smaller completions counted.  ``explore``
    runs one more pass over fresh translations and the full unknown area,
    bounded by the champion.  ``dfs_polish_timeout`` ends with a host DFS
    bounded by the champion's population (only strict improvements).

    ``state``/``unknown``: ``int64[64]`` boards.  The translations are
    drawn from ``generator`` (:func:`draw_offsets`).  Returns the
    back-transformed best completion over all replicas.
    """
    from ..core import board as BRD
    from . import bitplane as BP

    dev = state.device
    dx, dy = draw_offsets(generator, replicas, dev)

    def search(unknown_r, dx, dy, seed=None, **kw):
        st_r, un_r = _build_replicas(state, unknown_r, dx, dy)
        if seed is not None:
            seed = _build_replicas(seed, unknown_r, dx, dy)[0]
        res = complete_stable_beam(BP.make(state=st_r, unknown=un_r), frontier=frontier,
                                   iters=iters, dense=False, seed=seed, **kw)
        return res, _portfolio_champion(res, dx, dy)

    res, (best_pop, champ) = search(unknown, dx, dy, minimise=minimise)
    if champ is None:
        return PortfolioResult(False, BRD.empty(device=dev), 0, 0.0)
    found_fraction = float(res.found.float().mean())

    if minimise and reminimise:
        seed_board = state | champ
        _, (pop2, champ2) = search(unknown & BRD.big_zoi(seed_board), dx, dy,
                                   seed=seed_board, minimise=True, init_bound=best_pop)
        if pop2 is not None and pop2 < best_pop:
            best_pop, champ = pop2, champ2

    if minimise and explore:
        # a pass over fresh translations with the full unknown area open and
        # the champion as the bound: replicas prune as soon as they exceed
        # it (the DFS's global max_pop bound, LifeStable.hpp:1353-1356)
        dx3, dy3 = draw_offsets(generator, replicas, dev)
        _, (pop3, champ3) = search(unknown, dx3, dy3, minimise=True, init_bound=best_pop)
        if pop3 is not None and pop3 < best_pop:
            best_pop, champ = pop3, champ3

    if minimise and dfs_polish_timeout:
        best_pop, champ = _dfs_polish(state, unknown, best_pop, champ, dfs_polish_timeout)

    return PortfolioResult(True, champ, best_pop, found_fraction)


def _dfs_polish(state, unknown, best_pop, champ, timeout):
    """An incumbent-bounded host DFS: max_pop = the champion's population,
    so only strict improvements are explored (reference
    LifeStable.hpp:1353-1356).  Returns (best_pop, champion), the DFS's
    completion where it is smaller, on ``state``'s device."""
    from ..core import board as BRD

    hst = HostStable(state=BRD.to_dense(state).cpu().numpy(),
                     unknown=BRD.to_dense(unknown).cpu().numpy())
    polish = _Search(time.monotonic() + float(timeout), True, False,
                     np.zeros((64, 64), bool))
    polish.max_pop = int(best_pop)
    polish.step(hst)
    if polish.best is not None and polish.best.any():
        pop = int(polish.best.sum())
        if pop < best_pop:
            return pop, BRD.from_dense(torch.from_numpy(polish.best)).to(state.device)
    return best_pop, champ
