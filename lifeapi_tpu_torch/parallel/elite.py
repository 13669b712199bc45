"""Sharded scenario sweeps and searches with cross-device elite selection
(counterpart of :mod:`lifeapi_tpu.parallel.elite`).

The multi-host search pattern of the north star: scenarios and candidate
controls are sharded over the mesh, every rank optimizes its local
candidates, hard-scores them bit-exactly, takes a local top-k, and the
elite set is exchanged with one small all-gather.

Every rank is called with the *global* inputs, as a JAX caller passes
global arrays, and takes its own contiguous block: on a batch sharded over
both mesh dimensions, rank r (mesh coordinate ``(r // n_candidate, r %
n_candidate)``) holds block r.  Outputs that the JAX package returns
sharded over both dimensions are gathered back to the global batch on
every rank.  Collectives map one to one: a tiled ``all_gather`` over both
dimensions is an all-gather over the world, ``pmin`` an ``all_reduce(MIN)``
and ``psum`` an ``all_reduce(SUM)`` on the named dimension's group.

Each shard runs the port's own entry points, so on the card the shards run
the hand-written kernels: the rollout [1] (:func:`sharded_rollout`), the
controlled rollout [2] (the MPC runners' hard scoring), the catalyst
rollout [3] (:func:`sharded_catalyst_search`) and the whole beam search
[10] (:func:`sharded_beam_complete`, :func:`sharded_portfolio`).
Nothing is built per call.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import CANDIDATE_AXIS, SCENARIO_AXIS

SENTINEL = 5000  # a key above any population (at most 4096)


# ---------------------------------------------------------------------------
# Mesh plumbing
# ---------------------------------------------------------------------------


def _device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _place(mesh):
    """(rank, size): this process's block index over both dimensions and
    the number of blocks.  The mesh must span the world in rank order, as
    :func:`~lifeapi_tpu_torch.parallel.mesh.make_mesh` builds it, so that
    a world all-gather concatenates the blocks in order."""
    coord = mesh.get_coordinate()
    n_candidate = mesh.shape[1]
    if coord is None or mesh.size() != dist.get_world_size() \
            or coord[0] * n_candidate + coord[1] != dist.get_rank():
        raise ValueError("the mesh must span every process in rank order (make_mesh)")
    return dist.get_rank(), mesh.size()


def _span(total, n, i, what):
    if total % n or total == 0:
        raise ValueError(f"{what}: {total} rows do not split into {n} non-empty blocks")
    size = total // n
    return slice(i * size, (i + 1) * size)


# The tensor form of the all-gather: ``all_gather_single`` where torch has
# it (it deprecates ``all_gather_into_tensor`` in its favour), else
# ``all_gather_into_tensor``.  Both write every rank's block into one output.
_all_gather_tensor = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather(t, group=None):
    """Tiled all-gather: every rank's block of ``group``, concatenated in
    rank order (``jax.lax.all_gather(..., tiled=True)``) into one output
    tensor.  Booleans travel as uint8."""
    if t.dtype == torch.bool:
        return _gather(t.to(torch.uint8), group).bool()
    t = t.contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0], *t.shape[1:]))
    _all_gather_tensor(out, t, group=group)
    return out


def _reduce(t, op, group=None):
    """``all_reduce`` of a copy of ``t``, returned."""
    t = t.clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def local_topk(costs, k):
    """(values, indices) of the k lowest costs, ties in index order (as
    ``jax.lax.top_k`` of the negated costs)."""
    idx = torch.argsort(costs, stable=True)[:k]
    return costs[idx], idx


# ---------------------------------------------------------------------------
# MPC runners (kernel [2] through hard_score_batch)
# ---------------------------------------------------------------------------


def sharded_candidate_solve(problem, logits0, mesh, iters=60, topk=4, lr=0.15):
    """Optimize candidates sharded over BOTH mesh dimensions for a single
    problem; return the globally best controls and costs.

    ``logits0``: ``[C, T, 64, 64]`` with C divisible by the mesh size.  Flow
    per rank: gradient-optimize the local block -> binarize + hard-score ->
    local top-k -> all-gather the elites -> global argmin.  Returns
    (best cost, best control probabilities ``[T, 64, 64]``, the hard costs
    ``[C]`` of every candidate)."""
    from ..mpc import solver

    rank, n = _place(mesh)
    local = logits0[_span(logits0.shape[0], n, rank, "logits0")].to(_device(mesh))
    logits, _ = solver.solve_gradient(local, problem, iters=iters, lr=lr)
    probs = torch.sigmoid(logits) * problem.control_mask
    costs, _ = solver.hard_score_batch(probs, problem)

    vals, idx = local_topk(costs, min(topk, costs.shape[0]))
    all_vals = _gather(vals)
    all_probs = _gather(probs[idx])
    best = torch.argmin(all_vals)
    return all_vals[best], all_probs[best], _gather(costs)


def sharded_scenario_sweep(problems_initial, target, horizon, control_mask, mesh,
                           generator, candidates_per_scenario=8, iters=40, weights=None):
    """Many scenarios (initial boards) sharded over the scenario dimension,
    each with a candidate population sharded over the candidate dimension.
    Returns (per-scenario best hard costs ``[S]``, the global champion's
    cost).

    ``problems_initial``: boards ``int64[S, 64]``, S divisible by the
    scenario dimension's size; the initial logits of all S x C candidates
    are drawn from ``generator`` (:func:`~lifeapi_tpu_torch.mpc.solver.init_logits`)."""
    from ..mpc import cost as cost_mod
    from ..mpc import solver

    weights = weights or cost_mod.CostWeights()
    S, C = problems_initial.shape[0], candidates_per_scenario
    first = solver.MPCProblem(problems_initial[0].to(_device(mesh)), target, horizon,
                              control_mask, weights=weights)
    logits0 = solver.init_logits(generator, first, S * C).reshape(S, C, horizon, 64, 64)
    return _scenario_sweep(problems_initial, target, horizon, control_mask, mesh,
                           logits0, iters, weights)


def _scenario_sweep(problems_initial, target, horizon, control_mask, mesh, logits0,
                    iters, weights):
    """:func:`sharded_scenario_sweep` from given initial logits
    ``[S, C, T, 64, 64]``."""
    from ..mpc import solver

    _place(mesh)
    dev = _device(mesh)
    (n_scenario, n_candidate), (s, c) = mesh.shape, mesh.get_coordinate()
    rows = _span(problems_initial.shape[0], n_scenario, s, "scenarios")
    cols = _span(logits0.shape[1], n_candidate, c, "candidates_per_scenario")
    best = []
    for initial, logits in zip(problems_initial[rows].to(dev), logits0[rows, cols].to(dev)):
        problem = solver.MPCProblem(initial, target, horizon, control_mask, weights=weights)
        lg, _ = solver.solve_gradient(logits, problem, iters=iters)
        costs, _ = solver.hard_score_batch(torch.sigmoid(lg) * control_mask, problem)
        best.append(costs.min())
    # combine the candidate blocks within each scenario, then the scenarios
    local = _reduce(torch.stack(best), dist.ReduceOp.MIN, mesh.get_group(CANDIDATE_AXIS))
    per_scenario = _gather(local, mesh.get_group(SCENARIO_AXIS))
    return per_scenario, per_scenario.min()


# ---------------------------------------------------------------------------
# Still-life beam runners (kernel [10])
# ---------------------------------------------------------------------------


def _slice_stable(bst, rows, dev):
    from ..stable import bitplane as BP

    return BP.BitStable(bst.state[rows].to(dev), bst.unknown[rows].to(dev),
                        tuple(r[rows].to(dev) for r in bst.ruled))


def _shard_beam(bst_local, frontier, iters, minimise, init_bound=None):
    """One rank's beam search: (found, best int64[b, 64], pop, proved)."""
    from ..stable import complete as C

    res = C.complete_stable_beam(bst_local, frontier=frontier, iters=iters,
                                 minimise=minimise, dense=False, init_bound=init_bound)
    return res.found, res.best, res.best_pop, res.proved_inconsistent


def _exchange(found, best, pop, rank, n):
    """The globally minimal-population completion over every rank: a
    ``pmin`` of a rank-unique key picks one winner, which alone contributes
    its board to a ``psum``.  Returns (champion board, champion population
    int64[1], whether this rank won, the winner's local index)."""
    key = torch.where(found, pop.to(torch.int64).clamp(max=SENTINEL), SENTINEL)
    li = torch.argmin(key)
    combined = (key[li] * n + rank).reshape(1)
    gmin = _reduce(combined, dist.ReduceOp.MIN)
    win = combined == gmin
    champ = _reduce(torch.where(win, best[li], 0), dist.ReduceOp.SUM)
    return champ, gmin // n, win, li


def sharded_beam_complete(bst, mesh, frontier=4, iters=32, minimise=True,
                          two_phase=False):
    """Stable-completion beam search data-parallel over the WHOLE mesh, with
    a cross-rank champion exchange: the sharded counterpart of
    :func:`~lifeapi_tpu_torch.stable.complete.complete_stable_beam`.

    ``bst``: a packed BitStable with a ``[B]`` leading dimension, B
    divisible by the mesh size.  Each rank runs the beam on its block
    (kernel [10] on the card), then the globally minimal-population
    completion is selected by a ``pmin`` over a rank-unique key and
    broadcast by a ``psum``.  Returns (found bool[B], best int64[B, 64],
    best_pop int32[B], champion board int64[64], champion population).

    ``two_phase``: after the exchange every rank searches its block again,
    BOUNDED by the global champion's population (``init_bound``), and the
    champion is refined by a second exchange.  Per-problem found / best /
    pop keep phase-1 semantics (a cross-problem bound would wrongly
    suppress per-problem completions above the global champion)."""
    rank, n = _place(mesh)
    local = _slice_stable(bst, _span(bst.state.shape[0], n, rank, "bst"), _device(mesh))
    found, best, pop, _ = _shard_beam(local, frontier, iters, minimise)
    champ, champ_pop, _, _ = _exchange(found, best, pop, rank, n)
    if two_phase:
        f2, b2, p2, _ = _shard_beam(local, frontier, iters, minimise, init_bound=champ_pop)
        champ2, champ2_pop, _, _ = _exchange(f2, b2, p2, rank, n)
        improved = champ2_pop < champ_pop
        champ = torch.where(improved, champ2, champ)
        champ_pop = torch.where(improved, champ2_pop, champ_pop)
    return _gather(found), _gather(best), _gather(pop), champ, champ_pop[0]


def sharded_portfolio(state, unknown, generator, mesh, replicas=256, frontier=4, iters=192,
                      minimise=True, two_phase=True, dfs_polish_timeout=None):
    """ONE hard stable-completion instance searched by ``replicas``
    orbit-randomized beam replicas (symmetry transform ``r % 16`` and a
    random torus translation each) sharded over the WHOLE mesh, with a
    pmin/psum champion exchange (the counterpart of the reference's deep
    DFS, LifeStable.hpp:1340-1458).

    With ``two_phase`` (and ``minimise``) the exchanged champion's
    population bounds a second pass on every rank.  ``dfs_polish_timeout``
    runs the champion-bounded host DFS on rank 0 afterwards; its result
    enters no collective.  Per-replica results do not depend on the mesh
    shape, and the champion is the first replica, in replica order, with
    the least population.

    ``state``/``unknown``: boards ``int64[64]``.  The translations are
    drawn from ``generator``
    (:func:`~lifeapi_tpu_torch.stable.complete.draw_offsets`).  Returns a
    :class:`~lifeapi_tpu_torch.stable.complete.PortfolioResult` with the
    champion back-transformed to the original orientation."""
    from ..stable import complete as C

    _, n = _place(mesh)
    if replicas % n:
        raise ValueError(f"replicas={replicas} not divisible by mesh size {n}")
    dev = _device(mesh)
    dx, dy = C.draw_offsets(generator, replicas, dev)
    return _portfolio(state.to(dev), unknown.to(dev), dx, dy, mesh, frontier, iters,
                      minimise, two_phase, dfs_polish_timeout)


def _portfolio(state, unknown, dx, dy, mesh, frontier, iters, minimise, two_phase,
               dfs_polish_timeout):
    """:func:`sharded_portfolio` with given translations ``dx``, ``dy``."""
    from ..core import board as BRD
    from ..stable import bitplane as BP
    from ..stable import complete as C

    rank, n = _place(mesh)
    replicas = dx.shape[0]
    rows = _span(replicas, n, rank, "replicas")
    st_r, un_r = C._build_replicas(state, unknown, dx, dy)
    local = BP.make(state=st_r[rows], unknown=un_r[rows])
    base = rows.start

    def exchange(found, best, pop):
        champ, champ_pop, win, li = _exchange(found, best, pop, rank, n)
        idx = _reduce(torch.where(win, base + li, 0), dist.ReduceOp.SUM)
        return champ, champ_pop, idx

    found, best, pop, _ = _shard_beam(local, frontier, iters, minimise)
    champ, champ_pop, champ_idx = exchange(found, best, pop)
    if two_phase and minimise:
        f2, b2, p2, _ = _shard_beam(local, frontier, iters, minimise, init_bound=champ_pop)
        champ2, champ2_pop, champ2_idx = exchange(f2, b2, p2)
        improved = champ2_pop < champ_pop
        champ = torch.where(improved, champ2, champ)
        champ_idx = torch.where(improved, champ2_idx, champ_idx)
        champ_pop = torch.minimum(champ_pop, champ2_pop)

    found_all = _gather(found)
    best_pop = int(champ_pop)
    if best_pop >= SENTINEL:  # nothing found anywhere
        return C.PortfolioResult(False, BRD.empty(device=state.device), 0, 0.0)
    champ = C._unreplicate(champ, int(champ_idx), dx, dy)
    if minimise and dfs_polish_timeout and dist.get_rank() == 0:
        best_pop, champ = C._dfs_polish(state, unknown, best_pop, champ,
                                        dfs_polish_timeout)
    return C.PortfolioResult(True, champ, best_pop,
                             int(found_all.sum()) / found_all.numel())


# ---------------------------------------------------------------------------
# Rollout and catalyst search (kernels [1] and [3])
# ---------------------------------------------------------------------------


def sharded_rollout(boards, steps, mesh):
    """Bit-exact Life rollout data-parallel over the whole mesh with a psum
    population reduction: boards ``int64[B, 64]`` sharded over both
    dimensions, each block advanced ``steps`` generations by the rollout
    (kernel [1] on the card).  Returns (final boards ``[B, 64]``, global
    total population)."""
    from ..core import board as BRD
    from ..ops import step_cuda

    rank, n = _place(mesh)
    local = boards[_span(boards.shape[0], n, rank, "boards")].to(_device(mesh))
    final = step_cuda.rollout(local.contiguous(), steps)
    pop = _reduce(BRD.population(final).sum().reshape(1), dist.ReduceOp.SUM)
    return _gather(final), pop[0]


def sharded_catalyst_search(active, catalyst, offsets, horizon, mesh):
    """Catalyst placement sweep data-parallel over the whole mesh:
    ``offsets`` ``int[P, 2]`` sharded across ranks (P a multiple of the
    mesh size), each block through :func:`lifeapi_tpu_torch.search.catalyst_search`
    (kernel [3] on the card), plus a psum of the global hit count.  Returns
    (interacted bool[P], recovered bool[P], global hits)."""
    from .. import search

    rank, n = _place(mesh)
    dev = _device(mesh)
    local = offsets[_span(offsets.shape[0], n, rank, "offsets")].to(dev)
    res = search.catalyst_search(active.to(dev), catalyst.to(dev), local, horizon)
    hits = search.successful_catalysts(res).sum().reshape(1).to(torch.int64)
    return (_gather(res.interacted), _gather(res.recovered),
            _reduce(hits, dist.ReduceOp.SUM)[0])
