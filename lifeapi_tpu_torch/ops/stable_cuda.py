"""Fused still-life propagation and the whole beam search: hand-written CUDA
kernels and their plain PyTorch twins.

Counterpart of :mod:`lifeapi_tpu.ops.stable_pallas`.  A board of the solver
is ``int64[10, 64]``: state, unknown and the 8 ruled-option planes
(:func:`lifeapi_tpu_torch.stable.bitplane.to_planes`), one 64-bit word per
column.  Each kernel entry takes ``int64[B, 10, 64]`` and dispatches on the
device: a CUDA tensor launches the kernel in ``csrc/life_stable.cu`` on the
current stream, a CPU tensor takes the plain twin.  A CUDA tensor never
falls back to the twin: anything the kernel does not take raises.  The
``BitStable`` entries (``propagate_fused``, ``propagate_fused_inkernel``,
``propagate_fused_beam``) hand kernels B and C the 10 planes where they lie
(:func:`plane_descriptor`), with no stacking, and return contiguous planes.

The twins follow the kernels' structure (the fused step ``_step_planes`` of
the TPU kernel and its masked fixpoint ``_run_fixpoint``), not the
three-pass :func:`lifeapi_tpu_torch.stable.bitplane.propagate`: the two
agree on consistent boards only, the kernel structure agrees with the
kernels on every board.

``LAUNCHES`` counts kernel launches per kernel, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core import board as B
from ..stable import bitplane as BP
from ..stable import nibble as nb
from .._device import resolve
from . import _build
from ._descriptor import descriptor_words, plane_descriptor
from .step_cuda import _check, _launch, _stream

LAUNCHES = {"propagate_step": 0, "propagate_fixpoint": 0,
            "propagate_fixpoint_priorities": 0, "beam_search": 0,
            # the kernels launched through the two BitStable entries that
            # the JAX package has as TPU kernels of their own ([6] and [9]);
            # propagate_fused_inkernel's count as propagate_fixpoint's ([7])
            "propagate_fused": 0, "propagate_fused_beam": 0}

MAX_ITERS = 256  # fixpoint cap, as the TPU kernels'
INT32_MAX = 2**31 - 1
SEED_GROWTH_CAP = 33  # seed-ZOI dilations per round (32 cover the torus)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _planes_batch(planes):
    if not isinstance(planes, torch.Tensor) or planes.dim() != 3:
        raise ValueError("planes: expected int64[B, 10, 64]")
    b = planes.shape[0]
    if not 0 < b < 2**31 // 64:
        raise ValueError(f"planes: batch {b} out of range")
    _check("planes", planes, (b, BP.N_PLANES, 64))
    return b


def _max_iters(n):
    n = int(n)
    if not 0 <= n < 2**31:
        raise ValueError(f"max_iters {n} out of range")
    return n


def _no_simple_phase(simple_phase):
    if simple_phase:
        raise NotImplementedError(
            "simple_phase is a TPU speed knob the port does not carry")


# ---------------------------------------------------------------------------
# Plain twins of the kernels' device functions
# ---------------------------------------------------------------------------


def propagate_step_plain(planes):
    """One fused propagation step (the TPU kernel's ``_step_planes``):
    synchronise, two 9-counts, update on the shared interval, post-update
    signal, hollow-ZOI apply.  ``int64[..., 10, 64]`` -> (planes, changed,
    abort) with cell-level ``int64[..., 64]`` changed/abort masks."""
    p = planes.unbind(-2)
    st, un, rl, abort, changed = BP.sync_circuit(p[0], p[1], p[2:])
    on9 = BP._counts_nibble(st)
    unk9 = BP._counts_nibble(un)
    A = nb.sub_bit(on9, st)
    Un = nb.sub_bit(unk9, un)
    AU = nb.add(A, Un)
    rl, ab_u, ch_u = BP.update_circuit_interval(st, un, rl, A, AU)
    abort = abort | ab_u
    changed = changed | ch_u
    son, soff, con, coff = BP.signal_circuit_post(st, un, rl, A, Un, AU)
    offz = B.zoi_hollow(soff) | coff
    onz = B.zoi_hollow(son) | con
    # both signals on a still-unknown cell (LifeStable.hpp:666-667)
    abort = abort | (offz & onz & un)
    off_cells = offz & un
    st = st & ~off_cells
    un = un & ~off_cells
    rl = list(rl)
    rl[0] = rl[0] | off_cells
    rl[1] = rl[1] | off_cells
    on_cells = onz & un
    st = st | on_cells
    un = un & ~on_cells
    for i in range(2, 8):
        rl[i] = rl[i] | on_cells
    changed = changed | off_cells | on_cells
    return torch.stack([st, un, *rl], dim=-2), changed, abort


def _fixpoint(planes, max_iters, alive=None):
    """The masked fixpoint (the TPU kernel's ``_run_fixpoint``): step every
    alive board; a board whose step aborts keeps its planes and stops, a
    board whose step changes nothing stops.  Returns (planes, aborted[...],
    changed[...])."""
    batch = planes.shape[:-2]
    dev = planes.device
    alive = (torch.ones(batch, dtype=torch.bool, device=dev) if alive is None
             else alive.clone())
    aborted = torch.zeros(batch, dtype=torch.bool, device=dev)
    changed = torch.zeros(batch, dtype=torch.bool, device=dev)
    it = 0
    while it < max_iters and bool(alive.any()):
        new, ch, ab = propagate_step_plain(planes)
        abort_b = ~B.is_empty(ab)
        changed_b = ~B.is_empty(ch)
        apply = alive & ~abort_b
        planes = torch.where(apply[..., None, None], new, planes)
        aborted = aborted | (alive & abort_b)
        changed = changed | (alive & changed_b)
        alive = apply & changed_b
        it += 1
    return planes, aborted, changed


def _priority_planes(planes):
    """Branch-priority levels (the TPU kernel's ``_priority_planes``):
    ``int64[..., 10, 64]`` -> ``int64[..., 4, 64]``, the 4 masks of
    :func:`lifeapi_tpu_torch.stable.bitplane.branch_levels`."""
    p = planes.unbind(-2)
    st, un, rl = p[0], p[1], p[2:]
    on9 = BP._counts_nibble(st)
    unk9 = BP._counts_nibble(un)
    v_on, v_off, vc_on, vc_off = BP.vulnerable_circuit(st, un, rl, on9, unk9)
    vuln = (B.zoi_hollow(v_on) | vc_on) & (B.zoi_hollow(v_off) | vc_off)
    settable = B.zoi(rl[2]) & BP._or_all(rl) & un
    return torch.stack([
        vuln & settable,
        settable & nb.eq_const(unk9, 2),
        settable & nb.eq_const(unk9, 3),
        settable,
    ], dim=-2)


# ---------------------------------------------------------------------------
# Kernel A: one step (replaces stable_pallas.propagate_step_planes)
# ---------------------------------------------------------------------------


def propagate_step(planes):
    """One fused propagation step of ``int64[B, 10, 64]`` boards ->
    (planes, changed ``int64[B, 64]``, abort ``int64[B, 64]``)."""
    b = _planes_batch(planes)
    if not planes.is_cuda:
        return propagate_step_plain(planes)
    out = torch.empty_like(planes)
    changed = torch.empty((b, 64), dtype=torch.int64, device=planes.device)
    abort = torch.empty_like(changed)
    with torch.cuda.device(planes.device):
        _launch(_build.library().life_stable_step, planes.data_ptr(), out.data_ptr(),
                changed.data_ptr(), abort.data_ptr(), b, _stream(planes.device))
    LAUNCHES["propagate_step"] += 1
    return out, changed, abort


def propagate_fused(bst, max_iters=MAX_ITERS):
    """The masked fixpoint of ``stable_pallas.propagate_fused``; same
    contract as :func:`lifeapi_tpu_torch.stable.bitplane.propagate`:
    ``consistent`` is not aborted, ``changed`` counts the aborting step's
    changes, an inconsistent board keeps its planes from before that step,
    and each board takes at most ``max_iters`` steps.

    JAX loops over the one-step kernel while any board is active, a
    predicate that stays on the TPU.  A host loop would read it back once a
    step; no board's result depends on another's, so on a CUDA tensor the
    call is one launch of kernel B, each warp looping over its own board
    with no readback, counted under ``LAUNCHES["propagate_fused"]``.  On a
    CPU tensor it is :func:`propagate_fused_plain`."""
    if not bst.state.is_cuda:
        return propagate_fused_plain(bst, max_iters)
    return _bitstable_launch(bst, max_iters, priorities=False, count="propagate_fused")


def propagate_fused_plain(bst, max_iters=MAX_ITERS):
    """JAX's structure in plain PyTorch: the masked fixpoint as a loop over
    the twin of kernel A while any board is active."""
    batch = bst.batch_shape
    planes = BP.to_planes(bst).reshape(-1, BP.N_PLANES, 64)
    n = planes.shape[0]
    dev = planes.device
    consistent = torch.ones(n, dtype=torch.bool, device=dev)
    changed = torch.zeros(n, dtype=torch.bool, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    max_iters = _max_iters(max_iters)
    it = 0
    while it < max_iters and bool(active.any()):
        new, ch, ab = propagate_step_plain(planes)
        step_changed = ~B.is_empty(ch)
        ok = B.is_empty(ab)
        apply = active & ok
        planes = torch.where(apply[:, None, None], new, planes)
        consistent = consistent & (~active | ok)
        changed = changed | (active & step_changed)
        active = active & ok & step_changed
        it += 1
    planes = planes.reshape(*batch, BP.N_PLANES, 64)
    return BP.BitPropagateResult(BP.from_planes(planes), consistent.reshape(batch),
                                 changed.reshape(batch))


# ---------------------------------------------------------------------------
# Kernels B and C: the whole fixpoint, optionally with the branch priorities
# (replace stable_pallas.propagate_fused_inkernel and
# propagate_fused_beam_planes)
# ---------------------------------------------------------------------------


def propagate_fixpoint_plain(planes, max_iters=MAX_ITERS):
    planes, aborted, changed = _fixpoint(planes, max_iters)
    return planes, ~aborted, changed


def propagate_fixpoint_priorities_plain(planes, max_iters=MAX_ITERS):
    planes, consistent, changed = propagate_fixpoint_plain(planes, max_iters)
    return planes, consistent, changed, _priority_planes(planes)


def _stacked(t, dim):
    """Descriptor words of the planes along ``dim`` of a fresh contiguous
    ``int64`` tensor: ``[planes, N, 64]`` (dim 0) or ``[N, planes, 64]``
    (dim 1)."""
    count, step, base = t.shape[dim], t.stride(dim) * 8, t.data_ptr()
    return descriptor_words(range(base, base + count * step, step), (t.stride(1 - dim),) * count)


def _launch_fixpoint(src, dst, levels, n, max_iters, count, dev):
    """Launch kernel B, or kernel C when ``levels`` is given, with the
    descriptor words of the input planes, the output planes and the levels,
    and count the launch under ``LAUNCHES[count]``, the entry that made it.
    Returns the flags ``bool[2, n]``: consistent, changed."""
    max_iters = _max_iters(max_iters)
    flags = torch.empty((2, n), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        _launch(_build.library().life_stable_fixpoint, src, dst, levels, flags.data_ptr(), n,
                max_iters, _stream(dev))
    LAUNCHES[count] += 1
    return flags


def _planes_api_launch(planes, max_iters, priorities, count):
    """Kernel B or C on ``int64[B, 10, 64]`` boards: plane i of board b at
    ``b * 640 + 64 * i``."""
    b = _planes_batch(planes)
    out = torch.empty_like(planes)
    levels = (torch.empty((b, 4, 64), dtype=torch.int64, device=planes.device)
              if priorities else None)
    flags = _launch_fixpoint(_stacked(planes, 1), _stacked(out, 1),
                             None if levels is None else _stacked(levels, 1), b, max_iters,
                             count, planes.device)
    return (out, flags[0], flags[1]) + ((levels,) if priorities else ())


def propagate_fixpoint(planes, max_iters=MAX_ITERS):
    """Whole propagate fixpoint of ``int64[B, 10, 64]`` boards in one
    launch -> (planes, consistent ``bool[B]``, changed ``bool[B]``).  The
    planes of an inconsistent board are those before its aborting step."""
    _planes_batch(planes)
    if not planes.is_cuda:
        return propagate_fixpoint_plain(planes, _max_iters(max_iters))
    return _planes_api_launch(planes, max_iters, priorities=False, count="propagate_fixpoint")


def propagate_fixpoint_priorities(planes, max_iters=MAX_ITERS):
    """:func:`propagate_fixpoint` plus the 4 branch-priority levels of the
    result -> (planes, consistent, changed, levels ``int64[B, 4, 64]``)."""
    _planes_batch(planes)
    if not planes.is_cuda:
        return propagate_fixpoint_priorities_plain(planes, _max_iters(max_iters))
    return _planes_api_launch(planes, max_iters, priorities=True,
                              count="propagate_fixpoint_priorities")


def fixpoint_kernel_info(priorities, device=None):
    """(resident blocks an SM, registers a thread, local bytes a thread) of
    kernel B, or of kernel C when ``priorities``, on a CUDA ``device``, from
    the CUDA runtime's occupancy calculator and the kernel's attributes."""
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(resolve(device)):
        _launch(_build.library().life_stable_fixpoint_info, int(bool(priorities)), info)
    return tuple(info)


def propagate_fused_inkernel(bst, max_iters=MAX_ITERS, simple_phase=False):
    """Whole propagate fixpoint in one kernel launch
    (``stable_pallas.propagate_fused_inkernel``).  Contract: per-board
    (consistent, changed); planes of inconsistent boards are unspecified
    (the reference discards them, LifeStable.hpp:723).  On a CUDA tensor the
    launch of kernel B counts under ``LAUNCHES["propagate_fixpoint"]``."""
    _no_simple_phase(simple_phase)
    if not bst.state.is_cuda:
        return propagate_fused_inkernel_plain(bst, max_iters)
    return _bitstable_launch(bst, max_iters, priorities=False, count="propagate_fixpoint")


def propagate_fused_inkernel_plain(bst, max_iters=MAX_ITERS):
    """:func:`propagate_fused_inkernel` over the plain twin of kernel B."""
    return _bitstable_entry(bst, max_iters, propagate_fixpoint_plain)


def propagate_fused_beam(bst, max_iters=MAX_ITERS, simple_phase=False):
    """Propagate fixpoint AND branch-priority masks in one kernel launch
    (``stable_pallas.propagate_fused_beam``) -> (BitPropagateResult,
    levels), ``levels`` the 4-tuple of
    :func:`lifeapi_tpu_torch.stable.bitplane.branch_levels` evaluated on the
    propagated planes.  On a CUDA tensor the launch of kernel C counts under
    ``LAUNCHES["propagate_fused_beam"]``."""
    _no_simple_phase(simple_phase)
    if not bst.state.is_cuda:
        return propagate_fused_beam_plain(bst, max_iters)
    return _bitstable_launch(bst, max_iters, priorities=True, count="propagate_fused_beam")


def propagate_fused_beam_plain(bst, max_iters=MAX_ITERS):
    """:func:`propagate_fused_beam` over the plain twin of kernel C."""
    return _bitstable_entry(bst, max_iters, propagate_fixpoint_priorities_plain)


def _bitstable_entry(bst, max_iters, fixpoint):
    """Run the twin ``fixpoint`` on the stacked planes of ``bst`` ->
    BitPropagateResult, with the 4 levels beside it when ``fixpoint``
    returns them."""
    batch = bst.batch_shape
    planes = BP.to_planes(bst).reshape(-1, BP.N_PLANES, 64)
    _planes_batch(planes)
    out, consistent, changed, *levels = fixpoint(planes, _max_iters(max_iters))
    out = out.reshape(*batch, BP.N_PLANES, 64)
    res = BP.BitPropagateResult(BP.from_planes(out), consistent.reshape(batch),
                                changed.reshape(batch))
    if not levels:
        return res
    return res, tuple(levels[0].reshape(*batch, 4, 64).unbind(-2))


def _bitstable_planes(bst):
    """The 10 planes of a BitStable, checked -> (planes, batch shape,
    number of boards)."""
    planes = (bst.state, bst.unknown, *bst.ruled)
    if len(planes) != BP.N_PLANES:
        raise ValueError(f"BitStable: expected {BP.N_PLANES} planes, got {len(planes)}")
    shape = bst.state.shape
    if not shape or shape[-1] != 64:
        raise ValueError(f"BitStable: planes must be int64[..., 64], got {tuple(shape)}")
    for plane in planes:
        _check_plane(plane, shape, bst.state.device)
    n = math.prod(shape[:-1])
    if not 0 < n < 2**31 // 64:
        raise ValueError(f"BitStable: batch {n} out of range")
    return planes, shape[:-1], n


def _check_plane(plane, shape, device):
    if not isinstance(plane, torch.Tensor):
        raise TypeError(f"BitStable: expected tensors, got {type(plane).__name__}")
    if plane.dtype != torch.int64:
        raise TypeError(f"BitStable: expected torch.int64 planes, got {plane.dtype}")
    if plane.shape != shape:
        raise ValueError(f"BitStable: plane of shape {tuple(plane.shape)} beside "
                         f"{tuple(shape)}")
    if plane.device != device:
        raise ValueError(f"BitStable: a plane on {plane.device}, the state on {device}")


def _bitstable_launch(bst, max_iters, priorities, count):
    """Kernel B or C on the planes of a CUDA ``bst`` where they lie: one
    launch and no other kernel unless a plane must be copied
    (:func:`plane_descriptor`).  The result's planes and levels are slices
    of one ``int64[10, N, 64]`` and one ``int64[4, N, 64]``, each plane
    contiguous."""
    planes, batch, n = _bitstable_planes(bst)
    dev = bst.state.device
    pointers, strides, copies = plane_descriptor(planes)  # copies live past the launch
    out = torch.empty((BP.N_PLANES, n, 64), dtype=torch.int64, device=dev)
    levels = torch.empty((4, n, 64), dtype=torch.int64, device=dev) if priorities else None
    flags = _launch_fixpoint(descriptor_words(pointers, strides), _stacked(out, 0),
                             None if levels is None else _stacked(levels, 0), n, max_iters,
                             count, dev)
    p = out.view(BP.N_PLANES, *batch, 64).unbind(0)
    consistent, changed = flags.view(2, *batch).unbind(0)
    res = BP.BitPropagateResult(BP.BitStable(p[0], p[1], p[2:]), consistent, changed)
    if not priorities:
        return res
    return res, levels.view(4, *batch, 64).unbind(0)


# ---------------------------------------------------------------------------
# Kernel D: the whole beam search (replaces stable_pallas.beam_search_planes)
# ---------------------------------------------------------------------------


def _lowest_bit(w):
    """``w & -w`` of int64 words, computed on the 32-bit halves so that no
    step overflows."""
    lo = w & 0xFFFFFFFF
    hi = (w >> 32) & 0xFFFFFFFF
    return torch.where(lo != 0, lo & -lo, (hi & -hi) << 32)


def first_cell_mask(boards):
    """Isolate the first set cell (lowest column, then lowest row) of each
    ``int64[..., 64]`` board; empty boards stay empty
    (``complete._first_cell_mask``)."""
    col = torch.argmax((boards != 0).to(torch.uint8), dim=-1, keepdim=True)
    word = torch.gather(boards, -1, col)
    onehot = torch.arange(64, device=boards.device) == col
    return torch.where(onehot, _lowest_bit(word), torch.zeros_like(boards))


def _seed_restrict(levels, ok, seed):
    """Intersect every level with the smallest seed-ZOI dilation touching
    the settable set (reference ``useSeed``, LifeStable.hpp:1366-1375);
    lanes with an empty seed are unrestricted."""
    settable = levels[..., 3, :]
    has_set = ok & ~B.is_empty(settable)
    sz = seed[:, None, :].expand(settable.shape)
    sz = torch.where(B.is_empty(sz)[..., None], torch.full_like(sz, -1), sz)
    for _ in range(SEED_GROWTH_CAP):
        grow = has_set & B.is_empty(settable & sz)
        if not bool(grow.any()):
            break
        sz = torch.where(grow[..., None], B.zoi(sz), sz)
    return levels & sz[..., None, :]


def _slot_priorities(planes, ok):
    """The branch levels of a beam round's slots: those of the ok slots; a
    slot that is not ok branches on nothing, and the kernel skips it."""
    return torch.where(ok[..., None, None], _priority_planes(planes), 0)


def beam_search_plain(planes, *, frontier, iters, minimise, seed=None, bound=None):
    """The beam search in plain PyTorch: ``complete.beam_search_jnp``
    round for round, with the kernels' fixpoint and priority functions
    and their order (population bound before the seed restriction; both
    orders give the same decisions)."""
    b, F = planes.shape[0], frontier
    dev = planes.device
    cur = planes[:, None].expand(b, F, BP.N_PLANES, 64).clone()
    active = torch.zeros((b, F), dtype=torch.bool, device=dev)
    active[:, 0] = True
    best = torch.zeros((b, 64), dtype=torch.int64, device=dev)
    best_pop = (torch.full((b,), INT32_MAX, dtype=torch.int32, device=dev)
                if bound is None else bound.clone())
    found = torch.zeros(b, dtype=torch.bool, device=dev)
    complete = torch.ones(b, dtype=torch.bool, device=dev)
    it = 0
    while it < iters and bool(active.any()):
        cur, aborted, _ = _fixpoint(cur, MAX_ITERS, alive=active)
        ok = active & ~aborted
        pop = B.population(cur[:, :, 0]).to(torch.int32)
        if minimise:
            # population bound (reference LifeStable.hpp:1351-1355)
            ok = ok & (pop < best_pop[:, None])
        else:
            ok = ok & ~found[:, None]
        levels = _slot_priorities(cur, ok)
        if seed is not None:
            levels = _seed_restrict(levels, ok, seed)
        is_leaf = ok & B.is_empty(levels[:, :, 3])

        # harvest: the lowest-population leaf of the round, lowest slot first
        leaf_pop = torch.where(is_leaf, pop, INT32_MAX)
        which = torch.argmin(leaf_pop, dim=1)
        round_pop = leaf_pop.gather(1, which[:, None])[:, 0]
        better = round_pop < best_pop
        round_state = cur[torch.arange(b, device=dev), which, 0]
        best = torch.where(better[:, None], round_state, best)
        best_pop = torch.where(better, round_pop, best_pop)
        found = found | better
        ok = ok & ~is_leaf

        # branch cell: first cell of the highest nonempty priority level
        chosen = levels[:, :, 3]
        for k in (2, 1, 0):
            lvl = levels[:, :, k]
            chosen = torch.where(B.is_empty(lvl)[..., None], chosen, lvl)
        cell = first_cell_mask(chosen) & torch.where(ok, -1, 0)[..., None]

        # 2F children -> the F best by (score, OFF before ON, slot)
        p = cur.unbind(2)
        ruled_off = [p[2] | cell, p[3] | cell] + list(p[4:])
        ruled_on = [p[2], p[3]] + [r | cell for r in p[4:]]
        off = torch.stack([p[0] & ~cell, p[1] & ~cell, *ruled_off], dim=2)
        on = torch.stack([p[0] | cell, p[1] & ~cell, *ruled_on], dim=2)
        cand = torch.cat([off, on], dim=1)
        cand_active = torch.cat([ok, ok], dim=1)
        score = torch.where(cand_active, torch.cat([pop, pop + 1], dim=1), INT32_MAX)
        order = torch.argsort(score, dim=1, stable=True)
        keep = order[:, :F]
        cur = cand.gather(1, keep[:, :, None, None].expand(b, F, BP.N_PLANES, 64))
        active = cand_active.gather(1, keep)
        # an active candidate past capacity was dropped: the search is no
        # longer exhaustive (soundness of proved_inconsistent)
        complete = complete & ~cand_active.gather(1, order[:, F:]).any(dim=1)
        it += 1
    exhausted = ~active.any(dim=1)
    return best, best_pop, found, complete, exhausted


def beam_search(planes, *, frontier, iters, minimise, seed=None, bound=None):
    """The entire beam completion search over ``int64[B, 10, 64]``
    problems in one launch: one block per problem, one warp per frontier
    slot.  ``seed`` ``int64[B, 64]`` enables seed-proximity branching,
    ``bound`` ``int32[B]`` starts from a known incumbent population.
    Returns (best ``int64[B, 64]``, best_pop ``int32[B]``, found,
    complete, exhausted ``bool[B]``); proved inconsistent is
    ``exhausted & complete & ~found``."""
    b = _planes_batch(planes)
    F = int(frontier)
    if F & (F - 1) or not 2 <= F <= 16:
        raise ValueError(f"frontier {F} must be a power of two in [2, 16]")
    iters = _max_iters(iters)
    if seed is not None:
        _check("seed", seed, (b, 64), device=planes.device)
    if bound is not None:
        _check("bound", bound, (b,), dtype=torch.int32, device=planes.device)
    if not planes.is_cuda:
        return beam_search_plain(planes, frontier=F, iters=iters, minimise=minimise,
                                 seed=seed, bound=bound)
    dev = planes.device
    # the launcher opts the block into F x 5 KB of dynamic shared memory (the
    # F parent boards of a round); past the device's limit that fails and
    # _launch raises
    best = torch.empty((b, 64), dtype=torch.int64, device=dev)
    best_pop = torch.empty(b, dtype=torch.int32, device=dev)
    flags = torch.empty((3, b), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        _launch(_build.library().life_stable_beam, planes.data_ptr(),
                None if seed is None else seed.data_ptr(),
                None if bound is None else bound.data_ptr(),
                best.data_ptr(), best_pop.data_ptr(), flags[0].data_ptr(),
                flags[1].data_ptr(), flags[2].data_ptr(), b, F, iters,
                int(bool(minimise)), MAX_ITERS, _stream(dev))
    LAUNCHES["beam_search"] += 1
    return best, best_pop, flags[0], flags[1], flags[2]


def beam_kernel_info(frontier, device=None):
    """(resident blocks an SM, registers a thread, local bytes a thread) of
    the beam kernel at ``frontier`` on a CUDA ``device``, from the CUDA
    runtime's occupancy calculator and the kernel's attributes."""
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(resolve(device)):
        _launch(_build.library().life_stable_beam_info, int(frontier), info)
    return tuple(info)
