"""The still-life kernel entries of ``lifeapi_tpu_torch.ops.stable_cuda`` on
CPU tensors (their plain twins) against the JAX package's Pallas kernels,
run in interpret mode as ``tests/test_stable_pallas.py`` runs them.  Planes
are compared on every board, inconsistent ones included; every comparison
is exact.  The beam kernel's twin is in
``tests/test_torch_stable_beam_kernel.py``; the CUDA kernels themselves
are tested on the card by ``tests/test_torch_cuda_kernels.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.ops import stable_pallas as SP
from lifeapi_tpu.stable import bitplane as JBP
from lifeapi_tpu.stable import host as H
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.ops import stable_cuda
from lifeapi_tpu_torch.stable import bitplane as BP
from oracle import random_dense
from torch_threads import one_torch_thread  # noqa: F401

N = 64


def _instances(rng):
    """8 boards: 4 partial still lifes of 2x2 blocks (hidden cells, 2-ring
    of unknowns) and 4 noise boards, which are inconsistent."""
    states, unknowns = [], []
    for _ in range(4):
        truth = np.zeros((N, N), bool)
        for _ in range(5):
            x, y = rng.integers(4, 56, 2)
            truth[x:x + 2, y:y + 2] = True
        hide = (rng.random((N, N)) < 0.3) & H.zoi(truth)
        states.append(truth & ~hide)
        unknowns.append(hide | (H.zoi(H.zoi(truth)) & ~truth))
    noise = random_dense(rng, p=0.15, batch=(4,))
    states += list(noise)
    unknowns += list(random_dense(rng, p=0.25, batch=(4,)) & ~noise)
    return JBP.make(state=jb.from_dense(jnp.asarray(np.stack(states))),
                    unknown=jb.from_dense(jnp.asarray(np.stack(unknowns))))


def _same_planes(jax_planes, planes):
    """20 Pallas half-planes uint32[64, B] vs port planes int64[B, 10, 64]."""
    packed = convert.board_to_packed(planes)  # [B, 10, 64, 2]
    for i in range(BP.N_PLANES):
        for h in range(2):
            assert (np.asarray(jax_planes[2 * i + h]).T == packed[:, i, :, h]).all()


def _board_any(mask_cols):
    return np.asarray(jnp.any(mask_cols != 0, axis=0))


def _planes(jbst):
    return BP.to_planes(convert.bitstable_from_jax(jbst, device="cpu")).contiguous()


def test_step_twin_matches_pallas_on_all_boards(rng):
    jbst = _instances(rng)
    new, changed, abort = SP.propagate_step_planes(SP._to_kernel_planes(jbst),
                                                   batch_tile=8, interpret=True)
    got, got_changed, got_abort = stable_cuda.propagate_step(_planes(jbst))
    _same_planes(new, got)
    assert (_board_any(changed) == (got_changed != 0).any(-1).numpy()).all()
    assert (_board_any(abort) == (got_abort != 0).any(-1).numpy()).all()
    assert _board_any(abort).any() and not _board_any(abort).all()
    # the cell-level masks: Pallas ORs the two 32-bit halves of a column
    lo_hi = convert.board_to_packed(got_changed)
    assert (np.asarray(changed).T == lo_hi[..., 0] | lo_hi[..., 1]).all()


def test_fixpoint_twin_matches_pallas_on_all_boards(rng):
    jbst = _instances(rng)
    expect = SP.propagate_fused_inkernel(jbst, batch_tile=8, interpret=True)
    res = stable_cuda.propagate_fused_inkernel(convert.bitstable_from_jax(jbst, device="cpu"))
    _same_planes(SP._to_kernel_planes(expect.stable), BP.to_planes(res.stable))
    assert (np.asarray(expect.consistent) == res.consistent.numpy()).all()
    assert (np.asarray(expect.changed) == res.changed.numpy()).all()
    assert res.consistent.any() and not res.consistent.all()


def test_fixpoint_priorities_twin_matches_pallas_on_all_boards(rng):
    jbst = _instances(rng)
    out, changed, consistent, prio = SP.propagate_fused_beam_planes(
        SP._to_kernel_planes(jbst), batch_tile=8, interpret=True)
    got, got_consistent, got_changed, levels = stable_cuda.propagate_fixpoint_priorities(
        _planes(jbst))
    _same_planes(out, got)
    assert (np.asarray(jnp.all(consistent != 0, axis=0)) == got_consistent.numpy()).all()
    assert (_board_any(changed) == got_changed.numpy()).all()
    packed = convert.board_to_packed(levels)  # [B, 4, 64, 2]
    for j in range(4):
        for h in range(2):
            assert (np.asarray(prio[2 * j + h]).T == packed[:, j, :, h]).all()


def _with_lone_cells(jbst):
    """The instances and two boards holding a lone ON cell and nothing
    unknown, which propagation proves inconsistent."""
    lone = jb.from_cells([(30, 30)])
    cat = lambda a, b: jnp.concatenate([a, jnp.broadcast_to(b, (2, 64, 2))])
    return JBP.BitStable(cat(jbst.state, lone), cat(jbst.unknown, jnp.zeros_like(lone)),
                         tuple(cat(r, jnp.zeros_like(lone)) for r in jbst.ruled))


@pytest.mark.parametrize("max_iters", [1, 2, None])
def test_fused_entry_matches_pallas_and_the_in_kernel_fixpoint(rng, max_iters):
    """``propagate_fused`` at a step cap against JAX's loop over the Pallas
    step kernel, and its plain version (JAX's structure: a loop while any
    board is active) against the plain twin of kernel B's per-board loop,
    on every board, the inconsistent ones included: the equality that lets
    the card run [6] as one launch of kernel B.  ``None`` takes both
    packages' default cap."""
    cap = {} if max_iters is None else {"max_iters": max_iters}
    jbst = _with_lone_cells(_instances(rng))
    expect = SP.propagate_fused(jbst, batch_tile=10, interpret=True, **cap)
    bst = convert.bitstable_from_jax(jbst, device="cpu")
    res = stable_cuda.propagate_fused(bst, **cap)
    _same_planes(SP._to_kernel_planes(expect.stable), BP.to_planes(res.stable))
    assert (np.asarray(expect.consistent) == res.consistent.numpy()).all()
    assert (np.asarray(expect.changed) == res.changed.numpy()).all()
    plain = stable_cuda.propagate_fused_plain(bst, **cap)
    planes, consistent, changed = stable_cuda.propagate_fixpoint_plain(
        BP.to_planes(bst).contiguous(), **cap)
    assert torch.equal(BP.to_planes(plain.stable), planes)
    assert torch.equal(plain.consistent, consistent) and torch.equal(plain.changed, changed)
    assert not consistent[-2:].any()
    if max_iters == 1:  # some consistent board is still changing after one step
        assert bool((consistent & changed).any())


def test_fused_loop_matches_pallas_and_detects_contradiction(rng):
    jbst = _with_lone_cells(_instances(rng))
    expect = SP.propagate_fused(jbst, batch_tile=10, interpret=True)
    res = stable_cuda.propagate_fused(convert.bitstable_from_jax(jbst, device="cpu"))
    _same_planes(SP._to_kernel_planes(expect.stable), BP.to_planes(res.stable))
    assert (np.asarray(expect.consistent) == res.consistent.numpy()).all()
    assert (np.asarray(expect.changed) == res.changed.numpy()).all()
    assert not res.consistent[-2:].any()
    # the three fixpoint entries agree on every board
    inkernel = stable_cuda.propagate_fused_inkernel(convert.bitstable_from_jax(jbst, device="cpu"))
    beam_res, levels = stable_cuda.propagate_fused_beam(convert.bitstable_from_jax(jbst, device="cpu"))
    for other in (inkernel, beam_res):
        assert torch.equal(BP.to_planes(other.stable), BP.to_planes(res.stable))
        assert torch.equal(other.consistent, res.consistent)
        assert torch.equal(other.changed, res.changed)
    ok = res.consistent
    expect_levels = BP.branch_levels(BP.from_planes(BP.to_planes(res.stable)[ok]))
    for lvl, e in zip(levels, expect_levels):
        assert torch.equal(lvl[ok], e)


def test_entry_plain_versions_on_cpu(rng):
    """``propagate_fused_plain`` / ``propagate_fused_beam_plain`` (what the
    card's entries are held against) equal the entries on CPU tensors, and
    no launch is counted."""
    bst = convert.bitstable_from_jax(_instances(rng), device="cpu")
    before = dict(stable_cuda.LAUNCHES)
    res, plain = stable_cuda.propagate_fused(bst), stable_cuda.propagate_fused_plain(bst)
    assert torch.equal(BP.to_planes(res.stable), BP.to_planes(plain.stable))
    assert torch.equal(res.consistent, plain.consistent)
    (res, lv), (plain, plv) = (stable_cuda.propagate_fused_beam(bst),
                               stable_cuda.propagate_fused_beam_plain(bst))
    assert torch.equal(BP.to_planes(res.stable), BP.to_planes(plain.stable))
    assert all(torch.equal(a, b) for a, b in zip(lv, plv))
    assert stable_cuda.LAUNCHES == before


@pytest.mark.parametrize("entry", ["propagate_fused", "propagate_fused_inkernel",
                                   "propagate_fused_beam"])
def test_bitstable_entries_on_views_and_a_2d_batch_match_pallas(rng, entry):
    """The three ``BitStable`` entries on CPU tensors, given the planes as
    strided views of one ``int64[2, 5, 10, 64]`` (the layout the card reads
    in place at stride 640) with a 2-D batch, against JAX's interpret-mode
    entry on the same 10 boards, lone-cell contradictions included; the
    levels of [9] on every board."""
    jbst = _with_lone_cells(_instances(rng))
    expect = getattr(SP, entry)(jbst, batch_tile=10, interpret=True)
    views = BP.from_planes(_planes(jbst).reshape(2, 5, BP.N_PLANES, 64))
    assert views.state.stride() == (5 * 640, 640, 1)
    got = getattr(stable_cuda, entry)(views)
    (expect, jlevels), (got, levels) = ((expect, got) if entry == "propagate_fused_beam"
                                        else ((expect, ()), (got, ())))
    assert got.consistent.shape == got.changed.shape == (2, 5)
    _same_planes(SP._to_kernel_planes(expect.stable),
                 BP.to_planes(got.stable).reshape(10, BP.N_PLANES, 64))
    assert (np.asarray(expect.consistent) == got.consistent.reshape(10).numpy()).all()
    assert (np.asarray(expect.changed) == got.changed.reshape(10).numpy()).all()
    assert not got.consistent[1, -2:].any() and got.consistent.any()
    for want, lvl in zip(jlevels, levels):
        assert lvl.shape == (2, 5, 64)
        assert (np.asarray(want) == convert.board_to_packed(lvl.reshape(10, 64))).all()
    assert len(levels) == (4 if entry == "propagate_fused_beam" else 0)
