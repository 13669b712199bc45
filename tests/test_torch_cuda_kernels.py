"""The port's CUDA kernels against their plain PyTorch twins, on the card.
Every test skips without CUDA.  The file imports neither jax nor the JAX
package, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.core import ntt, rle
from lifeapi_tpu_torch.ops import calibrate_cuda, conv_cuda, soft_cuda, stable_cuda, step_cuda
from lifeapi_tpu_torch.search import rollout_inputs
from lifeapi_tpu_torch.stable import bitplane as BP
from lifeapi_tpu_torch.stable import host as H

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_boards(gen, b, p, device):
    return B.from_dense(torch.rand((b, 64, 64), generator=gen) < p).to(device)


def _rollout_case(gen, device):
    boards = _random_boards(gen, 1000, 0.35, device)
    return "rollout", (boards, 37), step_cuda.rollout_plain


def _controlled_case(gen, device):
    boards = _random_boards(gen, 77, 0.3, device)
    toggles = _random_boards(gen, 9 * 77, 0.02, device).view(9, 77, 64)
    return "controlled_rollout", (boards, toggles), step_cuda.controlled_rollout_plain


def _catalyst_case(gen, device):
    glider = B.from_cells([(8, 10), (9, 8), (9, 10), (10, 9), (10, 10)], device="cpu")
    eater = B.from_cells([(24, 21), (24, 22), (25, 21), (25, 23), (26, 23),
                          (27, 23), (27, 24)], device="cpu")
    offsets = torch.randint(-12, 12, (333, 2), generator=gen)
    args = [t.to(device) for t in rollout_inputs(glider, eater, offsets, 41)]
    return "catalyst_rollout", tuple(args), step_cuda.catalyst_rollout_plain


@pytest.mark.parametrize("case", [_rollout_case, _controlled_case, _catalyst_case])
def test_kernel_matches_plain_twin(device, case):
    name, args, plain = case(torch.Generator().manual_seed(0), device)
    kernel = getattr(step_cuda, name)
    before = step_cuda.LAUNCHES[name]
    got = kernel(*args)
    torch.cuda.synchronize()
    assert step_cuda.LAUNCHES[name] == before + 1
    expect = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    expect = expect if isinstance(expect, tuple) else (expect,)
    for g, e in zip(got, expect):
        assert g.device == e.device and g.dtype == e.dtype
        assert torch.equal(g, e)


@pytest.mark.parametrize("case", [_rollout_case, _controlled_case, _catalyst_case])
def test_kernel_rejects_bad_input(device, case):
    name, args, _ = case(torch.Generator().manual_seed(1), device)
    kernel = getattr(step_cuda, name)
    with pytest.raises(TypeError):
        kernel(args[0].to(torch.int32), *args[1:])
    strided = torch.empty((args[0].shape[0], 128), dtype=torch.int64,
                          device=device)[:, ::2]
    with pytest.raises(ValueError):
        kernel(strided, *args[1:])


@pytest.mark.parametrize("batch", [1, 64, 1000])
@pytest.mark.parametrize("steps", [0, 1, 32, 65])
def test_controlled_kernel_at_every_horizon_and_batch(device, batch, steps):
    """Kernel [2] against its twin: no generation, one, the MPC horizon of 32
    (four stages of 8 toggle rows) and 65 (a last stage of one row), on one
    board, the MPC's 64 candidates and 1000 boards; and on toggles whose data
    starts 8 bytes past 16, which the wrapper copies."""
    gen = torch.Generator().manual_seed(steps * 1000 + batch)
    boards = _random_boards(gen, batch, 0.3, device)
    toggles = _random_boards(gen, steps * batch, 0.05, device).view(steps, batch, 64)
    before = step_cuda.LAUNCHES["controlled_rollout"]
    got = step_cuda.controlled_rollout(boards, toggles)
    torch.cuda.synchronize()
    assert step_cuda.LAUNCHES["controlled_rollout"] == before + 1
    assert torch.equal(got, step_cuda.controlled_rollout_plain(boards, toggles))
    store = torch.zeros(steps * batch * 64 + 1, dtype=torch.int64, device=device)
    shifted = store[1:].view(steps, batch, 64)
    shifted.copy_(toggles)
    assert steps == 0 or shifted.data_ptr() % 16 == 8
    assert torch.equal(step_cuda.controlled_rollout(boards, shifted), got)


@pytest.mark.parametrize("batch", [1, 33, 1000])
def test_rollout_lohi_kernel_matches_twin_and_rollout(device, batch):
    """Kernel [4] on the half-word layout against its plain twin and
    against kernel [1] on the same boards; ragged batches included."""
    boards = _random_boards(torch.Generator().manual_seed(batch), batch, 0.35, device)
    lo, hi = step_cuda.to_kernel_layout(boards)
    before = step_cuda.LAUNCHES["rollout_lohi"]
    got = step_cuda.rollout_lohi(lo, hi, 37)
    torch.cuda.synchronize()
    assert step_cuda.LAUNCHES["rollout_lohi"] == before + 1
    want = step_cuda.rollout_lohi_plain(lo, hi, 37)
    via_rollout = step_cuda.to_kernel_layout(step_cuda.rollout(boards, 37))
    for g, w, v in zip(got, want, via_rollout):
        assert g.device == w.device and g.dtype == w.dtype == torch.int32
        assert torch.equal(g, w) and torch.equal(g, v)
    assert torch.equal(step_cuda.from_kernel_layout(*step_cuda.rollout_lohi(lo, hi, 0)), boards)


def _launched_once(name, fn, *args):
    before = step_cuda.LAUNCHES[name]
    got = fn(*args)
    torch.cuda.synchronize()
    assert step_cuda.LAUNCHES[name] == before + 1
    return got


@pytest.mark.parametrize("steps", [0, 1, 2, 3, 5, 512])
@pytest.mark.parametrize("batch", [1, 7, 9, 8191])
def test_pair_layout_rollouts_at_every_batch_and_horizon(device, batch, steps):
    """Kernels [1] and [4], lane l on columns 2l and 2l + 1, against their
    twins bit for bit: a partial block, one block and one board past it, a
    full grid less one board; no generation, the remainders of the loop
    unrolled by 4, and the headline horizon.  One launch each, and a
    second launch gives the same bits."""
    boards = _random_boards(torch.Generator().manual_seed(batch * 1000 + steps), batch, 0.35,
                            device)
    got = _launched_once("rollout", step_cuda.rollout, boards, steps)
    assert torch.equal(got, step_cuda.rollout_plain(boards, steps))
    assert torch.equal(step_cuda.rollout(boards, steps), got)
    lo, hi = step_cuda.to_kernel_layout(boards)
    got_lohi = _launched_once("rollout_lohi", step_cuda.rollout_lohi, lo, hi, steps)
    for g, w, again in zip(got_lohi, step_cuda.rollout_lohi_plain(lo, hi, steps),
                           step_cuda.rollout_lohi(lo, hi, steps)):
        assert torch.equal(g, w) and torch.equal(again, g)


def test_rollout_reads_boards_that_start_8_bytes_in(device):
    """Kernel [1] reads a lane's two columns as one 16-byte word: a board
    view whose data starts 8 bytes past 16 is copied by the wrapper and
    gives the same bits; the launcher refuses such a pointer itself."""
    boards = _random_boards(torch.Generator().manual_seed(8), 77, 0.35, device)
    store = torch.zeros(77 * 64 + 1, dtype=torch.int64, device=device)
    shifted = store[1:].view(77, 64)
    shifted.copy_(boards)
    assert shifted.data_ptr() % 16 == 8
    got = _launched_once("rollout", step_cuda.rollout, shifted, 37)
    assert torch.equal(got, step_cuda.rollout_plain(boards, 37))
    out = torch.empty_like(boards)
    with pytest.raises(RuntimeError, match="life_rollout failed"):
        step_cuda._launch(step_cuda._build.library().life_rollout, shifted.data_ptr(),
                          out.data_ptr(), 77, 3, step_cuda._stream(device))


@pytest.mark.parametrize("batch", [1, 7, 8193])
def test_rollout_lohi_equals_rollout_through_the_layout(device, batch):
    boards = _random_boards(torch.Generator().manual_seed(batch), batch, 0.4, device)
    got = step_cuda.rollout_lohi(*step_cuda.to_kernel_layout(boards), 61)
    want = step_cuda.to_kernel_layout(step_cuda.rollout(boards, 61))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", ["rollout", "rollout_lohi"])
def test_pair_layout_rollouts_fill_an_sm_without_spilling(device, name):
    blocks, regs, local = step_cuda.rollout_kernel_info(name)
    assert blocks >= 8 and regs <= 32 and local == 0


def _catalyst_inputs(batch, steps, device):
    """The catalyst rollout's inputs for the glider and eater: at 4096 boards
    the full grid's offsets (the main path's), else seeded random ones."""
    glider = B.from_cells([(8, 10), (9, 8), (9, 10), (10, 9), (10, 10)], device="cpu")
    eater = B.from_cells([(24, 21), (24, 22), (25, 21), (25, 23), (26, 23),
                          (27, 23), (27, 24)], device="cpu")
    if batch == 4096:
        offsets = torch.tensor([[dx, dy] for dx in range(64) for dy in range(64)])
    else:
        offsets = torch.randint(-16, 16, (batch, 2),
                                generator=torch.Generator().manual_seed(batch * 1000 + steps))
    return [t.to(device) for t in rollout_inputs(glider, eater, offsets, steps)]


@pytest.mark.parametrize("steps", [0, 1, 2, 3, 5, 64, 100])
@pytest.mark.parametrize("batch", [1, 33, 4096])
def test_catalyst_kernel_at_every_batch_and_horizon(device, batch, steps):
    """Kernel [3], lane l on columns 2l and 2l + 1, against its twin bit for
    bit, final boards and flags: one board, a block and a partial one, the
    main path's 4096 offsets; no generation, the remainders of the loop
    unrolled by 4, and the main path's horizons 64 and 100.  One launch,
    and a second launch gives the same bits."""
    inputs = _catalyst_inputs(batch, steps, device)
    got = _launched_once("catalyst_rollout", step_cuda.catalyst_rollout, *inputs)
    want = step_cuda.catalyst_rollout_plain(*inputs)
    again = step_cuda.catalyst_rollout(*inputs)
    for g, w, a in zip(got, want, again):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(a, g)
    if steps == 0:
        assert not got[1].any() and torch.equal(got[0], inputs[0])
    if batch == 4096 and steps >= 64:
        assert 0 < int(got[1].sum()) < batch  # the grid holds both kinds


@pytest.mark.parametrize("which", range(4))
def test_catalyst_kernel_reads_inputs_that_start_8_bytes_in(device, which):
    """Kernel [3] reads a lane's two columns of each input as one 16-byte
    word: an input (boards, placed, placed_zoi or base_traj) whose data
    starts 8 bytes past 16 is copied by the wrapper and gives the same bits;
    the launcher refuses such a pointer itself."""
    inputs = _catalyst_inputs(33, 64, device)
    store = torch.zeros(inputs[which].numel() + 1, dtype=torch.int64, device=device)
    shifted = store[1:].view(inputs[which].shape)
    shifted.copy_(inputs[which])
    assert shifted.data_ptr() % 16 == 8
    args = list(inputs)
    args[which] = shifted
    got = _launched_once("catalyst_rollout", step_cuda.catalyst_rollout, *args)
    want = step_cuda.catalyst_rollout_plain(*inputs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    final = torch.empty_like(inputs[0])
    interacted = torch.empty(33, dtype=torch.bool, device=device)
    with pytest.raises(RuntimeError, match="life_catalyst_rollout failed"):
        step_cuda._launch(step_cuda._build.library().life_catalyst_rollout,
                          *(a.data_ptr() for a in args), final.data_ptr(),
                          interacted.data_ptr(), 33, 64, step_cuda._stream(device))


def test_catalyst_kernel_never_spills(device):
    """Kernel [3] holds the board, placed, placed_zoi and the accumulator in
    registers without spilling, and the main path's 512 blocks of 8 warps
    fit the card at once (4 an SM)."""
    blocks, regs, local = step_cuda.rollout_kernel_info("catalyst_rollout")
    assert local == 0 and blocks >= 4


def test_rollout_lohi_kernel_rejects_bad_input(device):
    boards = _random_boards(torch.Generator().manual_seed(2), 40, 0.3, device)
    lo, hi = step_cuda.to_kernel_layout(boards)
    with pytest.raises(TypeError):
        step_cuda.rollout_lohi(lo.to(torch.int64), hi, 3)
    with pytest.raises(ValueError):
        step_cuda.rollout_lohi(lo[:, ::2], hi[:, ::2], 3)
    with pytest.raises(ValueError):
        step_cuda.rollout_lohi(lo, hi.cpu(), 3)


# ---------------------------------------------------------------------------
# Still-life kernels (csrc/life_stable.cu) against their twins
# ---------------------------------------------------------------------------

def _block_instances(rng, b, p_hide, n_blocks=5):
    """Partial still lifes: 2x2 blocks with cells hidden and a 2-ring of
    unknowns; a high ``p_hide`` makes some of them inconsistent."""
    states, unknowns = [], []
    for _ in range(b):
        truth = np.zeros((64, 64), bool)
        for _ in range(n_blocks):
            x, y = rng.integers(4, 56, 2)
            truth[x:x + 2, y:y + 2] = True
        hide = (rng.random((64, 64)) < p_hide) & H.zoi(truth)
        states.append(truth & ~hide)
        unknowns.append(hide | (H.zoi(H.zoi(truth)) & ~truth))
    return _planes(np.stack(states), np.stack(unknowns))


def _planes(states, unknowns):
    bst = BP.make(state=B.from_dense(torch.from_numpy(states)),
                  unknown=B.from_dense(torch.from_numpy(unknowns)))
    return BP.to_planes(bst).contiguous()


def _stable_inputs(device):
    """Consistent instances, noisy boards (mostly inconsistent) and
    instances with many hidden cells."""
    rng = np.random.default_rng(0)
    noise_state = rng.random((40, 64, 64)) < 0.15
    noise_unknown = (rng.random((40, 64, 64)) < 0.25) & ~noise_state
    planes = torch.cat([_block_instances(rng, 60, 0.3),
                        _planes(noise_state, noise_unknown),
                        _block_instances(rng, 60, 0.7)])
    return planes.to(device)


def _eater_problem(b, device):
    eater = B.move(rle.parse("2b2o$bobo$bo$2o!", device="cpu"), 20, 20)
    hide = B.from_cells([(20, 20), (21, 20)], device="cpu")
    unknown = (B.zoi(eater) & ~eater) | hide
    bst = BP.make(state=(eater & ~hide).expand(b, 64), unknown=unknown.expand(b, 64))
    return BP.to_planes(bst).contiguous().to(device), (eater & ~hide).to(device)


def _run_pair(name, args, kwargs=None):
    kwargs = kwargs or {}
    kernel = getattr(stable_cuda, name)
    plain = getattr(stable_cuda, f"{name}_plain")
    before = stable_cuda.LAUNCHES[name]
    got = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    assert stable_cuda.LAUNCHES[name] == before + 1
    expect = plain(*args, **kwargs)
    for g, e in zip(got, expect):
        assert g.device == e.device and g.dtype == e.dtype
        assert torch.equal(g, e)
    return got


@pytest.mark.parametrize("name", ["propagate_step", "propagate_fixpoint",
                                  "propagate_fixpoint_priorities"])
def test_stable_kernel_matches_plain_twin(device, name):
    _run_pair(name, (_stable_inputs(device),))


@pytest.mark.parametrize("name", ["propagate_fused", "propagate_fused_beam"])
def test_stable_entries_match_plain_and_count(device, name):
    """The two BitStable entries ([6] over kernel B, [9] over kernel C)
    against their plain versions ([6]'s a host loop over A's twin), and
    their launch counts: one call, one launch of the inner kernel, counted
    once, under the entry that made it."""
    bst = BP.from_planes(_stable_inputs(device))
    before = dict(stable_cuda.LAUNCHES)
    got = getattr(stable_cuda, name)(bst)
    torch.cuda.synchronize()
    added = {k: v - before[k] for k, v in stable_cuda.LAUNCHES.items() if v != before[k]}
    assert added == {name: 1}
    want = getattr(stable_cuda, f"{name}_plain")(bst)
    if name == "propagate_fused":
        got, want = (got, ()), (want, ())
    (g, glv), (w, wlv) = got, want
    assert torch.equal(BP.to_planes(g.stable), BP.to_planes(w.stable))
    assert torch.equal(g.consistent, w.consistent) and torch.equal(g.changed, w.changed)
    assert all(torch.equal(a, b) for a, b in zip(glv, wlv))


@pytest.mark.parametrize("max_iters", [1, 2])
def test_propagate_fused_is_one_launch_at_a_step_cap(device, max_iters):
    """[6] at a step cap: every board takes at most ``max_iters`` steps, as
    in the host loop of its plain version, in one launch of kernel B that
    reads nothing back (a synchronising call raises in the sync debug
    mode)."""
    bst = BP.from_planes(_stable_inputs(device))
    before = dict(stable_cuda.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = stable_cuda.propagate_fused(bst, max_iters)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    added = {k: v - before[k] for k, v in stable_cuda.LAUNCHES.items() if v != before[k]}
    assert added == {"propagate_fused": 1}
    want = stable_cuda.propagate_fused_plain(bst, max_iters)
    assert torch.equal(BP.to_planes(got.stable), BP.to_planes(want.stable))
    assert torch.equal(got.consistent, want.consistent)
    assert torch.equal(got.changed, want.changed)
    if max_iters == 1:  # the cap stops some board short of its fixpoint
        full = stable_cuda.propagate_fused(bst)
        assert not torch.equal(BP.to_planes(got.stable), BP.to_planes(full.stable))


def test_stable_fixpoint_some_boards_abort(device):
    _, consistent, _ = _run_pair("propagate_fixpoint", (_stable_inputs(device),))
    assert consistent.any() and not consistent.all()


# the three BitStable entries and the counter their launch of B or C adds to
ENTRY_COUNTS = {"propagate_fused": "propagate_fused",
                "propagate_fused_inkernel": "propagate_fixpoint",
                "propagate_fused_beam": "propagate_fused_beam"}


def _entry_tensors(result):
    res, levels = (result, ()) if isinstance(result, BP.BitPropagateResult) else result
    return (res.stable.state, res.stable.unknown, *res.stable.ruled, res.consistent,
            res.changed, *levels)


def _run_entry(name, bst, **kw):
    """One call of a BitStable entry against its plain version, bit for bit:
    one launch, counted once under the entry's counter; every returned
    plane and level contiguous."""
    before = dict(stable_cuda.LAUNCHES)
    got = getattr(stable_cuda, name)(bst, **kw)
    torch.cuda.synchronize()
    added = {k: v - before[k] for k, v in stable_cuda.LAUNCHES.items() if v != before[k]}
    assert added == {ENTRY_COUNTS[name]: 1}
    want = getattr(stable_cuda, f"{name}_plain")(bst, **kw)
    got_t, want_t = _entry_tensors(got), _entry_tensors(want)
    assert len(got_t) == len(want_t)
    for g, w in zip(got_t, want_t):
        assert g.device == w.device and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)
        assert g.is_contiguous()
    return got


def _off16(plane):
    """A copy of ``plane`` whose data starts 8 bytes past 16."""
    store = torch.zeros(plane.numel() + 1, dtype=torch.int64, device=plane.device)
    shifted = store[1:].view(plane.shape)
    shifted.copy_(plane)
    assert shifted.data_ptr() % 16 == 8
    return shifted


def _layout(planes, layout):
    """A BitStable over ``int64[B, 10, 64]`` planes: views of the stacked
    tensor (board stride 640), separate planes as ``BP.make`` gives them
    (stride 64), or those with the unknown plane 8 bytes off 16 (read in
    place too)."""
    if layout == "views":
        return BP.from_planes(planes)
    bst = BP.BitStable(*(p.contiguous() for p in planes.unbind(1)[:2]),
                       tuple(p.contiguous() for p in planes.unbind(1)[2:]))
    return bst._replace(unknown=_off16(bst.unknown)) if layout == "off16" else bst


@pytest.mark.parametrize("layout", ["views", "make", "off16"])
@pytest.mark.parametrize("name", list(ENTRY_COUNTS))
def test_bitstable_entries_on_every_layout(device, name, layout):
    """[6], [7] and [9] through their BitStable entries, inconsistent boards
    included, with the planes read in place: views of one tensor, separate
    planes, and a plane 8 bytes off 16."""
    planes = _stable_inputs(device)
    got = _run_entry(name, _layout(planes, layout))
    res = got[0] if name == "propagate_fused_beam" else got
    assert res.consistent.any() and not res.consistent.all()


@pytest.mark.parametrize("max_iters", [1, 2, 256])
@pytest.mark.parametrize("name", list(ENTRY_COUNTS))
def test_bitstable_entries_at_step_caps_on_a_2d_batch(device, name, max_iters):
    planes = _stable_inputs(device)
    _run_entry(name, BP.from_planes(planes.view(8, 20, BP.N_PLANES, 64)), max_iters=max_iters)


def _resident_warps(priorities):
    blocks, _, _ = stable_cuda.fixpoint_kernel_info(priorities)
    return torch.cuda.get_device_properties(0).multi_processor_count * blocks * 4


@pytest.mark.parametrize("batch", [1, 5, 4096, "ragged"])
def test_fixpoint_kernels_at_every_batch(device, batch):
    """Kernels B and C through the planes API and [9]'s entry on 1 board,
    5, 4096 and one and a half times the warps the card holds at once plus
    one (a last block of one warp)."""
    b = _resident_warps(True) * 3 // 2 + 1 if batch == "ragged" else batch
    pool = _stable_inputs(device)
    planes = pool[torch.arange(b, device=device) % pool.shape[0]].contiguous()
    _run_pair("propagate_fixpoint", (planes,))
    _run_pair("propagate_fixpoint_priorities", (planes,))
    _run_entry("propagate_fused_beam", BP.from_planes(planes))


@pytest.mark.parametrize("name", list(ENTRY_COUNTS))
def test_bitstable_entry_is_one_kernel_and_no_readback(device, name):
    """One call of each BitStable entry on a CUDA BitStable: no readback (a
    synchronising call raises in the sync debug mode) and, in a profiler
    trace, one fixpoint_kernel launch and no other kernel (no stack, copy
    or fill).  Traces on the card may drop launches, so an empty trace is
    taken again, up to 3 times."""
    import chip_smoke

    bst = _layout(_stable_inputs(device), "make")
    getattr(stable_cuda, name)(bst)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        getattr(stable_cuda, name)(bst)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for _ in range(3):
        kernels = {e.key: e.count for e in chip_smoke._trace(
            lambda: getattr(stable_cuda, name)(bst), 1)}
        if kernels:
            break
    assert len(kernels) == 1 and "fixpoint_kernel" in next(iter(kernels)), kernels
    assert list(kernels.values()) == [1], kernels


def test_fixpoint_kernels_never_spill(device):
    """ptxas gives kernels B and C their registers without spills (the board
    twice, about 168 a thread), and the runtime finds no local memory and
    at least 3 resident blocks of 4 warps an SM for both."""
    import chip_smoke
    from lifeapi_tpu_torch.ops import _build

    report = chip_smoke.ptxas_report(_build.library_path().with_suffix(".log").read_text())
    fix = {name: (regs, spill) for name, regs, spill in report
           if name.startswith("fixpoint_kernel")}
    assert sorted(fix) == ["fixpoint_kernel<0>", "fixpoint_kernel<1>"], fix
    assert all(spill == 0 for _, spill in fix.values()), fix
    for priorities in (False, True):
        blocks, regs, local = stable_cuda.fixpoint_kernel_info(priorities)
        assert blocks >= 3 and local == 0, (priorities, blocks, regs, local)


def test_bitstable_entries_reject_bad_planes(device):
    bst = _layout(_stable_inputs(device)[:8], "make")
    with pytest.raises(TypeError):
        stable_cuda.propagate_fused(bst._replace(state=bst.state.to(torch.int32)))
    with pytest.raises(ValueError):
        stable_cuda.propagate_fused_inkernel(bst._replace(unknown=bst.unknown[:4]))
    with pytest.raises(ValueError):
        stable_cuda.propagate_fused_beam(bst._replace(unknown=bst.unknown.cpu()))


@pytest.mark.parametrize("frontier,iters,minimise", [(2, 10, True), (4, 24, True),
                                                     (8, 12, True), (8, 12, False),
                                                     (16, 6, True)])
def test_beam_kernel_matches_plain_twin(device, frontier, iters, minimise):
    rng = np.random.default_rng(frontier)
    planes = torch.cat([_eater_problem(4, device)[0],
                        _block_instances(rng, 12, 0.35).to(device)])
    got = _run_pair("beam_search", (planes,),
                    dict(frontier=frontier, iters=iters, minimise=minimise))
    if frontier >= 4 and iters >= 24:
        assert got[2][:4].all() and (got[1][:4] == 7).all()


def _fixpoint_spread(planes, frontier, iters, monkeypatch):
    """The largest difference, in one round of one problem, between the
    fixpoint lengths (steps) of two active slots, from the plain twin."""
    fixpoint, spread = stable_cuda._fixpoint, [0]

    def counted(p, max_iters, alive=None):
        steps = torch.zeros(alive.shape, dtype=torch.int64, device=alive.device)
        live = alive.clone()
        aborted, changed = torch.zeros_like(alive), torch.zeros_like(alive)
        for _ in range(max_iters):
            if not bool(live.any()):
                break
            steps += live
            p, ab, ch = fixpoint(p, 1, live)
            aborted, changed = aborted | ab, changed | ch
            live = live & ~ab & ch
        longest = torch.where(alive, steps, -1).max(dim=1).values
        shortest = torch.where(alive, steps, 2**30).min(dim=1).values
        pairs = alive.sum(dim=1) >= 2
        spread[0] = max(spread[0], int(torch.where(pairs, longest - shortest, 0).max()))
        return p, aborted, changed

    with monkeypatch.context() as m:
        m.setattr(stable_cuda, "_fixpoint", counted)
        stable_cuda.beam_search_plain(planes, frontier=frontier, iters=iters, minimise=True)
    return spread[0]


@pytest.mark.parametrize("frontier,iters", [(4, 12), (16, 6)])
def test_beam_kernel_uneven_fixpoints(device, frontier, iters, monkeypatch):
    """Slots whose fixpoints in one round differ by 8 steps or more: the
    warps that finish early wait at the round's barrier."""
    planes = _block_instances(np.random.default_rng(6), 24, 0.5, n_blocks=12).to(device)
    assert _fixpoint_spread(planes, frontier, iters, monkeypatch) >= 8
    _run_pair("beam_search", (planes,), dict(frontier=frontier, iters=iters, minimise=True))


def test_beam_kernel_drops_children_past_the_frontier(device):
    """Every problem has more ok children than F = 2 slots in some round, so
    none is complete, and the kernel drops the same children as the twin."""
    planes = _block_instances(np.random.default_rng(11), 24, 0.5, n_blocks=8).to(device)
    got = _run_pair("beam_search", (planes,), dict(frontier=2, iters=8, minimise=True))
    assert not got[3].any()


def test_beam_kernel_seed_and_bound(device):
    planes, known = _eater_problem(6, device)
    seed = known.expand(6, 64).contiguous()
    _run_pair("beam_search", (planes,), dict(frontier=4, iters=24, minimise=True, seed=seed))
    for bound, found in ((7, False), (8, True)):
        b = torch.full((6,), bound, dtype=torch.int32, device=device)
        got = _run_pair("beam_search", (planes,),
                        dict(frontier=4, iters=24, minimise=True, bound=b))
        assert bool(got[2].all()) is found and bool(got[2].any()) is found
        assert (got[1] == 7).all()


# ---------------------------------------------------------------------------
# Convolution and calibration kernels (csrc/life_conv.cu, life_calibrate.cu)
# ---------------------------------------------------------------------------

def _conv_operands(device):
    """a: random p=0.5 boards; b: empty, sparse (1-40 cells) and dense (p=0.5)
    operands, so counts pass both 193 and 257."""
    rng = np.random.default_rng(3)
    da = rng.random((300, 64, 64)) < 0.5
    db = np.zeros((300, 64, 64), bool)
    for i in range(1, 200):
        k = int(rng.integers(1, 41))
        db[i, rng.integers(0, 64, k), rng.integers(0, 64, k)] = True
    db[200:] = rng.random((100, 64, 64)) < 0.5
    return torch.from_numpy(da).to(device), torch.from_numpy(db).to(device)


def _conv_pair(module, name, args, kwargs=None):
    kwargs = kwargs or {}
    before = module.LAUNCHES[name]
    got = getattr(module, name)(*args, **kwargs)
    torch.cuda.synchronize()
    assert module.LAUNCHES[name] == before + 1
    expect = getattr(module, f"{name}_plain")(*args, **kwargs)
    got = got if isinstance(got, (tuple, list)) else (got,)
    expect = expect if isinstance(expect, (tuple, list)) else (expect,)
    assert len(got) == len(expect)
    for g, e in zip(got, expect):
        assert g.device == e.device and g.dtype == e.dtype and g.shape == e.shape
        assert torch.equal(g, e)
    return got


@pytest.mark.parametrize("n_planes", [None, 1, 6, 13])
def test_peel_kernels_match_plain_twins(device, n_planes):
    da, db = _conv_operands(device)
    a, b = B.from_dense(da), B.from_dense(db)
    if n_planes is None:
        _conv_pair(conv_cuda, "convolve_sparse_fused", (a[:200], b[:200]))
        _conv_pair(conv_cuda, "convolve_sparse_fused", (a[7], b[:50]))  # broadcast
    else:
        _conv_pair(conv_cuda, "counts_sparse_fused", (a[190:210], b[190:210]),
                   dict(n_planes=n_planes))


def _dense_peel_operands(device):
    """a: p=0.3 boards; b: p=0.3 boards (about 1200 cells each, so the
    warp's list of 64 cells wraps some 19 times), a full board (4096 cells)
    and an empty one."""
    rng = np.random.default_rng(5)
    da = rng.random((24, 64, 64)) < 0.3
    db = rng.random((24, 64, 64)) < 0.3
    db[0], db[1] = True, False
    a, b = (B.from_dense(torch.from_numpy(d).to(device)) for d in (da, db))
    assert int(B.population(b[2:]).min()) >= 1000
    return a, b


def test_peel_kernels_on_a_dense_operand(device):
    """[11], [12] and the union peel where b's cells wrap the list's chunk
    many times; the union peels each query's smaller side, the dense one
    where a is the sparser."""
    a, b = _dense_peel_operands(device)
    _conv_pair(conv_cuda, "convolve_sparse_fused", (a, b))
    for n_planes in (1, 13):
        _conv_pair(conv_cuda, "counts_sparse_fused", (a, b), dict(n_planes=n_planes))
    sparse = B.from_dense((torch.rand((24, 64, 64), generator=torch.Generator().manual_seed(6))
                           < 0.002).to(device))
    _conv_pair(conv_cuda, "union_sparse_fused", ([(a, b), (b, sparse), (sparse, b.flip(0))],))


def test_union_kernel_reads_operands_in_place(device):
    """Operands read where they lie: an unbatched side against a batch
    (board stride 0), every other board of a store (stride 128), a 2-D
    batch of those, and an operand whose batch does not flatten to one
    stride (copied); each call one launch, equal to the plain version."""
    rng = np.random.default_rng(8)
    store = B.from_dense(torch.from_numpy(rng.random((64, 64, 64)) < 0.1).to(device))
    odd, even = store[1::2], store[::2]
    one = B.from_cells([(3, 4), (63, 63), (0, 31), (40, 2)], device=device)
    for pairs in ([(even, one)], [(one, odd), (even, odd), (odd, one[None])],
                  [(even.reshape(4, 8, 64), odd.reshape(4, 8, 64)),
                   (one, even[:8].reshape(1, 8, 64)), (odd[:4].reshape(4, 1, 64), one)]):
        _conv_pair(conv_cuda, "union_sparse_fused", (pairs,))
    _conv_pair(conv_cuda, "convolve_sparse_fused", (even, one))
    _conv_pair(conv_cuda, "convolve_sparse_fused", (one, odd))


def test_union_is_one_kernel_and_no_readback(device):
    """union_interacting(method="sparse") on the seven mask pairs of
    interaction_offsets over a batch: no readback (a synchronising call
    raises in the sync debug mode), one launch a call by the counter, and
    in a profiler trace of 10 calls union_sparse_kernel launches and no
    other kernel (no stack, population, where or OR), at most one a call.
    Traces on the card drop launches, a few a trace, so an empty trace is
    taken again, up to 3 times."""
    import chip_smoke
    from lifeapi_tpu_torch.core import convolve as CV

    rng = np.random.default_rng(9)
    a, b = (B.from_dense(torch.from_numpy(rng.random((256, 64, 64)) < 0.003).to(device))
            for _ in range(2))
    pairs = CV.interaction_pairs(a, b)
    call = lambda: CV.union_interacting(pairs, method="sparse")
    want = conv_cuda.union_sparse_fused_plain(pairs)
    before = conv_cuda.LAUNCHES["union_sparse_fused"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert conv_cuda.LAUNCHES["union_sparse_fused"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, CV.interaction_offsets(a, b, method="ntt_fused"))
    for _ in range(3):
        kernels = {e.key: e.count for e in chip_smoke._trace(call, 10)}
        if kernels:
            break
    assert len(kernels) == 1 and "union_sparse_kernel" in next(iter(kernels)), kernels
    assert 0 < next(iter(kernels.values())) <= 10, kernels


def test_dense_counts_kernels_match_plain_twins(device):
    da, db = _conv_operands(device)
    da[0] = db[0] = True  # every count 4096
    counts = _conv_pair(conv_cuda, "conv_counts_fused", (da, db))[0]
    assert int(counts[0].min()) == 4096 and int(counts.max()) == 4096
    for out_or in (True, False):
        _conv_pair(conv_cuda, "conv_small_fused", (da, db), dict(out_or=out_or))
    a, b = B.from_dense(da), B.from_dense(db)
    _conv_pair(conv_cuda, "conv_small_packed", (a[:299], b[:299]))  # odd batch


def test_dense_counts_epilogues_agree(device):
    """The three epilogues of one kernel body, and the peel's 13 planes,
    against one another on the card."""
    da, db = _conv_operands(device)
    counts = conv_cuda.conv_counts_fused(da, db)
    assert int(counts.max()) > 257
    residue = conv_cuda.conv_small_fused(da, db, out_or=False)
    mask = conv_cuda.conv_small_fused(da, db, out_or=True)
    packed = conv_cuda.conv_small_packed(B.from_dense(da), B.from_dense(db))
    planes = conv_cuda.counts_sparse_fused(B.from_dense(da[:64]), B.from_dense(db[:64]), 13)
    torch.cuda.synchronize()
    assert torch.equal(residue, counts % 193)
    assert torch.equal(mask, (counts % 193 != 0).to(torch.int8))
    assert torch.equal(packed, B.from_dense(mask != 0))
    peeled = sum(B.to_dense(p).to(torch.int32) << i for i, p in enumerate(planes))
    assert torch.equal(peeled, counts[:64])


def _ntt_operands(batch, device):
    """p=0.5 pairs (counts above 257), with an all-ON pair, an all-OFF pair,
    a single-cell pair and an ON board against an OFF one in front."""
    rng = np.random.default_rng(batch)
    da = rng.random((batch, 64, 64)) < 0.5
    db = rng.random((batch, 64, 64)) < 0.5
    fronts = [(True, True), (False, False), ((3, 60), (63, 9)), (True, False)]
    for i, (fa, fb) in enumerate(fronts[:batch]):
        for d, f in ((da, fa), (db, fb)):
            d[i] = f if isinstance(f, bool) else False
            if not isinstance(f, bool):
                d[i][f] = True
    return torch.from_numpy(da).to(device), torch.from_numpy(db).to(device)


@pytest.mark.parametrize("batch", [1, 5, 1000])
def test_ntt_kernels_match_twins_and_peel(device, batch):
    """The NTT kernels [13] and [14] against their twins and against the
    peel [12] at 13 planes, on one board, on fewer boards than resident
    blocks and on a batch the persistent blocks share unevenly."""
    da, db = _ntt_operands(batch, device)
    counts = _conv_pair(conv_cuda, "conv_counts_fused", (da, db))[0]
    residue = _conv_pair(conv_cuda, "conv_small_fused", (da, db), dict(out_or=False))[0]
    mask = _conv_pair(conv_cuda, "conv_small_fused", (da, db), dict(out_or=True))[0]
    planes = conv_cuda.counts_sparse_fused(B.from_dense(da), B.from_dense(db), 13)
    peeled = sum(B.to_dense(p).to(torch.int32) << i for i, p in enumerate(planes))
    assert torch.equal(counts, peeled)
    assert torch.equal(residue, counts % 193)
    assert torch.equal(mask, (counts % 193 != 0).to(torch.int8))
    assert int(counts[0].min()) == 4096 and int(counts.max()) == 4096
    if batch > 1:
        assert int(counts[1].max()) == 0 and int(mask[1].max()) == 0
    if batch > 2:
        cell = torch.zeros((64, 64), dtype=torch.int32, device=device)
        cell[(3 + 63) % 64, (60 + 9) % 64] = 1  # a single cell times a single cell
        assert torch.equal(counts[2], cell)
        assert int(counts[3].max()) == 0
    if batch > 4:
        assert int(counts[4:].max()) >= 257 and int(residue.max()) < 193


@pytest.mark.parametrize("batch", [1, 5, 1000])
def test_packed_ntt_kernel_matches_twin_and_dense_mask(device, batch):
    """[15] on packed boards: all-ON, all-OFF, single cells, an ON board
    against an OFF one and p=0.5 pairs (counts above 193, where the mask is
    count % 193 != 0), against its twin and the dense mask kernel, on
    aligned boards and on boards that start 8 bytes past 16."""
    da, db = _ntt_operands(batch, device)
    a, b = B.from_dense(da), B.from_dense(db)
    got = _conv_pair(conv_cuda, "conv_small_packed", (a, b))[0]
    mask = conv_cuda.conv_small_fused(da, db, out_or=True)
    assert torch.equal(got, B.from_dense(mask != 0))
    assert bool((got[0] == -1).all())  # every count 4096, and 4096 % 193 == 43
    if batch > 1:
        assert int(got[1].abs().sum()) == 0
    if batch > 2:
        assert torch.equal(got[2], B.from_cells([(2, 5)], device=device))
    store = torch.zeros((2, batch * 64 + 2), dtype=torch.int64, device=device)
    ua, ub = (t[1:batch * 64 + 1].view(batch, 64) for t in store)
    ua.copy_(a)
    ub.copy_(b)
    assert ua.data_ptr() % 16 == 8 and ub.data_ptr() % 16 == 8
    before = conv_cuda.LAUNCHES["conv_small_packed"]
    assert torch.equal(conv_cuda.conv_small_packed(ua, ub), got)
    assert conv_cuda.LAUNCHES["conv_small_packed"] == before + 1


def test_ntt_kernels_take_unaligned_fields_and_other_on_bytes(device):
    """A field whose data does not start on 16 bytes, and ON bytes other
    than 1, give the counts of the 0/1 fields."""
    da, db = _ntt_operands(7, device)
    want = conv_cuda.conv_counts_fused(da, db)
    store = torch.zeros(7 * 4096 + 1, dtype=torch.uint8, device=device)
    shifted = store[1:].view(7, 64, 64)
    shifted.copy_(da.to(torch.uint8) * 77)
    noisy = db.to(torch.int8) * -3
    assert shifted.data_ptr() % 16
    assert torch.equal(conv_cuda.conv_counts_fused(shifted, noisy), want)
    assert torch.equal(conv_cuda.conv_small_fused(shifted, noisy, out_or=False), want % 193)


def test_cuda_tensors_never_reach_the_ntt_twins(device, monkeypatch):
    da, db = _ntt_operands(9, device)
    want = ntt.counts(da, db).to(torch.int32)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain twin")

    monkeypatch.setattr(conv_cuda, "conv_counts_fused_plain", refuse)
    monkeypatch.setattr(conv_cuda, "conv_small_fused_plain", refuse)
    before = dict(conv_cuda.LAUNCHES)
    counts = conv_cuda.conv_counts_fused(da, db)
    residue = conv_cuda.conv_small_fused(da, db, out_or=False)
    torch.cuda.synchronize()
    assert conv_cuda.LAUNCHES["conv_counts_fused"] == before["conv_counts_fused"] + 1
    assert conv_cuda.LAUNCHES["conv_small_fused"] == before["conv_small_fused"] + 1
    assert torch.equal(counts, want) and torch.equal(residue, want % 193)


def test_beam_kernel_never_spills(device):
    """ptxas gives every instantiation of the beam kernel its registers
    without spills, and the runtime finds no local memory and 16 warps an
    SM at every frontier."""
    import chip_smoke
    from lifeapi_tpu_torch.ops import _build

    report = chip_smoke.ptxas_report(_build.library_path().with_suffix(".log").read_text())
    beam = {name: spill for name, _, spill in report if name.startswith("beam_kernel")}
    assert sorted(beam) == [f"beam_kernel<{f}>" for f in (16, 2, 4, 8)]
    assert all(spill == 0 for spill in beam.values()), beam
    for frontier in (2, 4, 8, 16):
        blocks, regs, local = stable_cuda.beam_kernel_info(frontier)
        assert local == 0 and regs <= 128 and blocks * frontier == 16, (frontier, blocks, regs)


def test_ntt_kernel_occupancy(device):
    info = conv_cuda.ntt_kernel_info()
    assert sorted(info) == sorted(conv_cuda.NTT_INSTANTIATIONS)
    assert all(blocks >= 1 and local == 0 for blocks, _, local in info.values()), info


@pytest.mark.parametrize("mix", ["elemwise", "rolls"])
def test_calibrate_kernel_matches_plain_twin(device, mix):
    gen = torch.Generator().manual_seed(5)
    info = torch.iinfo(torch.int64)
    a, b = (torch.randint(info.min, info.max, (77, 64), dtype=torch.int64, generator=gen)
            .to(device) for _ in range(2))
    before = calibrate_cuda.LAUNCHES["calibrate"]
    got, ops = calibrate_cuda.calibrate(a, b, 9, mix=mix)
    torch.cuda.synchronize()
    assert calibrate_cuda.LAUNCHES["calibrate"] == before + 1
    assert torch.equal(got, calibrate_cuda.calibrate_plain(a, b, 9, mix=mix))
    assert ops == 9 * calibrate_cuda.ops_per_iter(mix) * 77 * 64


def test_conv_kernels_reject_bad_input(device):
    da, db = _conv_operands(device)
    a = B.from_dense(da[:8])
    with pytest.raises(ValueError):
        conv_cuda.convolve_sparse_fused(a, a.cpu())
    with pytest.raises(ValueError):
        conv_cuda.counts_sparse_fused(a, a, 14)
    with pytest.raises(ValueError):
        conv_cuda.union_sparse_fused([(a, a.cpu())])
    with pytest.raises(ValueError):
        conv_cuda.union_sparse_fused([(a, a)] * 9)
    with pytest.raises(TypeError):
        conv_cuda.conv_counts_fused(da[:8].float(), db[:8])
    with pytest.raises(ValueError):
        calibrate_cuda.calibrate(a, a, -1)


def test_stable_kernels_reject_bad_input(device):
    planes, _ = _eater_problem(4, device)
    with pytest.raises(TypeError):
        stable_cuda.propagate_fixpoint(planes.to(torch.int32))
    with pytest.raises(ValueError):
        stable_cuda.propagate_step(planes[:, :, ::2])
    with pytest.raises(ValueError):
        stable_cuda.beam_search(planes, frontier=3, iters=4, minimise=True)
    with pytest.raises(ValueError):
        stable_cuda.beam_search(planes, frontier=32, iters=4, minimise=True)


def test_stable_consistency_is_one_launch_of_kernel_b(device):
    """``mpc.symmetric.stable_consistency`` on CUDA boards is one launch of
    kernel B with no host sync, and equals ``bitplane.propagate``'s flags
    on blocks, blocks with a stray cell and random boards."""
    from lifeapi_tpu_torch.mpc import symmetric

    gen = torch.Generator().manual_seed(5)
    blocks = B.move_dyn(rle.parse("2o$2o!", device="cpu"), torch.randint(16, 46, (64,), generator=gen),
                        torch.randint(16, 46, (64,), generator=gen))
    stray = B.from_cells([(31, 33)], device="cpu").expand(64, 64)
    finals = torch.cat([blocks, blocks | stray, _random_boards(gen, 64, 0.1, "cpu")]).to(device)
    region = torch.zeros((64, 64), dtype=torch.bool, device=device)
    region[12:52, 12:52] = True
    symmetric.stable_consistency(finals, region)
    torch.cuda.synchronize()
    before = dict(stable_cuda.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = symmetric.stable_consistency(finals, region)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    added = {k: v - before[k] for k, v in stable_cuda.LAUNCHES.items() if v != before[k]}
    assert added == {"propagate_fused": 1}
    want = symmetric.stable_consistency_plain(finals, region)
    assert torch.equal(got, want)
    assert got[:64].all() and not got.all()


def test_run_fused_makes_no_host_sync(device):
    """``mpc.receding.run_fused`` from a generator on the card: no host sync
    in the whole call, launches of kernel [2] one a round, and boards that
    follow the exact step."""
    from lifeapi_tpu_torch.examples import receding_mpc
    from lifeapi_tpu_torch.mpc import receding

    problem = receding_mpc.problem(device, horizon=4)
    gen = torch.Generator(device=device).manual_seed(0)
    receding.run_fused(problem, gen, steps=2, apply_horizon=2, n_candidates=4, solve_iters=2)
    torch.cuda.synchronize()
    before = step_cuda.LAUNCHES["controlled_rollout"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        run = receding.run_fused(problem, gen, steps=6, apply_horizon=2, n_candidates=4,
                                 solve_iters=5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert step_cuda.LAUNCHES["controlled_rollout"] == before + 3
    assert run.boards.shape == (7, 64) and run.costs.shape == (3,)
    for i in range(6):
        assert torch.equal(run.boards[i + 1], step_cuda.rollout_plain(
            (run.boards[i] ^ run.applied[i])[None], 1)[0])


# ---------------------------------------------------------------------------
# the C oracle on the card's rollout; the mesh and runners over NCCL
# ---------------------------------------------------------------------------


def test_rollout_kernel_matches_c_oracle(device):
    from lifeapi_tpu_torch import native

    boards = _random_boards(torch.Generator().manual_seed(4), 1024, 0.4, device)
    got = step_cuda.rollout(boards, 64)
    want = native.step_packed64(native.to_packed64(boards), 64)
    assert (native.to_packed64(got) == want).all()


@pytest.fixture
def nccl_mesh(device):
    import torch.distributed as dist

    from lifeapi_tpu_torch.parallel import destroy, make_mesh

    try:
        mesh = make_mesh()
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        yield mesh
    finally:
        destroy()


def test_sharded_rollout_over_nccl(nccl_mesh):
    from lifeapi_tpu_torch.parallel import elite

    boards = _random_boards(torch.Generator().manual_seed(5), 512, 0.35, "cuda")
    before = step_cuda.LAUNCHES["rollout"]
    final, pop = elite.sharded_rollout(boards, 37, nccl_mesh)
    assert step_cuda.LAUNCHES["rollout"] == before + 1
    want = step_cuda.rollout(boards, 37)
    assert final.is_cuda and torch.equal(final, want)
    assert int(pop) == int(B.population(want).sum())


def test_sharded_beam_complete_over_nccl(nccl_mesh):
    from lifeapi_tpu_torch.parallel import elite
    from lifeapi_tpu_torch.stable import complete as C

    eater = B.move(rle.parse("2b2o$bobo$bo$2o!", device="cpu"), 20, 20)
    hide = B.from_cells([(20, 20), (21, 20)], device="cpu")
    unknown = (B.zoi(eater) & ~eater) | hide
    bst = BP.make(state=(eater & ~hide).expand(64, 64).cuda(),
                  unknown=unknown.expand(64, 64).cuda())
    for two_phase in (False, True):
        found, best, pop, champ, champ_pop = elite.sharded_beam_complete(
            bst, nccl_mesh, frontier=4, iters=24, two_phase=two_phase)
        ref = C.complete_stable_beam(bst, frontier=4, iters=24, dense=False)
        assert torch.equal(found, ref.found) and torch.equal(best, ref.best)
        assert torch.equal(pop, ref.best_pop)
        assert int(champ_pop) == 7 and torch.equal(champ, ref.best[0])


# ---------------------------------------------------------------------------
# Soft-Life sweeps (csrc/soft_life.cu)
# ---------------------------------------------------------------------------

SOFT_TAU = 0.25


def _soft_inputs(device, cands, horizon=32, seed=0):
    """The SQP cell's shapes: p0 a board [64, 64], the controls the
    ``movedim`` view ``soft_objective`` hands over, sigmoid of
    ``init_logits``'s draw inside a 10 x 10 control window."""
    gen = torch.Generator().manual_seed(seed)
    p0 = (torch.rand((64, 64), generator=gen) < 0.3).float()
    logits = -3.0 + 0.5 * torch.randn((cands, horizon, 64, 64), generator=gen)
    mask = torch.zeros((64, 64))
    mask[36:46, 36:46] = 1.0
    controls = (torch.sigmoid(logits) * mask).movedim(-3, 0)
    return p0.to(device), controls.to(device)


def _candidate_errs(got, want):
    """Each candidate's relative error, ``|got - want| / |want|`` over its
    cells (candidates on dim 1), in float64."""
    got, want = got.double(), want.double()
    diff = (got - want).movedim(1, 0).flatten(1).norm(dim=1)
    return diff / want.movedim(1, 0).flatten(1).norm(dim=1)


def _soft_pair(name, args):
    before = soft_cuda.LAUNCHES[f"soft_{name}"]
    got = getattr(soft_cuda, name)(*args)
    torch.cuda.synchronize()
    assert soft_cuda.LAUNCHES[f"soft_{name}"] == before + 1
    return got, getattr(soft_cuda, f"{name}_plain")(*args)


@pytest.mark.parametrize("horizon", [1, 2, 3, 5, 32])
@pytest.mark.parametrize("cands", [1, 8, 64, 132, 192])
def test_soft_rollout_kernel_equals_twin_bit_for_bit(device, cands, horizon):
    """Clusters of two CTAs a candidate in under one wave of the SMs (1, 8,
    64 candidates) and in several (132, 192), rings that wrap at horizons
    1-3, 5 and 32, the controls through the movedim view: one launch, equal
    to the twin bit for bit."""
    p0, controls = _soft_inputs(device, cands, horizon)
    assert controls.stride(1) == horizon * 4096  # read in place through its strides
    got, want = _soft_pair("rollout", (p0, controls, SOFT_TAU))
    assert got.shape == want.shape and torch.equal(got, want)


# taus at which the double reciprocal aten scales by, rounded to float32,
# differs from the float32 reciprocal of the float32 tau (0.5268... and
# 0.2415... are steps of solve_gradient's annealing at 33 iterations)
ODD_TAUS = (0.55, 0.5268756481119898, 0.24157354979238813)


@pytest.mark.parametrize("tau", ODD_TAUS)
def test_soft_forward_sweeps_equal_twins_at_every_tau(device, tau):
    """The plain forward sweep and the objective's equal their twins bit for
    bit at taus whose two float32 reciprocals differ."""
    p0, controls = _soft_inputs(device, 8, 5)
    got, want = _soft_pair("rollout", (p0, controls, tau))
    assert torch.equal(got, want)
    ob = _objective_problem(device)
    logits = _objective_logits(device, 8, 5)
    _, traj = soft_cuda.objective(logits, ob, tau)
    assert torch.equal(traj, soft_cuda.objective_plain(logits, ob, tau)[1])


def _as_accurate(got, want32, want64):
    """The kernel within a relative 1e-4 of the float32 twin on every
    candidate, and no further from the float64 twin than twice the float32
    twin is (plus 1e-6): both sum a cell's terms in float32, in different
    orders, so neither is the exact answer."""
    errs = _candidate_errs(got, want32)
    own, twin = _candidate_errs(got, want64), _candidate_errs(want32, want64)
    assert errs.max() <= 1e-4, errs
    assert own.median() <= 2 * twin.median() + 1e-6 and own.max() <= 2 * twin.max() + 1e-6, \
        (own, twin)


def _as_accurate_or_zero(got, want32, want64):
    """``_as_accurate``, or all zero where the float64 twin is (``px`` at
    horizon 1: the last state feeds no generation)."""
    if not want64.any():
        assert not got.any()
    else:
        _as_accurate(got, want32, want64)


def _soft_adjoints(device, cands, horizon, want_p0, seed=0):
    """The VJP and HVP sweeps (each one launch) against their float32 and
    float64 twins on the card, at ``cands`` candidates and ``horizon``;
    with ``want_p0`` also the start board's cotangent and a ``w_p0``."""
    p0, controls = _soft_inputs(device, cands, horizon, seed)
    traj = soft_cuda.rollout(p0, controls, SOFT_TAU)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    g_traj = torch.randn(traj.shape, generator=gen, device=device) * 1e-2
    w = torch.randn(controls.shape, generator=gen, device=device) * (controls > 0)
    w_p0 = torch.randn(p0.shape, generator=gen, device=device) if want_p0 else None
    args = (p0, controls, traj, g_traj)
    got, want32 = _soft_pair("rollout_vjp", (*args, SOFT_TAU, want_p0))
    want64 = soft_cuda.rollout_vjp_plain(*(a.double() for a in args), SOFT_TAU, want_p0)
    lam32 = want32[2]
    for g, e32, e64 in zip(got, want32, want64):
        _as_accurate_or_none(g, e32, e64)
    args = (p0, controls, traj, lam32, w, w_p0)
    got, want32 = _soft_pair("rollout_hvp", (*args, SOFT_TAU, want_p0))
    want64 = soft_cuda.rollout_hvp_plain(*(None if a is None else a.double() for a in args),
                                         SOFT_TAU, want_p0)
    for g, e32, e64 in zip(got, want32, want64):
        _as_accurate_or_none(g, e32, e64)


def _as_accurate_or_none(got, want32, want64):
    """``_as_accurate_or_zero`` on generation-major outputs and on the start
    board's ``[C, 64, 64]``; None where the twin gives None."""
    if want64 is None:
        assert got is None
        return
    _as_accurate_or_zero(*(t if t.dim() == 4 else t[None] for t in (got, want32, want64)))


@pytest.mark.parametrize("want_p0", [False, True])
@pytest.mark.parametrize("horizon", [1, 2, 3, 32])
@pytest.mark.parametrize("cands", [1, 8, 64, 132, 192])
def test_soft_adjoint_sweeps_at_every_launch_shape(device, cands, horizon, want_p0):
    """Clusters of two CTAs a candidate in under one wave of the SMs (1, 8,
    64 candidates) and in several (132, 192), rings that wrap at horizons
    1-3 and 32, the start board's cotangents on and off, the controls
    through the movedim view."""
    _soft_adjoints(device, cands, horizon, want_p0)


@pytest.mark.parametrize("cands", [8, 64])
def test_soft_adjoint_sweeps_off_the_ring_stages(device, cands):
    """A horizon that is no multiple of the ring's stages, on other seeds."""
    _soft_adjoints(device, cands, 5, True, seed=2)


def test_soft_sweeps_never_spill(device):
    """ptxas gives the three sweeps their registers without spills, at most
    64 a thread of 1024; the runtime finds room for a CTA an SM and for the
    64 candidates' clusters of two in one wave."""
    import chip_smoke
    from lifeapi_tpu_torch.ops import _build

    report = chip_smoke.ptxas_report(_build.library_path().with_suffix(".log").read_text())
    sweeps = {name: (regs, spill) for name, regs, spill in report
              if name in ("soft_rollout_kernel", "soft_vjp_kernel", "soft_hvp_kernel")}
    assert sorted(sweeps) == ["soft_hvp_kernel", "soft_rollout_kernel", "soft_vjp_kernel"]
    assert all(regs <= 64 and spill == 0 for regs, spill in sweeps.values()), sweeps
    for name in ("rollout", "rollout_vjp", "rollout_hvp"):
        info = soft_cuda.sweep_info(name)
        assert info["threads"] == 1024 and info["ctas_per_sm"] >= 1, (name, info)
        assert info["clusters"] >= 64, (name, info)


def test_soft_third_derivative_raises_on_the_card(device):
    from lifeapi_tpu_torch.mpc import soft

    p0, controls = _soft_inputs(device, 2, horizon=3)
    u = controls.detach().clone().requires_grad_(True)
    _, traj = soft.soft_rollout(p0, u, 0.5)
    (g,) = torch.autograd.grad((traj ** 3).sum(), u, create_graph=True)
    (h,) = torch.autograd.grad((g * controls).sum(), u, create_graph=True)
    with pytest.raises(RuntimeError, match="differentiates twice at most"):
        torch.autograd.grad(h.sum(), u)


def test_soft_adjoint_kernels_match_twins(device):
    """The VJP and the HVP sweep at 64 candidates and horizon 32 against
    their twins on the card, in float32 and in float64."""
    p0, controls = _soft_inputs(device, 64)
    traj = soft_cuda.rollout(p0, controls, SOFT_TAU)
    gen = torch.Generator(device=device).manual_seed(1)
    g_traj = torch.randn(traj.shape, generator=gen, device=device) * 1e-2
    w = torch.randn(controls.shape, generator=gen, device=device) * (controls > 0)
    args = (p0, controls, traj, g_traj)
    (g_u, _, lam), (g_u32, _, lam32) = _soft_pair("rollout_vjp", (*args, SOFT_TAU, False))
    g_u64, _, lam64 = soft_cuda.rollout_vjp_plain(*(a.double() for a in args), SOFT_TAU, False)
    _as_accurate(g_u, g_u32, g_u64)
    _as_accurate(lam, lam32, lam64)
    args = (p0, controls, traj, lam32, w)
    got, want32 = _soft_pair("rollout_hvp", (*args, None, SOFT_TAU, False))
    want64 = soft_cuda.rollout_hvp_plain(*(a.double() for a in args), None, SOFT_TAU, False)
    for g, e32, e64 in zip(got[:3], want32[:3], want64[:3]):
        _as_accurate(g, e32, e64)


def test_soft_kernels_read_nothing_back_and_refuse_float64(device):
    p0, controls = _soft_inputs(device, 4, horizon=3)
    torch.cuda.set_sync_debug_mode("error")
    try:
        traj = soft_cuda.rollout(p0, controls, SOFT_TAU)
        _, _, lam = soft_cuda.rollout_vjp(p0, controls, traj, traj, SOFT_TAU, True)
        soft_cuda.rollout_hvp(p0, controls, traj, lam, torch.ones_like(traj), p0, SOFT_TAU, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with pytest.raises(TypeError):
        soft_cuda.rollout(p0.double(), controls.double(), SOFT_TAU)


def test_soft_kernels_take_unaligned_inputs(device):
    """Start boards, controls and cotangents 4 bytes off 16 are copied, not
    refused, by every sweep."""
    p0, controls = _soft_inputs(device, 5, horizon=4)
    store = torch.empty(controls.numel() + 1, device=device)
    odd = store[1:].view(controls.shape)
    odd.copy_(controls)
    got, want = _soft_pair("rollout", (p0, odd, SOFT_TAU))
    assert torch.equal(got, want)
    odd_p0 = torch.empty(p0.numel() + 1, device=device)[1:].view(p0.shape).copy_(p0)
    assert torch.equal(_soft_pair("rollout", (odd_p0, odd, SOFT_TAU))[0], want)
    g = torch.empty(got.numel() + 1, device=device)[1:].view(got.shape).copy_(got)
    (g_u, _, lam), (g_u_p, _, lam_p) = _soft_pair("rollout_vjp",
                                                  (p0, odd, got, g, SOFT_TAU, False))
    assert _candidate_errs(g_u, g_u_p).max() <= 1e-4
    w = torch.empty(got.numel() + 1, device=device)[1:].view(got.shape).copy_(g)
    hvp, hvp_p = _soft_pair("rollout_hvp", (p0, odd, got, lam_p, w, None, SOFT_TAU, False))
    for k in range(3):
        assert _candidate_errs(hvp[k], hvp_p[k]).max() <= 1e-4


# ---------------------------------------------------------------------------
# The MPC objective's sweeps and the solver's updates (csrc/soft_life.cu in
# objective mode, csrc/solver_update.cu)
# ---------------------------------------------------------------------------


def _objective_problem(device):
    """The SQP cell's problem (a block at (40, 40) to reach, a protected block
    at (10, 10)) with every cost term weighted, path too."""
    block = B.move(rle.parse("2o$2o!", device=device), 10, 10)
    goal = B.move(rle.parse("2o$2o!", device=device), 40, 40)
    mask = torch.zeros((64, 64), dtype=torch.bool, device=device)
    mask[36:46, 36:46] = True
    return soft_cuda.Objective(block, goal, B.zoi(goal) & ~goal, mask, B.to_dense(B.zoi(block)),
                               1.0, 0.01, 5.0, 0.5)


def _objective_logits(device, cands, horizon, seed=0):
    """init_logits' draw (-3 + 0.5 N(0, 1)) at the solver's horizon; a wider
    one (-1.5 + 1.5 N(0, 1)) at short horizons, where more cells toggle."""
    gen = torch.Generator().manual_seed(seed)
    spread = (-3.0, 0.5) if horizon >= 16 else (-1.5, 1.5)
    return (spread[0] + spread[1] * torch.randn((cands, horizon, 64, 64), generator=gen)).to(device)


def _by_candidate(t):
    """A ``[C, T, 64, 64]`` array with its candidates on dim 1, as
    ``_candidate_errs`` takes them."""
    return t.movedim(0, 1)


def _objective_pair(name, args):
    before = soft_cuda.LAUNCHES[f"soft_{name}"]
    got = getattr(soft_cuda, name)(*args)
    torch.cuda.synchronize()
    assert soft_cuda.LAUNCHES[f"soft_{name}"] == before + 1
    return got


def _as_accurate_by_candidate(got, want32, want64):
    _as_accurate(*(_by_candidate(t) for t in (got, want32, want64)))


@pytest.mark.parametrize("cands,horizon", [(1, 1), (8, 3), (64, 32), (192, 32), (132, 5)])
def test_objective_sweeps_match_twins(device, cands, horizon):
    """The objective's forward (trajectory bit for bit, each candidate's
    value within a relative 1e-4 of the float32 twin and no further from the
    float64 twin than twice it), its adjoint on a values' cotangent other
    than 1 (gradient and adjoints), and its HVP sweep and the adjoint on the
    HVP's state partials, each one launch, held as the plain sweeps are."""
    ob = _objective_problem(device)
    logits = _objective_logits(device, cands, horizon)
    tau = SOFT_TAU
    value, traj = _objective_pair("objective", (logits, ob, tau))
    value32, traj32 = soft_cuda.objective_plain(logits, ob, tau)
    value64, _ = soft_cuda.objective_plain(logits.double(), ob, tau)
    assert torch.equal(traj, traj32)
    errs = ((value - value32).abs() / value32.abs()).max()
    own = ((value.double() - value64).abs() / value64.abs())
    twin = ((value32.double() - value64).abs() / value64.abs())
    assert errs <= 1e-4 and own.max() <= 2 * twin.max() + 1e-6, (errs, own, twin)
    _, none = _objective_pair("objective", (logits, ob, tau, False))
    assert none is None

    gen = torch.Generator(device=device).manual_seed(cands)
    g_vals = torch.rand(cands, generator=gen, device=device) + 0.5
    args = (logits, traj, None, g_vals, None, ob, tau, True)
    grad, lam = _objective_pair("objective_vjp", args)
    want32 = soft_cuda.objective_vjp_plain(*args)
    want64 = soft_cuda.objective_vjp_plain(logits.double(), traj.double(), None,
                                           g_vals.double(), None, ob, tau, True)
    for got, w32, w64 in zip((grad, lam), want32, want64):
        _as_accurate_by_candidate(got, w32, w64)

    v = torch.randn(logits.shape, generator=gen, device=device)
    args = (logits, traj, want32[1], want32[0], v, ob, tau)
    pu, px = _objective_pair("objective_hvp", args)
    want32 = soft_cuda.objective_hvp_plain(*args)
    want64 = soft_cuda.objective_hvp_plain(*(t.double() for t in args[:5]), ob, tau)
    _as_accurate_by_candidate(pu, want32[0], want64[0])
    _as_accurate_or_zero(*(_by_candidate(t) for t in (px, want32[1], want64[1])))
    args = (logits, traj, want32[1], None, want32[0], ob, tau, False)
    hv, none = _objective_pair("objective_vjp", args)
    assert none is None
    hv32, _ = soft_cuda.objective_vjp_plain(*args)
    hv64, _ = soft_cuda.objective_vjp_plain(logits.double(), traj.double(),
                                            want32[1].double(), None, want32[0].double(), ob,
                                            tau, False)
    _as_accurate_by_candidate(hv, hv32, hv64)


def test_objective_sweeps_take_views_and_unaligned_logits(device):
    """Logits 4 bytes off 16 are copied, a candidate slice of a larger batch
    is read in place; both give the contiguous logits' results."""
    ob = _objective_problem(device)
    logits = _objective_logits(device, 6, 4, seed=1)
    value, traj = soft_cuda.objective(logits, ob, SOFT_TAU)
    odd = torch.empty(logits.numel() + 1, device=device)[1:].view(logits.shape).copy_(logits)
    wide = torch.cat([logits, logits]).view(2, 6, 4, 64, 64)[1]
    for other in (odd, wide):
        got, got_traj = soft_cuda.objective(other, ob, SOFT_TAU)
        assert torch.equal(got, value) and torch.equal(got_traj, traj)


def test_objective_launches_per_gradient_hvp_and_cg_iteration(device):
    """An adam iteration's gradient is at most 8 launches (the forward sweep,
    the sum, its cotangent's fill and the adjoint sweep: 4), an HVP at most 6
    (the HVP sweep and the adjoint: 2), a Newton step's matvec with its
    damping 3, a CG iteration's update 1 and an adam step 1."""
    from chip_smoke import launches_of as _launches_of
    from lifeapi_tpu_torch.mpc import solver
    from lifeapi_tpu_torch.ops import solver_cuda

    ob = _objective_problem(device)
    problem = solver.MPCProblem(ob.initial, solver.LifeTarget(ob.wanted, ob.unwanted), 32,
                                ob.mask, ob.protected)
    logits = solver.init_logits(torch.Generator().manual_seed(0), problem, 64)

    def objective(x):
        return solver.soft_objective(x, problem)

    n, ops = _launches_of(lambda: solver.value_and_grad(objective, logits))
    assert n <= 8, ops
    assert n == 4, ops
    vals, g, hvp = solver.grad_and_hvp(objective, logits)
    n, ops = _launches_of(lambda: hvp(g))
    assert n <= 6 and n == 2, ops
    n, ops = _launches_of(lambda: torch.add(hvp(g), g, alpha=0.5))
    assert n == 3, ops
    x, r, p = (torch.zeros_like(g), -g.clone(), -g.clone())
    gamma, stop = solver_cuda.batch_dot(r, r), torch.zeros(64, device=device)
    n, ops = _launches_of(lambda: solver_cuda.cg_update(x, r, p, hvp(p), gamma, stop))
    assert n == 3, ops
    state = solver.adam_init(logits)
    n, ops = _launches_of(lambda: solver.adam_update(logits, g, state, 0.15))
    assert n == 1, ops


def test_a_replaced_map_runs_the_objective_eagerly_on_the_card(device, monkeypatch):
    from lifeapi_tpu_torch.mpc import soft, solver

    ob = _objective_problem(device)
    problem = solver.MPCProblem(ob.initial, solver.LifeTarget(ob.wanted, ob.unwanted), 3,
                                ob.mask, ob.protected)
    logits = _objective_logits(device, 4, 3)
    fused = solver.soft_objective(logits, problem)
    monkeypatch.setattr(soft, "soft_step", lambda p, tau=0.2: soft_cuda.soft_step(p, tau))
    before = dict(soft_cuda.LAUNCHES)
    eager = solver.soft_objective(logits, problem)
    assert soft_cuda.LAUNCHES["soft_objective"] == before["soft_objective"]
    assert torch.equal(eager, solver.composed_objective(logits, problem))
    assert ((eager - fused).abs() / eager.abs()).max() <= 1e-5


def test_objective_sweeps_never_spill(device):
    import chip_smoke
    from lifeapi_tpu_torch.ops import _build

    report = chip_smoke.ptxas_report(_build.library_path().with_suffix(".log").read_text())
    names = ("soft_objective_kernel", "soft_objective_vjp_kernel", "soft_objective_hvp_kernel")
    sweeps = {name: (regs, spill) for name, regs, spill in report if name in names}
    assert sorted(sweeps) == sorted(names)
    assert all(regs <= 64 and spill == 0 for regs, spill in sweeps.values()), sweeps
    for name in ("objective", "objective_vjp", "objective_hvp"):
        info = soft_cuda.sweep_info(name)
        assert info["threads"] == 1024 and info["ctas_per_sm"] >= 1, (name, info)
        assert info["clusters"] >= 64, (name, info)


def _cg_state(gen, shape, device, offset=0):
    """x, r, p and an A p near 2 p, seeded, each ``offset`` floats into an
    allocation of its own (so 4 bytes off 16 where ``offset`` is 1)."""
    n = int(np.prod(shape))
    x, r, p, noise = (torch.empty(n + offset, device=device)[offset:].view(shape)
                      .copy_(torch.randn(shape, generator=gen, device=device)) for _ in range(4))
    return x, r, p, p * 2 + 0.1 * noise


def _assert_cg_as_accurate(got, w32, w64):
    """Within a relative 1e-5 of the float32 twin, and no further from the
    float64 twin than twice the float32 twin (plus 1e-6 of its norm)."""
    err = float((got - w32).norm() / w32.norm())
    own, mine = float((got.double() - w64).norm()), float((w32.double() - w64).norm())
    assert err <= 1e-5 and own <= 2 * mine + 1e-6 * float(w64.norm()), (err, own, mine)


@pytest.mark.parametrize("shape,frozen,offset", [
    ((5, 3, 64, 64), (0,), 0), ((8, 32, 64, 64), (0,), 0), ((64, 32, 64, 64), (0,), 0),
    ((64, 32, 64, 64), (37, 63), 0), ((3, 5, 7), (1,), 0), ((5, 3, 7), (4,), 1),
    ((8, 64, 64, 64), (3,), 0), ((6, 200, 64, 64), (2,), 0)])
def test_cg_update_kernel_matches_twin(device, shape, frozen, offset):
    """One launch updates every active system in place as the twin does, up
    to the dot products' order (a relative 1e-5 of each array, and no
    further from the float64 twin than twice the float32 twin plus 1e-6);
    a frozen system keeps its state bit for bit; ``ap`` may be ``p``.  The
    shapes: [sqp]'s at 8 and 64 systems, systems of 35 elements (not a
    multiple of the kernel's 16-byte pieces, so most start off 16 bytes),
    state 4 bytes off 16 (updated in a copy), and shares longer than a
    CTA's tiles (horizon 64 and 200)."""
    from lifeapi_tpu_torch.ops import solver_cuda

    gen = torch.Generator(device=device).manual_seed(shape[0] + offset)
    x, r, p, ap = _cg_state(gen, shape, device, offset)
    gamma = solver_cuda.batch_dot(r, r)
    stop = torch.zeros_like(gamma)
    for k in frozen:
        stop[k] = gamma[k] * 2
    active = [k for k in range(shape[0]) if k not in frozen]
    for alias in (False, True):
        a = p if alias else ap
        state = [t.clone() for t in (x, r, p, gamma)]
        if offset:
            state[:3] = [torch.empty(t.numel() + offset, device=device)[offset:].view(t.shape)
                         .copy_(t) for t in state[:3]]
        twin = [t.clone() for t in (x, r, p, gamma)]
        twin64 = [t.double() for t in (x, r, p, gamma)]
        before = solver_cuda.LAUNCHES["cg_update"]
        solver_cuda.cg_update(*state[:3], a.clone() if not alias else state[2], state[3], stop)
        torch.cuda.synchronize()
        assert solver_cuda.LAUNCHES["cg_update"] == before + 1
        solver_cuda.cg_update_plain(*twin[:3], twin[2] if alias else a, twin[3], stop)
        solver_cuda.cg_update_plain(*twin64[:3], twin64[2] if alias else a.double(), twin64[3],
                                    stop.double())
        for got, w32, w64 in zip(state, twin, twin64):
            for k in frozen:
                assert torch.equal(got[k], w32[k])
            _assert_cg_as_accurate(got[active], w32[active], w64[active])


@pytest.mark.parametrize("shape", [(64, 32, 64, 64), (6, 200, 64, 64), (3, 5, 7)])
def test_cg_update_kernel_gives_the_same_bits_twice(device, shape):
    """Two launches on the same inputs give equal bits: the dot products are
    reduced in a fixed order."""
    from lifeapi_tpu_torch.ops import solver_cuda

    gen = torch.Generator(device=device).manual_seed(11)
    x, r, p, ap = _cg_state(gen, shape, device)
    gamma = solver_cuda.batch_dot(r, r)
    stop = torch.zeros_like(gamma)
    runs = []
    for _ in range(2):
        state = [t.clone() for t in (x, r, p, gamma)]
        solver_cuda.cg_update(*state[:3], ap, state[3], stop)
        runs.append(state)
    torch.cuda.synchronize()
    for one, two in zip(*runs):
        assert torch.equal(one, two)


def test_conjugate_gradients_on_the_card_matches_the_twin_loop(device):
    """12 iterations of ``conjugate_gradients`` on a diagonal positive-definite
    operator at [sqp]'s 64 x 32, one launch an iteration, within the update's
    tolerance of the same loop over the twin, and no further from the loop
    in float64 than twice that loop in float32."""
    from lifeapi_tpu_torch.mpc import solver
    from lifeapi_tpu_torch.ops import solver_cuda

    gen = torch.Generator(device=device).manual_seed(5)
    shape = (64, 32, 64, 64)
    diag = 1 + 9 * torch.rand(shape, generator=gen, device=device)
    b = torch.randn(shape, generator=gen, device=device)

    def twin_loop(diag, b):
        stop = solver.CG_TOL ** 2 * solver_cuda.batch_dot(b, b)
        x, r, p = torch.zeros_like(b), b.clone(), b.clone()
        gamma = solver_cuda.batch_dot(r, r)
        for _ in range(12):
            solver_cuda.cg_update_plain(x, r, p, diag * p, gamma, stop)
        return x

    before = solver_cuda.LAUNCHES["cg_update"]
    got = solver.conjugate_gradients(lambda v: diag * v, b, 12)
    torch.cuda.synchronize()
    assert solver_cuda.LAUNCHES["cg_update"] == before + 12
    _assert_cg_as_accurate(got, twin_loop(diag, b), twin_loop(diag.double(), b.double()))


def test_cg_update_kernel_launch_shape_and_no_spills(device):
    """At [sqp]'s 64 x 32 a CTA's share of p and A p fills its tiles (128 KB
    of shared memory, one CTA of 512 threads an SM), and the card holds at
    least 15 clusters of 8 at once (120 SMs; an H100 holds 15, so 64
    systems are four waves of 15 and one of 4).  The kernel does not spill."""
    import chip_smoke
    from lifeapi_tpu_torch.ops import _build, solver_cuda

    report = chip_smoke.ptxas_report(_build.library_path().with_suffix(".log").read_text())
    regs, spill = next((regs, spill) for name, regs, spill in report
                       if name == "cg_update_kernel")
    assert regs <= 128 and spill == 0, (regs, spill)
    info = solver_cuda.cg_update_info(32 * 4096)
    assert info["threads"] == 512 and info["ctas"] == 8 and info["tile"] == 4096, info
    assert info["shared"] == 128 + 2 * 4096 * 16 and info["ctas_per_sm"] == 1, info
    assert info["clusters"] >= 15, info
    assert solver_cuda.cg_update_info(32 * 4096, ap_is_p=True)["shared"] == 128 + 4096 * 16


@pytest.mark.parametrize("lr,shape,offset", [(0.15, (64, 32, 64, 64), 0), (0.3, (64, 32, 64, 64), 0),
                                             (0.15, (3, 5, 7), 0), (0.15, (2, 3, 64, 64), 1)])
def test_adam_kernel_equals_twin_bit_for_bit(device, lr, shape, offset):
    """[sqp]'s shape at two rates, 105 elements (a tail past the 16-byte
    pieces), and logits 4 bytes off 16 (copied): five steps, each one launch
    equal to the twin bit for bit."""
    from lifeapi_tpu_torch.ops import solver_cuda
    from lifeapi_tpu_torch.mpc import solver

    gen = torch.Generator(device=device).manual_seed(7)
    n = int(np.prod(shape))
    logits = torch.empty(n + offset, device=device)[offset:].view(shape)
    logits.copy_(-3 + 0.5 * torch.randn(shape, generator=gen, device=device))
    mu, nu = torch.zeros_like(logits), torch.zeros_like(logits)
    twin = (logits, mu, nu)
    for count in range(1, 6):
        grads = 1e-2 * torch.randn(shape, generator=gen, device=device)
        args = (grads, count, lr, solver.ADAM_B1, solver.ADAM_B2, solver.ADAM_EPS)
        before = solver_cuda.LAUNCHES["adam_update"]
        logits, mu, nu = solver_cuda.adam_update(logits, args[0], mu, nu, *args[1:])
        assert solver_cuda.LAUNCHES["adam_update"] == before + 1
        twin = solver_cuda.adam_update_plain(twin[0], args[0], twin[1], twin[2], *args[1:])
        for got, want in zip((logits, mu, nu), twin):
            assert torch.equal(got, want)


def test_solver_kernels_read_nothing_back_and_refuse_float64(device):
    from lifeapi_tpu_torch.ops import solver_cuda

    ob = _objective_problem(device)
    logits = _objective_logits(device, 4, 3)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, traj = soft_cuda.objective(logits, ob, SOFT_TAU)
        grad, lam = soft_cuda.objective_vjp(logits, traj, None, torch.ones(4, device=device),
                                            None, ob, SOFT_TAU, True)
        soft_cuda.objective_hvp(logits, traj, lam, grad, grad, ob, SOFT_TAU)
        x, r, p = (grad.clone() for _ in range(3))
        gamma = solver_cuda.batch_dot(r, r)
        solver_cuda.cg_update(x, r, p, grad, gamma, torch.zeros_like(gamma))
        solver_cuda.adam_update(logits, grad, grad, grad * grad, 1, 0.1, 0.9, 0.999, 1e-8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with pytest.raises(TypeError):
        soft_cuda.objective(logits.double(), ob, SOFT_TAU)
    with pytest.raises(TypeError):
        solver_cuda.adam_update(logits.double(), grad.double(), grad.double(), grad.double(),
                                1, 0.1, 0.9, 0.999, 1e-8)
