"""The port's kernel build: what keys a build, and how chip_smoke.py reads
the compiler's register report, the SASS listing and the profiler's
traces.  No compiler or card is needed."""

import ctypes
import re
import shutil
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from lifeapi_tpu_torch.ops import _build, step_cuda

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__f662ddb2_14_life_stable_cu_e29dcd4a11beam_kernelILi256EEEvPKyS2_PKiPyPiPhS7_S7_ibi' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__f662ddb2_14_life_stable_cu_e29dcd4a11beam_kernelILi256EEEvPKyS2_PKiPyPiPhS7_S7_ibi
    120 bytes stack frame, 172 bytes spill stores, 168 bytes spill loads
ptxas info    : Used 173 registers, used 1 barriers, 320 bytes smem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__fb87a2f3_15_life_rollout_cu_d2d3041c14rollout_kernelEPKyPyii' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__fb87a2f3_15_life_rollout_cu_d2d3041c14rollout_kernelEPKyPyii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_build_key_covers_sources_and_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert _build.library_file(csrc) == _build.library_file()
    for name in ("warp_board.cuh", "life_stable.cu"):
        before = _build.library_file(csrc)
        path = csrc / name
        path.write_text(path.read_text() + "\n// edited\n")
        assert _build.library_file(csrc) != before, name


def _launchers():
    """{name: (return type, [parameter types])} of every ``extern "C"``
    launcher in the kernels' sources."""
    found = {}
    for source in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in re.findall(r'extern "C" (\w+) (\w+)\(([^)]*)\)',
                                            source.read_text()):
            assert name not in found, name
            found[name] = (ret, [" ".join(p.split()[:-1]) for p in params.split(",")])
    return found


def _ctype(c_type):
    if "*" in c_type or c_type == "cudaStream_t":
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}[c_type]


def test_every_launcher_has_a_signature():
    assert sorted(_launchers()) == sorted(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_launcher_signature_matches_its_declaration(name):
    """The ctypes argument types the library is loaded with are those of
    the launcher's C declaration, one for one."""
    ret, params = _launchers()[name]
    assert ret == "cudaError_t"
    assert [_ctype(t) for t in params] == list(_build.SIGNATURES[name])


def test_ptxas_report_names_each_kernel():
    assert chip_smoke.ptxas_report(PTXAS_LOG) == [
        ("beam_kernel<256>", 173, 172), ("rollout_kernel", 32, 0)]


NTT = "_ZN45_GLOBAL__N__afda5bfd_12_life_conv_cu_3420d7983ntt15ntt_conv_kernelILi{}ELi{}EEEvPKhS3_PK13__nv_bfloat16Pviiii"


@pytest.mark.parametrize("args", [(2, 0), (1, 1), (1, 2), (1, 3)])
def test_kernel_label_keeps_every_template_argument(args):
    assert chip_smoke.kernel_label(NTT.format(*args)) == f"ntt_conv_kernel<{args[0]}, {args[1]}>"
    assert chip_smoke.kernel_label(ROLLOUT) == "rollout_kernel"


def test_kernel_label_is_not_fooled_by_the_path_hash():
    """The anonymous namespace's name hashes the source's path; here its
    digits 52 would, read as a length, span exactly to ``..._kernel``."""
    mangled = "_ZN48_GLOBAL__N__1ab52fd4_15_life_rollout_cu_d2d3041c19rollout_lohi_kernelEPKjS1_PjS2_ii"
    assert chip_smoke.kernel_label(mangled) == "rollout_lohi_kernel"
    assert chip_smoke.kernel_label("_Z14rollout_kernelPKyPyii") == "rollout_kernel"
    assert chip_smoke.kernel_label("_ZN3foo3barEv") == "_ZN3foo3barEv"


def _sass(name, body):
    """A ``cuobjdump -sass`` listing of one function from (opcode, operands)."""
    lines = [f"\t\tFunction : {name}",
             '\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_SM90"']
    for i, (op, args) in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {op} {args} ;"
                     f"                 /* 0x000000000000094d */")
        lines.append("                                                 /* 0x000fe40000000800 */")
    return "\n".join(lines) + "\n"


ROLLOUT = "_ZN48_GLOBAL__N__fb87a2f3_15_life_rollout_cu_d2d3041c14rollout_kernelEPKyPyii"


def test_sass_loop_counts_instructions_per_generation():
    shfl, lop = ("SHFL.IDX", "PT, R10, R23, R6, 0x1f"), ("LOP3.LUT", "R4, R2, R3, R5, 0x96, !PT")
    # prologue; a loop of two generations (32 shuffles, 40 more ops, the
    # branch: 73 instructions from 0x30); a one-generation remainder loop
    main = [("@P0 EXIT", ""), ("SEL", "R1, R2, R3, !P1"), ("VIADD", "R6, R7, 0x1")]
    main += [shfl, lop] * 32 + [lop] * 8 + [("@P1 BRA", "0x30")]
    rest_at = 16 * len(main)
    main += [shfl] * 16 + [lop] * 4 + [("@!P2 BRA", f"{rest_at:#x}"), ("EXIT", ""),
                                       ("BRA", f"{16 * (len(main) + 22):#x}")]
    funcs = chip_smoke.sass_functions(_sass(ROLLOUT, main))
    assert list(funcs) == ["rollout_kernel"] and len(funcs["rollout_kernel"]) == len(main)
    assert funcs["rollout_kernel"][3] == (0x30, "SHFL.IDX", "PT, R10, R23, R6, 0x1f")
    assert chip_smoke.instructions_per_generation(funcs["rollout_kernel"]) == 73 / 2


CONTROLLED = "_ZN48_GLOBAL__N__fb87a2f3_15_life_rollout_cu_d2d3041c17controlled_kernelEPKyS1_Pyii"


def test_sass_unrolled_loop_inside_a_chunk_loop_counts_per_generation():
    """The controlled kernel's shape: a loop over chunks of the toggle
    stream around a copy loop, a generation loop unrolled 4 times (8
    shuffles a generation) and its one-generation remainder.  The chunk
    loop holds the most shuffles (40) but is not the generation loop; the
    unrolled body's 85 instructions are 4 generations."""
    code = [("MOV", "R1, c[0x0][0x28]")]
    chunk = len(code)
    code += [("IMAD", "R2, R3, R4, R5")]
    copy = len(code)
    code += [("LDGSTS.E.BYPASS.128", "[R6], desc[UR4][R8.64]"), ("IADD3", "R7, R7, 0x1, RZ"),
             ("@P0 BRA", f"{16 * copy:#x}"), ("LDGDEPBAR", ""), ("DEPBAR.LE", "SB0, 0x1")]
    body = len(code)
    code += [SHFL, LOP] * 32 + [LOP] * 20 + [("@P1 BRA", f"{16 * body:#x}")]
    rest = len(code)
    code += [SHFL] * 8 + [LOP] * 6 + [("@P2 BRA", f"{16 * rest:#x}")]
    code += [("IADD3", "R9, R9, 0x8, RZ"), ("@P3 BRA", f"{16 * chunk:#x}"), ("EXIT", "")]
    funcs = chip_smoke.sass_functions(_sass(CONTROLLED, code))
    assert max(chip_smoke.loops(funcs["controlled_kernel"]))[0] == 40
    assert chip_smoke.instructions_per_generation(funcs["controlled_kernel"], 8) == 85 / 4


@pytest.mark.parametrize("shuffles", [0, 12])
def test_sass_loop_without_whole_generations_is_refused(shuffles):
    body = [("SHFL.IDX", "PT, R1, R2, R3, 0x1f")] * shuffles + [("@P0 BRA", "0x0")]
    code = chip_smoke.sass_functions(_sass(ROLLOUT, body))["rollout_kernel"]
    with pytest.raises(AssertionError, match="no generation loop"):
        chip_smoke.instructions_per_generation(code)


def _pair_loop(sel):
    """A rollout of the pair layout: a prologue with a select, then a loop
    of two generations (16 shuffles; 80 LOP3, 16 funnel shifts, ``sel``
    selects, 3 more and the branch) and a one-generation remainder."""
    shfl, lop = ("SHFL.IDX", "PT, R10, R23, R6, 0x1f"), ("LOP3.LUT", "R4, R2, R3, R5, 0x96, !PT")
    shf = ("SHF.L.W.U32.HI", "R8, R9, 0x1, R8")
    code = [("SEL", "R1, R2, R3, !P1"), ("IMAD.SHL.U32", "R6, R7, 0x2, RZ")]
    loop = len(code)
    code += [shfl] * 16 + [lop] * 80 + [shf] * 16 + [("SEL", "R1, R2, R3, P1")] * sel
    code += [("IADD3", "R5, R5, 0x2, RZ"), ("ISETP.GE.AND", "P1, PT, R5, R4, PT"),
             ("MOV", "R2, R3"), ("@!P1 BRA", f"{16 * loop:#x}")]
    rest = len(code)
    code += [shfl] * 8 + [lop] * 40 + [("@P2 BRA", f"{16 * rest:#x}"), ("EXIT", "")]
    return code


def test_sass_generation_loop_mix_counts_each_kind():
    code = chip_smoke.sass_functions(_sass(ROLLOUT, _pair_loop(sel=0)))["rollout_kernel"]
    mix = chip_smoke.generation_loop_mix(code, 8)
    assert mix == {"LOP3": 40, "SHF": 8, "SHFL": 8, "SEL": 0, "other": 2}
    assert sum(mix.values()) == chip_smoke.instructions_per_generation(code, 8) == 116 / 2
    # the same loop read as the split layout's (16 shuffles a generation)
    assert chip_smoke.generation_loop_mix(code)["SHFL"] == 16


@pytest.mark.parametrize("sel", [0, 2])
def test_pair_layout_loop_with_selects_is_refused(sel):
    """Each rollout kernel's mix, read from its own listing; a select in the
    generation loop of a kernel of the pair layout fails the run."""
    listing = "".join(_sass(f"_Z{len(fn)}{fn}PKyPyii", _pair_loop(sel if fn == "rollout_kernel"
                                                                  else 0))
                      for fn, _ in chip_smoke.ROLLOUT_KERNELS.values())
    funcs = chip_smoke.sass_functions(listing)
    if sel:
        with pytest.raises(AssertionError, match="rollout_kernel: 1 SEL a generation"):
            chip_smoke.rollout_loop_mixes(funcs)
    else:
        mixes = chip_smoke.rollout_loop_mixes(funcs)
        assert mixes["rollout"]["SHFL"] == mixes["rollout_lohi"]["SHFL"] == 8
        assert mixes["catalyst_rollout"]["SHFL"] == mixes["controlled_rollout"]["SHFL"] == 8


def test_rollout_kernels_table_follows_the_source():
    """ROLLOUT_KERNELS gives a kernel 8 shuffles a generation where its body
    steps with life_step_pair (lane l on columns 2l and 2l + 1) and 16 where
    it steps with life_step (columns l and l + 32), so the SASS bound's
    generations cannot drift from the source."""
    found = chip_smoke.rollout_step_shuffles((_build.CSRC / "life_rollout.cu").read_text())
    assert found == {fn: shuffles for fn, shuffles in chip_smoke.ROLLOUT_KERNELS.values()}
    assert found["rollout_kernel"] == found["rollout_lohi_kernel"] == 8
    assert found["catalyst_kernel"] == found["controlled_kernel"] == 8


def test_rollout_source_has_one_step_circuit():
    """Every rollout kernel steps with the one pair-layout circuit: no body
    in life_rollout.cu calls the split layout's life_step, nvcc's C form of
    Rokicki's terms (rokicki) or the split column helpers, and the pair step
    takes no circuit argument."""
    source = (_build.CSRC / "life_rollout.cu").read_text()
    code = re.sub(r"//[^\n]*", "", source)
    assert re.search(r"\blife_step\s*\(", code) is None
    assert re.search(r"\brokicki\s*\(", code) is None
    assert re.search(r"\b(from_left|from_right|kLop3)\b", code) is None
    assert re.search(r"\blife_step_pair\s*<", code) is None
    assert len(re.findall(r"\brokicki_lop3\s*\(", code)) == 3  # defined, then even and odd


def test_rollout_step_shuffles_reads_each_body():
    source = """
__global__ void __launch_bounds__(256, 8)
a_kernel(int T) {
  for (int t = 0; t < T; ++t) life_step_pair<true>(even, odd, lane);
}

__global__ void b_kernel(int T) {
  if (T) { life_step(lo, hi, lane); }
}

__global__ void c_kernel(int T) {
  life_step(lo, hi, lane);
  life_step_pair(even, odd, lane);
}
"""
    assert chip_smoke.rollout_step_shuffles(source) == {"a_kernel": 8, "b_kernel": 16}


NTT_ARGS = ((2, 0), (1, 1), (1, 2), (1, 3))


def _ntt_listing(hmma):
    body = [("LDSM.16.M88.4", "R4, [R2]"), ("HMMA.16816.F32.BF16", "R8, R4, R12, R8")] * hmma
    body += [("FRND.FLOOR", "R1, R2"), ("EXIT", "")]
    return "".join(_sass(NTT.format(*args), body) for args in NTT_ARGS)


def test_ntt_sass_counts_tensor_core_instructions():
    counts = chip_smoke.ntt_sass_counts(chip_smoke.sass_functions(_ntt_listing(3)))
    assert counts == {f"ntt_conv_kernel<{p}, {o}>": (3, 3, 1, 8) for p, o in NTT_ARGS}


def test_ntt_sass_without_hmma_is_refused():
    with pytest.raises(AssertionError, match="lacks HMMA"):
        chip_smoke.ntt_sass_counts(chip_smoke.sass_functions(_ntt_listing(0)))


STABLE = "_ZN47_GLOBAL__N__f662ddb2_14_life_stable_cu_e29dcd4a{}EvPKyPyPhS3_S1_ii"
SOLVER_NAMES = {"fixpoint_kernel<0>": "15fixpoint_kernelILb0EE",
                "fixpoint_kernel<1>": "15fixpoint_kernelILb1EE",
                "beam_kernel<4>": "11beam_kernelILi4EE"}
SHFL = ("SHFL.IDX", "PT, R10, R23, R6, 0x1f")
LOP = ("LOP3.LUT", "R4, R2, R3, R5, 0x96, !PT")


def _solver_body(step_unroll=1, priority=True):
    """A beam-shaped function: a round loop around a fixpoint loop (48
    shuffles a step, two votes and the branch: 99 instructions a step),
    then, behind a branch, the priority block (56 shuffles, 168
    instructions and the branch that ends it) and 40 more shuffles, so the
    round loop holds 3 x 48 and must not be taken for the fixpoint."""
    code = [("MOV", "R1, c[0x0][0x28]")]
    rnd = len(code)
    code += [("BSSY", "B0, {join}"), LOP]
    step = len(code)
    code += ([SHFL, LOP] * 48 + [("VOTE.ANY", "R5, PT, P1"), ("VOTE.ANY", "R6, PT, P2")]) \
        * step_unroll + [("@P0 BRA", f"{16 * step:#x}")]
    code += [("REDUX.SUM", "UR4, R7"), ("@!P1 BRA", "{skip}")]
    code += [SHFL, LOP, LOP] * (56 if priority else 55) + [("@!P2 BRA", "{skip}")]
    skip = len(code)
    code += [SHFL] * 40 + [("BSYNC", "B0")]
    join = len(code)
    code += [LOP, ("@P3 BRA", f"{16 * rnd:#x}"), ("EXIT", "")]
    return [(op, args.format(join=f"{16 * join:#x}", skip=f"{16 * skip:#x}"))
            for op, args in code]


def _solver_listing(**kw):
    return "".join(_sass(STABLE.format(mangled), _solver_body(**kw))
                   for mangled in SOLVER_NAMES.values())


def test_solver_sass_counts_step_and_priority():
    funcs = chip_smoke.sass_functions(_solver_listing())
    assert sorted(funcs) == sorted(SOLVER_NAMES)
    code = funcs["beam_kernel<4>"]
    assert chip_smoke.loop_instructions(code, chip_smoke.STEP_SHUFFLES) == 99
    assert chip_smoke.block_instructions(code, chip_smoke.PRIORITY_SHUFFLES) == 169
    blocks = chip_smoke.basic_blocks(code)
    assert sum(map(len, blocks)) == len(code)
    assert [len(b) for b in blocks][:2] == [1, 2]  # the round loop's head starts a block
    assert chip_smoke.solver_sass_counts(funcs) == {
        "propagate_fixpoint": (99, None), "propagate_fixpoint_priorities": (99, 169),
        "beam_search": (99, 169)}


CONV = "_ZN45_GLOBAL__N__afda5bfd_12_life_conv_cu_3420d798{}"
PEEL_NAMES = {"conv_sparse_kernel": "18conv_sparse_kernelEPKyS1_Pyi",
              "counts_sparse_kernel": "20counts_sparse_kernelEPKyS1_Pyii",
              "union_sparse_kernel": "19union_sparse_kernelENS_7PairSetEiPyi"}
FUNNEL = ("SHF.L.W.U32.HI", "R4, R5, R6, R7")
LDS = ("LDS.64", "R8, [R9+0x100]")


def _peel_body(round_loop=True):
    """A union-shaped function: a pair loop around a chunk loop, which holds
    the listing loop (no funnel shift), the round loop unrolled 4 times (16
    funnel shifts; 37 instructions with its branch) and its one-round
    remainder (4 funnel shifts, 11 instructions).  The chunk and pair loops
    hold 20 funnel shifts and must not be taken for the round loop."""
    code = [("MOV", "R1, c[0x0][0x28]")]
    pair = len(code)
    code += [("REDUX.SUM", "UR4, R7"), LOP]
    chunk = len(code)
    code += [("WARPSYNC.ALL", "")]
    listing = len(code)
    code += [("FLO.U32", "R2, R3"), ("STS.64", "[R4], R6"), ("@P0 BRA", f"{16 * listing:#x}")]
    if round_loop:
        body = len(code)
        code += [LDS, LDS, FUNNEL, FUNNEL, FUNNEL, FUNNEL, LOP, ("IADD3", "R9, R9, 0x8, RZ")] * 4
        code += [LOP] * 4 + [("@P1 BRA", f"{16 * body:#x}")]
        rest = len(code)
        code += [LDS, LDS] + [FUNNEL] * 4 + [LOP, LOP, ("IADD3", "R9, R9, 0x8, RZ"),
                                              ("ISETP.GE.AND", "P2, PT, R9, R10, PT"),
                                              ("@P2 BRA", f"{16 * rest:#x}")]
    code += [("@P3 BRA", f"{16 * chunk:#x}"), ("@P4 BRA", f"{16 * pair:#x}"), ("EXIT", "")]
    return code


def test_peel_sass_counts_a_round_of_the_unrolled_loop():
    listing = "".join(_sass(CONV.format(m), _peel_body()) for m in PEEL_NAMES.values())
    funcs = chip_smoke.sass_functions(listing)
    assert sorted(funcs) == sorted(PEEL_NAMES)
    assert chip_smoke.round_instructions(funcs["union_sparse_kernel"]) == 37 / 4
    assert chip_smoke.peel_sass_counts(funcs) == dict.fromkeys(chip_smoke.PEEL_KERNELS, 37 / 4)


def test_peel_sass_without_a_round_loop_is_refused():
    code = chip_smoke.sass_functions(_sass(CONV.format(PEEL_NAMES["conv_sparse_kernel"]),
                                           _peel_body(round_loop=False)))
    with pytest.raises(AssertionError, match="no peel round loop"):
        chip_smoke.round_instructions(code["conv_sparse_kernel"])


def test_kernel_a_step_is_the_block_of_its_shuffles():
    """Kernel A's shape: an exit for warps past the batch, then one
    straight-line block holding the step's 48 shuffles."""
    code = [("S2R", "R0, SR_TID.X"), ("@P0 EXIT", "")] + [SHFL, LOP, LOP] * 48 + [("EXIT", "")]
    name = "_ZN47_GLOBAL__N__f662ddb2_14_life_stable_cu_e29dcd4a11step_kernelEPKyPyS2_S2_i"
    funcs = chip_smoke.sass_functions(_sass(name, code))
    assert chip_smoke.block_instructions(funcs["step_kernel"], chip_smoke.STEP_SHUFFLES) == 145


def test_solver_sass_unrolled_step_counts_per_pass():
    code = chip_smoke.sass_functions(_solver_listing(step_unroll=2))["beam_kernel<4>"]
    assert chip_smoke.loop_instructions(code, chip_smoke.STEP_SHUFFLES) == 197 / 2


def test_solver_sass_without_its_shapes_is_refused():
    code = chip_smoke.sass_functions(_solver_listing(priority=False))["beam_kernel<4>"]
    with pytest.raises(AssertionError, match="no basic block of 56 shuffles"):
        chip_smoke.block_instructions(code, chip_smoke.PRIORITY_SHUFFLES)
    with pytest.raises(AssertionError, match="no loop of 48 shuffles"):
        chip_smoke.loop_instructions(code[:2], chip_smoke.STEP_SHUFFLES)


def _persistent_fixpoint_body(priorities, step_unroll=1):
    """Kernel B or C as persistent warps would compile (a shape measured on
    the card and not kept): a board loop (wait for the staged board, read it
    from shared memory, stage the next by 10 LDGSTS) around the step loop (48
    shuffles, two votes, the branch over 20 rollback stores: 120
    instructions a step); a reload behind a branch; the result's stores; for
    C the priority block (56 shuffles, 168 instructions) and the level
    stores, in one basic block with the stores before it and the branch
    that ends the board loop (197 instructions).  B's board loop holds
    exactly 48 shuffles, C's 104: neither may be taken for the step loop."""
    lds, sts, stg = ("LDS.64", "R4, [R2]"), ("STS.64", "[R2], R4"), ("STG.E.64", "desc[UR4][R6.64], R4")
    code = [("MOV", "R1, c[0x0][0x28]"), ("LDGSTS.E.BYPASS.128", "[R3], desc[UR4][R6.64]")]
    board = len(code)
    code += [("LDGDEPBAR", ""), ("DEPBAR.LE", "SB0, 0x0"), ("WARPSYNC", "0xffffffff")]
    code += [lds] * 20 + [("LDGSTS.E.BYPASS.128", "[R3], desc[UR4][R6.64]")] * 10
    step = len(code)
    for _ in range(step_unroll):
        code += [SHFL, LOP] * 48 + [("VOTE.ANY", "R5, PT, P1"), ("VOTE.ANY", "R6, PT, P2"),
                                    ("@!P1 BRA", "{nostore%d}" % _)]
        code += [sts] * 20
        code = [(op, args.replace("{nostore%d}" % _, f"{16 * len(code):#x}"))
                for op, args in code]
    code += [("@P0 BRA", f"{16 * step:#x}"), ("@!P2 BRA", "{stores}")] + [lds] * 20
    stores = len(code)
    code += [stg] * 20
    if priorities:
        code += [SHFL, LOP, LOP] * 56 + [stg] * 8
    code += [("@P3 BRA", f"{16 * board:#x}"), ("EXIT", "")]
    return [(op, args.replace("{stores}", f"{16 * stores:#x}")) for op, args in code]


def _persistent_listing(step_unroll=1):
    bodies = {"fixpoint_kernel<0>": _persistent_fixpoint_body(False, step_unroll),
              "fixpoint_kernel<1>": _persistent_fixpoint_body(True, step_unroll),
              "beam_kernel<4>": _solver_body()}
    return "".join(_sass(STABLE.format(SOLVER_NAMES[name]), body)
                   for name, body in bodies.items())


def test_solver_sass_counts_skip_a_board_loop_around_the_step_loop():
    funcs = chip_smoke.sass_functions(_persistent_listing())
    assert sorted(funcs) == sorted(SOLVER_NAMES)
    b_loops = [(n, size) for n, size, _, _ in chip_smoke.loops(funcs["fixpoint_kernel<0>"])]
    assert (48, 120) in b_loops and any(n == 48 and size > 120 for n, size in b_loops)
    assert chip_smoke.solver_sass_counts(funcs) == {
        "propagate_fixpoint": (120, None), "propagate_fixpoint_priorities": (120, 197),
        "beam_search": (99, 169)}
    unrolled = chip_smoke.sass_functions(_persistent_listing(step_unroll=2))
    assert chip_smoke.loop_instructions(unrolled["fixpoint_kernel<1>"],
                                        chip_smoke.STEP_SHUFFLES) == 239 / 2


class _FakeProfile:
    """torch.profiler.profile's stand-in: each trace gives the next of
    ``traces``, lists of (kernel, events, device microseconds)."""

    def __init__(self, traces):
        self.traces = iter(traces)

    def __call__(self, **kwargs):
        self.events = [SimpleNamespace(key=k, count=c, device_time_total=t)
                       for k, c, t in next(self.traces)]
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step(self):
        pass

    def key_averages(self):
        return self.events


def _device_ms(monkeypatch, traces, launches_a_call=1, **kw):
    """profiled_device_ms over 5 calls of a stand-in for the rollout that
    counts ``launches_a_call`` launches, the traces given."""
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile(traces))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setitem(step_cuda.LAUNCHES, "rollout", 0)

    def call():
        step_cuda.LAUNCHES["rollout"] += launches_a_call

    return chip_smoke.profiled_device_ms(call, "rollout_kernel", "rollout", n=5, **kw)


def test_device_time_is_the_mean_of_the_launches_a_trace_holds(monkeypatch):
    full = [("void rollout_kernel(...)", 5, 500.0), ("cudaLaunchKernel", 5, 0.0)]
    assert _device_ms(monkeypatch, [full]) == pytest.approx(0.1)
    # a trace that missed launches reads their mean, not their sum over n
    short = [("void rollout_kernel(...)", 3, 300.0)]
    assert _device_ms(monkeypatch, [short]) == pytest.approx(0.1)
    two = [("void rollout_kernel(...)", 8, 400.0)]
    assert _device_ms(monkeypatch, [two], launches_a_call=2) == pytest.approx(0.1)


def test_whole_call_counts_each_kernels_launches_a_call(monkeypatch):
    partial = [("void rollout_kernel(...)", 5, 500.0), ("elementwise_kernel", 9, 90.0)]
    got = _device_ms(monkeypatch, [partial], whole_call=True)
    assert got == pytest.approx(0.12)


def test_traces_missing_half_the_launches_are_taken_again(monkeypatch):
    empty, full = [], [("void rollout_kernel(...)", 5, 500.0)]
    two = [("void rollout_kernel(...)", 2, 200.0)]
    assert _device_ms(monkeypatch, [empty, two, full]) == pytest.approx(0.1)
    # a kernel launched twice a call whose trace holds under one a call
    ten = [("void rollout_kernel(...)", 10, 1000.0)]
    assert _device_ms(monkeypatch, [two, ten], launches_a_call=2) == pytest.approx(0.2)
    few = [("void rollout_kernel(...)", 5, 500.0), ("elementwise_kernel", 2, 20.0)]
    assert _device_ms(monkeypatch, [few, full], whole_call=True) == pytest.approx(0.1)


def test_short_traces_fail_the_run(monkeypatch):
    short = [("void rollout_kernel(...)", 2, 200.0)]
    with pytest.raises(AssertionError, match="no usable trace"):
        _device_ms(monkeypatch, [short] * chip_smoke.PROFILE_TRIES)
    with pytest.raises(AssertionError, match="launched no kernel"):
        _device_ms(monkeypatch, [short], launches_a_call=0)
