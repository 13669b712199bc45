"""The port's kernel build: what keys a build, and how chip_smoke.py reads
the compiler's register report.  No compiler is needed."""

import shutil

import chip_smoke
from lifeapi_tpu_torch.ops import _build

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


def test_ptxas_report_names_each_kernel():
    assert chip_smoke.ptxas_report(PTXAS_LOG) == [
        ("beam_kernel<256>", 173, 172), ("rollout_kernel", 32, 0)]
