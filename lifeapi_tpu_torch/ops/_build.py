"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles each ``lifeapi_tpu_torch/csrc/*.cu`` for
``sm_90a`` into an object, one compiler process per source, all started
together, and links the objects into one shared library with a plain C
interface.  The library is stored in ``lifeapi_tpu_torch/_build/`` under a
hash of the sources, the shared headers (``csrc/*.cuh``) and the flags, and
loaded with ``ctypes``.  No torch headers are compiled, so the build takes
seconds.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# launcher name -> argument types; every launcher returns its cudaError_t
SIGNATURES = {
    "life_rollout": (_P, _P, _I, _I, _P),
    "life_rollout_lohi": (_P, _P, _P, _P, _I, _I, _P),
    "life_controlled_rollout": (_P, _P, _P, _I, _I, _P),
    "life_catalyst_rollout": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    "life_stable_step": (_P, _P, _P, _P, _I, _P),
    "life_stable_fixpoint": (_P, _P, _P, _P, _I, _I, _P),
    "life_stable_fixpoint_info": (_I, _P),
    "life_stable_beam": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "life_stable_beam_info": (_I, _P),
    "life_conv_sparse": (_P, _P, _P, _I, _P),
    "life_counts_sparse": (_P, _P, _P, _I, _I, _P),
    "life_union_sparse": (_P, _I, _P, _I, _P),
    "life_conv_counts": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "life_conv_small": (_P, _P, _P, _P, _I, _I, _I, _P),
    "life_conv_small_packed": (_P, _P, _P, _P, _I, _I, _P),
    "life_conv_ntt_info": (_P,),
    "life_calibrate": (_P, _P, _P, _I, _I, _I, _P),
    "life_soft_rollout": (_P, _L, _P, _L, _L, _P, _I, _I, _F, _P),
    "life_soft_rollout_vjp": (_P, _L, _P, _L, _L, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    "life_soft_rollout_hvp": (_P, _L, _P, _L, _L, _P, _P, _P, _P, _L, _P, _P, _P, _P,
                              _I, _I, _F, _P),
    "life_soft_sweep_info": (_I, _P),
    "life_soft_objective": (_P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _L, _L, _P, _P, _I, _I, _F,
                            _P),
    "life_soft_objective_vjp": (_P, _P, _P, _P, _P, _F, _F, _F, _F, _P, _L, _L, _P, _P, _P, _L,
                                _P, _P, _P, _I, _I, _F, _P),
    "life_soft_objective_hvp": (_P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    "life_cg_update": (_P, _P, _P, _P, _P, _P, _I, _L, _P),
    "life_cg_update_info": (_L, _I, _P),
    "life_adam_update": (_P, _P, _P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F, _F, _F, _P),
}

_library = None


def nvcc_path():
    """The ``nvcc`` on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds, logs):
    """Run the commands concurrently, each with its output in a log file;
    raise on the first that fails."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT))
    codes = [p.wait() for p in procs]
    for cmd, log, code in zip(cmds, logs, codes):
        if code != 0:
            raise RuntimeError(f"nvcc failed with exit code {code}:\n"
                               f"{' '.join(cmd)}\n{Path(log).read_text()}")


def library_file(csrc=CSRC):
    """Where the build of the sources in ``csrc`` lives: named by a hash of
    every source, every shared header and the flags, so an edit to any of
    them makes a new build."""
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"liblife_kernels_{digest.hexdigest()[:16]}.so"


def library_path():
    """Compile the kernels unless a build of these exact sources exists;
    return the shared library's path.  The compiler's report (registers,
    spills per kernel) is kept beside it as ``<name>.log``."""
    out = library_file()
    if out.exists():
        return out
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    # build in a private directory, then rename: a concurrent build never
    # sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        objs = [tmp / f"{src.stem}.o" for src in sources]
        logs = [tmp / f"{src.stem}.log" for src in sources]
        _run_all([[nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
                  for src, obj in zip(sources, objs)], logs)
        tmp_out = tmp / out.name
        _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp_out), *map(str, objs)]],
                 [tmp / "link.log"])
        out.with_suffix(".log").write_text(
            "".join(log.read_text() for log in logs))
        os.replace(tmp_out, out)
    return out


def library():
    """The loaded kernel library, built at first call."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(library_path()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library
