"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``lifeapi_tpu_torch/csrc/*.cu`` for
``sm_90a`` into one shared library with a plain C interface, stored in
``lifeapi_tpu_torch/_build/`` under a hash of the sources and flags, and
the library is loaded with ``ctypes``.  No torch headers are compiled, so
the build takes seconds.  A failed build raises; nothing falls back.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# launcher name -> argument types; every launcher returns its cudaError_t
SIGNATURES = {
    "life_rollout": (_P, _P, _I, _I, _P),
    "life_controlled_rollout": (_P, _P, _P, _I, _I, _P),
    "life_catalyst_rollout": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
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


def library_path():
    """Compile the kernels unless a build of these exact sources exists;
    return the shared library's path.  The compiler's report (registers,
    spills per kernel) is kept beside it as ``<name>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"liblife_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    # build in a private directory, then rename: a concurrent build never
    # sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp_out), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
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
