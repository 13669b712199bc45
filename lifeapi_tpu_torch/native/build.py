"""Build and bind the native oracle (counterpart of
:mod:`lifeapi_tpu.native.build`).

``oracle.c`` is compiled with ``cc -O2 -shared -fPIC`` into
``lifeapi_tpu_torch/_build/`` under a hash of its text, so an edit makes a
new build, and loaded with ctypes.  A failed build raises; nothing falls
back to another oracle.

The oracle's packed layout is ``uint64[B, 64]``, one word per column with
bit y = cell y: the port's board layout, so :func:`to_packed64` and
:func:`from_packed64` only reinterpret the words' sign.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .._device import resolve

_SRC = Path(__file__).resolve().parent / "oracle.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC")

N = 64

_lib = None


def library_file():
    """Where the build of this ``oracle.c`` lives."""
    digest = hashlib.sha256(" ".join(CFLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"liboracle_{digest.hexdigest()[:16]}.so"


def library_path():
    """Compile ``oracle.c`` unless a build of this exact text exists;
    return the shared library's path."""
    out = library_file()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    cc = os.environ.get("CC", "cc")
    # build in a private directory, then rename: a concurrent build never
    # sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp_out), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{cc} failed with exit code {proc.returncode} on "
                               f"{_SRC.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp_out, out)
    return out


def load_oracle():
    """The loaded oracle library, built at first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        for name, argtypes in (
                ("life_step_dense_n", [u8p, u8p, ctypes.c_int, ctypes.c_int]),
                ("life_step_packed_n", [u64p, u64p, ctypes.c_int, ctypes.c_int])):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
    return _lib


def _run(fn, grids, dtype, cell_shape, steps):
    grids = np.ascontiguousarray(grids, dtype=dtype)
    if grids.shape[-len(cell_shape):] != cell_shape:
        raise ValueError(f"expected [..., {', '.join(map(str, cell_shape))}], "
                         f"got {grids.shape}")
    steps = int(steps)
    if not 0 <= steps < 2**31:
        raise ValueError(f"steps {steps} out of range")
    flat = grids.reshape(-1, *cell_shape)
    if flat.shape[0] >= 2**31:
        raise ValueError(f"batch {flat.shape[0]} out of range")
    out = np.empty_like(flat)
    fn(flat, out, flat.shape[0], steps)
    return out.reshape(grids.shape)


def step_dense(grids, steps=1):
    """``grids``: uint8/bool ``[..., 64, 64]`` indexed [x, y]; returns the
    cells (uint8) after ``steps`` generations."""
    return _run(load_oracle().life_step_dense_n, grids, np.uint8, (N, N), steps)


def step_packed64(boards, steps=1):
    """``boards``: ``uint64[..., 64]`` columns; returns them after
    ``steps`` generations."""
    return _run(load_oracle().life_step_packed_n, boards, np.uint64, (N,), steps)


def to_packed64(board):
    """Port board ``int64[..., 64]`` (any device) -> the oracle's
    ``uint64[..., 64]`` numpy words."""
    if board.dtype != torch.int64 or board.shape[-1:] != (N,):
        raise ValueError(f"expected int64[..., 64], got {board.dtype} {tuple(board.shape)}")
    return board.detach().cpu().contiguous().numpy().view(np.uint64)


def from_packed64(words, device=None):
    """The oracle's ``uint64[..., 64]`` words -> port board ``int64[..., 64]``."""
    w = np.ascontiguousarray(words, dtype=np.uint64)
    return torch.from_numpy(w.view(np.int64).copy()).to(resolve(device))
