"""The independent C Life oracle (``oracle.c``, a byte-for-byte copy of the
JAX package's), built with the system C compiler at first use and bound
with ctypes: the differential check of the port's stepping, its kernels
included."""

from .build import (  # noqa: F401
    from_packed64, load_oracle, step_dense, step_packed64, to_packed64)
