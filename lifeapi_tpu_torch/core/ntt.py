"""The number-theoretic transform behind the dense convolution counts.

One definition of the primes, the twiddle matrices and the CRT inverse,
shared by ``core.convolve``'s ``method="ntt"``, the dense-counts kernels'
plain twins and the twiddles the kernels themselves load
(``ops.conv_cuda``).  The number theory is the JAX package's
(``lifeapi_tpu/core/convolve.py`` ``_ntt_matrices``, ``ops/conv_pallas.py``):
the primes 193 and 257 are both 1 mod 64, so each has a 64th root of
unity, and their product 49601 exceeds the largest count, 4096.  Every
residue and every twiddle is below 257, so it is an integer of at most 8
significant bits, exact in bfloat16; a 64-term sum of their products stays
below 64 * 256**2 = 2**22 < 2**24, exact in float32 accumulation.

The twin here computes in float64, where those sums are exact as well; any
exact mod-p computation gives the same residues, so it need not follow the
kernel stage by stage.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import resolve

N = 64
PRIMES = (193, 257)
CRT_INVERSE = pow(PRIMES[0], PRIMES[1] - 2, PRIMES[1])  # 193**-1 mod 257


@functools.lru_cache(maxsize=None)
def _matrix(p, inverse):
    g = next(g for g in range(2, p) if len({pow(g, k, p) for k in range(p - 1)}) == p - 1)
    w = pow(g, (p - 1) // N, p)
    if inverse:
        w = pow(w, N - 1, p)
    scale = pow(N, p - 2, p) if inverse else 1
    jk = np.outer(np.arange(N), np.arange(N)) % N
    powers = np.array([pow(w, e, p) for e in range(N)], dtype=np.int64)
    return powers[jk] * scale % p


def matrix(p, inverse, device=None):
    """The 64-point NTT matrix mod p, ``int64[64, 64]`` (its inverse, with
    the 1/64 factor, when ``inverse``), from the same root of unity as the
    JAX package.  Both are symmetric."""
    return torch.from_numpy(_matrix(p, inverse).copy()).to(resolve(device))


def reduce(x, p):
    """x mod p, into [0, p): every reduction of the transform goes through
    here."""
    return torch.remainder(x, p)


def _transform2(x, w, p):
    """W @ X @ W mod p along both axes of ``[..., 64, 64]`` (W symmetric)."""
    return reduce(w @ reduce(x @ w, p), p)


def residues(da, db, p):
    """The circular convolution counts of dense 0/1 fields ``[..., 64, 64]``
    mod p, as ``int64``: forward transforms of both, their pointwise product
    and the inverse transform, each stage reduced mod p."""
    w = matrix(p, False, da.device).to(torch.float64)
    v = matrix(p, True, da.device).to(torch.float64)
    fa = _transform2(da.to(torch.float64), w, p)
    fb = _transform2(db.to(torch.float64), w, p)
    return _transform2(reduce(fa * fb, p), v, p).to(torch.int64)


def counts(da, db):
    """Exact circular convolution counts ``int64[..., 64, 64]`` of dense 0/1
    fields, by CRT over the residues mod both primes."""
    p1, p2 = PRIMES
    c1, c2 = residues(da, db, p1), residues(da, db, p2)
    return c1 + p1 * torch.remainder((c2 - c1) * CRT_INVERSE, p2)
