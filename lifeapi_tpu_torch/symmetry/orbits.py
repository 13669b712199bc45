"""Orbit utilities: orientation-independent hashing, orbit enumeration,
matching under all transforms.

Counterpart of :mod:`lifeapi_tpu.symmetry.orbits` (reference
Symmetry.hpp:774-830 and LifeAPI.hpp:373-375).  Hashing is blake2b of a
board's bytes on the host, the same bytes as the JAX package's packed
``uint32[64, 2]`` (the little-endian bytes of the ``int64`` words), so the
hashes agree.  :func:`fingerprint` is a batched device-side 64-bit key for
deduplication.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..core import board as board_mod
from .transforms import ALL_TRANSFORMS, SymmetryTransform as T, transform

_OCTO_TRANSFORMS = (
    T.Identity,
    T.ReflectAcrossX,
    T.ReflectAcrossYeqX,
    T.ReflectAcrossY,
    T.ReflectAcrossYeqNegXP1,
    T.Rotate90,
    T.Rotate270,
    T.Rotate180OddBoth,
)


def board_hash(board):
    """Host-side stable 64-bit hash of a board (reference ``GetHash``,
    LifeAPI.hpp:373)."""
    raw = np.ascontiguousarray(board.detach().cpu().numpy().astype("<i8")).tobytes()
    return int.from_bytes(hashlib.blake2b(raw, digest_size=8).digest(), "little")


def _anchor_candidates(populated):
    """All starts of the tightest circular populated window of a bool[64]
    numpy vector, one per maximal circular run of empty entries (tied gaps
    give several anchors; all must be considered for translation
    invariance)."""
    n = populated.shape[-1]
    if not populated.any():
        return [0]
    if populated.all():
        return list(range(n))  # no gap: every rotation is a candidate
    starts, best = [], 0
    for i in range(n):
        if populated[i - 1] and not populated[i]:  # gap starts at i
            length = 1
            while not populated[(i + length) % n]:
                length += 1
            if length > best:
                best, starts = length, [(i + length) % n]
            elif length == best:
                starts.append((i + length) % n)
    return starts


def _normalize_origin(board):
    """(hash, normalized board): the board translated to its canonical
    origin, the anchor among all tied tightest windows whose rolled dense
    serialization is lexicographically smallest, so the result depends on
    the pattern's content only."""
    dense = board_mod.to_dense(board).cpu().numpy()
    xs = _anchor_candidates(dense.any(axis=1))
    ys = _anchor_candidates(dense.any(axis=0))
    # row x packed MSB-first: lexicographic order on the uint64 vector is
    # lexicographic order on the dense serialization
    words = np.packbits(dense, axis=1).view(">u8").astype(np.uint64)[:, 0]
    n = words.shape[0]
    idx = (np.asarray(xs)[:, None] + np.arange(n)[None, :]) % n
    cands, pairs = [], []
    for y0 in ys:
        rot = words if y0 == 0 else (
            (words << np.uint64(y0)) | (words >> np.uint64(n - y0)))
        cands.append(rot[idx])
        pairs.extend((x0, y0) for x0 in xs)
    cands = np.concatenate(cands, axis=0)
    x0, y0 = pairs[np.lexsort(cands.T[::-1])[0]]
    moved = board_mod.move(board, -int(x0), -int(y0))
    return board_hash(moved), moved


def octo_hash(board):
    """XOR of the hashes of all 16 transforms normalized to the origin
    (reference ``GetOctoHash``, Symmetry.hpp:774-785).  As in the reference
    the XOR cancels in pairs, so the key is invariant under translation and
    the y=x reflection only; :func:`canonical_hash` is fully
    orientation-independent."""
    result = 0
    for t in ALL_TRANSFORMS:
        result ^= _normalize_origin(transform(board, t))[0]
    return result


def canonical_hash(board):
    """Orientation- and translation-independent key: the least hash of the 8
    origin-normalized D8 images."""
    return min(_normalize_origin(transform(board, t))[0] for t in _OCTO_TRANSFORMS)


_FP_KEY = np.random.default_rng(0xF00D).integers(1, 2**32, size=(64, 2), dtype=np.uint32) | 1
_MASK32 = 0xFFFFFFFF


def fingerprint(board):
    """Batched 64-bit fingerprint for device-side deduplication of boards
    ``int64[..., 64]``: two uint32 lanes, as ``int64[...]`` tensors holding
    values in [0, 2**32), equal to the JAX package's.  Each 32-bit half of a
    word is multiplied by its key mod 2**32, the products summed mod 2**32
    (lane a), and again after ``p ^ (p >> 7)`` (lane b)."""
    key = torch.from_numpy(_FP_KEY.astype(np.int64)).to(board.device)
    halves = torch.stack([board & _MASK32, (board >> 32) & _MASK32], dim=-1)
    # (h * k) mod 2**32 from 16-bit pieces of k: no product reaches 2**63
    k_lo, k_hi = key & 0xFFFF, key >> 16
    prod = (halves * k_lo + (((halves * k_hi) & 0xFFFF) << 16)) & _MASK32
    a = prod.sum(dim=(-2, -1)) & _MASK32
    b = (prod ^ (prod >> 7)).sum(dim=(-2, -1)) & _MASK32
    return a, b


def symmetry_orbit(board):
    """Distinct origin-normalized D8 images of the board (reference
    ``SymmetryOrbit``, Symmetry.hpp:798-812)."""
    return [image for _, image in _distinct_images(board)]


def symmetry_orbit_representatives(board):
    """Transforms giving distinct normalized images (reference
    Symmetry.hpp:814-830)."""
    return [t for t, _ in _distinct_images(board)]


def _distinct_images(board):
    images = []
    for t in _OCTO_TRANSFORMS:
        _, tr = _normalize_origin(transform(board, t))
        if not any(bool(board_mod.equal(tr, seen)) for _, seen in images):
            images.append((t, tr))
    return images


def matches_live_and_dead_sym(state, live, dead):
    """Union over all 16 transforms of match positions, smeared by the
    transformed pattern (reference ``MatchesLiveAndDeadSym``,
    Symmetry.hpp:787-796)."""
    from ..core import convolve as convolve_mod

    result = torch.zeros_like(state)
    for t in ALL_TRANSFORMS:
        tl, td = transform(live, t), transform(dead, t)
        matches = convolve_mod.match_live_and_dead(state, tl, td)
        result = result | convolve_mod.convolve(matches, tl)
    return result
