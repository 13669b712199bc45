"""Word-level bit tricks on 64-bit columns held as ``torch.int64``.

Counterpart of :mod:`lifeapi_tpu.core.bitops`.  A column is one int64 word,
bit y = cell y.  torch's ``>>`` on int64 is arithmetic (sign-extending), so
every right shift here is masked to make it logical, and torch has no
tensor popcount, so :func:`popcount64` is SWAR.
"""

from __future__ import annotations

import torch

_INT64_MAX = 0x7FFFFFFFFFFFFFFF


def shr64(x, s):
    """Logical right shift of int64 words by ``s`` (int in [1, 63] or an
    int64 tensor with values in [1, 63])."""
    return (x >> s) & (_INT64_MAX >> (s - 1))


def rotl64(x, k):
    """Rotate each 64-bit word left (towards higher y) by ``k``
    (``std::rotl``).  ``k`` is a Python int or an integer tensor that
    broadcasts against ``x``; any value is taken mod 64."""
    if isinstance(k, int):
        k %= 64
        if k == 0:
            return x
        return (x << k) | shr64(x, 64 - k)
    k = torch.remainder(k.to(torch.int64), 64)
    right = shr64(x, torch.where(k == 0, 1, 64 - k))
    return torch.where(k == 0, x, (x << k) | right)


def rotr64(x, k):
    """Rotate each 64-bit word right by ``k``."""
    return rotl64(x, -k)


def _popcount32(x):
    """SWAR population count of int64 words holding values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def popcount64(x):
    """Population count of each int64 word, as int64.  Counted on the two
    32-bit halves: both are non-negative, so no step can overflow."""
    return _popcount32(x & 0xFFFFFFFF) + _popcount32(shr64(x, 32))


def as_int64(u):
    """The int64 with the same 64 bits as the unsigned value ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


# (shift, mask of the bits that move down) for the SWAR bit reversal
_REVERSE_STEPS = tuple((1 << i, as_int64(m)) for i, m in enumerate((
    0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F,
    0x00FF00FF00FF00FF, 0x0000FFFF0000FFFF, 0x00000000FFFFFFFF)))


def reverse64(x):
    """Bit y of each word -> bit 63 - y (``__builtin_bitreverse64``,
    reference LifeAPI.hpp:758-762)."""
    for s, m in _REVERSE_STEPS:
        x = (shr64(x, s) & m) | ((x & m) << s)
    return x


def bitrev32(x):
    """Reverse the low 32 bits of each word (reference Bits.hpp:10-23);
    the result lies in [0, 2**32)."""
    return shr64(reverse64(x & 0xFFFFFFFF), 32)


def longest_run64(x):
    """Length of the longest *circular* run of 1 bits of each int64 word
    (reference Bits.hpp:29-62): 0 for 0, 64 for all ones.  Each round
    erodes every run by one bit, so the count of rounds with a bit left is
    the longest run."""
    count = torch.zeros_like(x)
    for _ in range(64):
        count += x != 0
        x = x & rotl64(x, 1)
    return count


def populated_width64(x):
    """Width of the smallest circular window holding every set bit
    (reference Bits.hpp:64-79): 64 - the longest circular run of zeros,
    0 for 0.  ``~x`` of an int64 word is its bit complement (a negative
    number where x's top bit is clear), which is what the run takes."""
    return torch.where(x == 0, 0, 64 - longest_run64(~x))


def convolve_word64(x, y):
    """OR-convolution of two 64-bit words: bit k of the result is set iff
    there are set bits i of x and j of y with i + j == k (mod 64)
    (reference Bits.hpp:132-143).  ``(x >> k) & 1`` is bit k of x for
    every k, the sign bit included."""
    out = torch.zeros_like(torch.broadcast_tensors(x, y)[0])
    for k in range(64):
        out = out | (rotl64(y, k) & -((x >> k) & 1))
    return out
