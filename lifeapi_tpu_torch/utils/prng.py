"""Deterministic randomness plumbing (counterpart of
:mod:`lifeapi_tpu.utils.prng`).

The reference seeds a global mt19937 from ``std::random_device``
(LifeAPI.hpp:18-23), nondeterministic by design.  The JAX package threads
splittable ``jax.random`` keys through every API; the port threads
``torch.Generator`` objects.  These helpers derive fresh generators from
one seed: the same seed gives the same generators, but their draws are not
bit-equal to the JAX package's threefry keys.
"""

from __future__ import annotations

import hashlib

import torch

from .._device import resolve

_SEED_HIGH = 2**63 - 1  # seeds are drawn from [0, 2**63 - 1)


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


class KeySequence:
    """Stateful source of generators: ``ks = KeySequence(0); g = ks()``.
    Each call returns a new generator, seeded from the next draw of the
    sequence's own generator, on the same device.  A seed makes that
    generator on ``device``, the CUDA card unless given another; a given
    generator keeps its own device."""

    def __init__(self, seed_or_generator, device=None):
        if isinstance(seed_or_generator, int):
            self._gen = _generator(seed_or_generator, resolve(device))
        else:
            self._gen = seed_or_generator

    def __call__(self):
        seed = int(torch.randint(0, _SEED_HIGH, (), generator=self._gen,
                                 device=self._gen.device))
        return _generator(seed, self._gen.device)

    def split(self, n):
        return [self() for _ in range(n)]


def fold_in(generator, *data):
    """A new generator determined by ``generator``'s state and the integers
    ``data``, folded in one at a time (as ``jax.random.fold_in`` applied per
    datum); ``generator`` itself is not advanced."""
    for d in data:
        h = hashlib.sha256(generator.get_state().cpu().numpy().tobytes())
        h.update(int(d).to_bytes(8, "little", signed=True))
        generator = _generator(int.from_bytes(h.digest()[:8], "little") % _SEED_HIGH,
                               generator.device)
    return generator
