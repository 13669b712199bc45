"""Runnable end-to-end workflows of the port, the counterparts of the JAX
package's ``examples/``.  Each runs as

    python -m lifeapi_tpu_torch.examples.<name> [--device cpu]

on the CUDA card unless given ``--device cpu``, and exposes
``run(device, ...)``, which returns its results for tests and scripts.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np
import torch

from .._device import resolve


def resolve_device(name):
    """``torch.device`` for a device name, CUDA for None; asking for CUDA
    where there is none raises instead of falling back."""
    return resolve(name, who="the example runs")


def life_step_dense(dense):
    """One B3/S23 generation of a dense numpy grid [..., 64, 64] on the
    torus, by explicit neighbour sums: a check independent of the port's
    bit-parallel step."""
    g = np.asarray(dense).astype(np.uint8)
    count = sum(np.roll(np.roll(g, dx, axis=-2), dy, axis=-1)
                for dx in (-1, 0, 1) for dy in (-1, 0, 1)) - g
    return (count == 3) | ((g == 1) & (count == 2))


class Stages:
    """Host seconds per named stage; on a CUDA device each stage ends with
    ``torch.cuda.synchronize()``, so the time covers its device work."""

    def __init__(self, device):
        self.device = device
        self.seconds = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def __call__(self, name):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
