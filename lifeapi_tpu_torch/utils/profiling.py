"""Tracing and timing hooks (counterpart of
:mod:`lifeapi_tpu.utils.profiling`; the reference has none).

On a CUDA card every timer waits for the device (``torch.cuda.synchronize``)
before it reads the clock, so a time covers the device work it launched.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(dirname=None):
    """Record a ``torch.profiler`` trace of the block (host and, where
    there is a card, device activity) and write it to
    ``<dirname>/trace.json``, viewable in Perfetto or chrome://tracing.
    ``dirname`` defaults to ``lifeapi_tpu_torch_trace`` in the temporary
    directory."""
    dirname = dirname or os.path.join(tempfile.gettempdir(), "lifeapi_tpu_torch_trace")
    os.makedirs(dirname, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield dirname
        _sync()
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))


class Timer:
    """Wall-clock timer, fenced by a device synchronise on the card."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.times.append(time.perf_counter() - t0)

    def best(self):
        return min(self.times)

    def mean(self):
        return sum(self.times) / len(self.times)


def benchmark(fn, *args, reps=10, warmup=2):
    """Seconds per call of ``fn(*args)``, after ``warmup`` calls, over
    ``reps`` calls that end in a device synchronise."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / reps


def steps_per_second(n_boards, n_steps, seconds):
    return n_boards * n_steps / seconds
