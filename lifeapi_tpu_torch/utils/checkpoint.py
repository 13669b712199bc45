"""Checkpoint / resume of search and MPC state (counterpart of
:mod:`lifeapi_tpu.utils.checkpoint`, which uses orbax).

Any nest of dicts, lists and tuples of tensors (board batches, control
logits, incumbents) round-trips through ``torch.save`` /
``torch.load(weights_only=True)``, which loads tensors and plain
containers only.  RLE import and export stay for interop with Golly and
the reference.
"""

from __future__ import annotations

from pathlib import Path

import torch

from .._device import resolve


def save(path, state):
    """Save a nest of tensors to the file ``path``."""
    torch.save(state, Path(path))


def _like(value, template):
    if isinstance(template, torch.Tensor):
        return value.to(dtype=template.dtype, device=template.device)
    if isinstance(template, dict):
        return {k: _like(value[k], t) for k, t in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(v, t) for v, t in zip(value, template))
    return value


def restore(path, template=None, device=None):
    """Load what :func:`save` wrote.  With ``template`` (a nest of like
    tensors) every tensor comes back with the template's dtype and device;
    without it, on ``device``: the CUDA card unless given another."""
    if template is not None:
        return _like(torch.load(Path(path), map_location="cpu", weights_only=True), template)
    return torch.load(Path(path), map_location=resolve(device), weights_only=True)


def save_rle(path, board):
    """Write a board as Golly RLE."""
    from ..core import rle

    Path(path).write_text(rle.to_rle(board) + "\n")


def load_rle(path, device=None):
    """Read a Golly RLE file into a board, on the CUDA card unless given
    another ``device``."""
    from ..core import rle

    dev = resolve(device)
    return rle.parse(Path(path).read_text(), device=dev)
