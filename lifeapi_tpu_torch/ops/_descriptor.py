"""Boards where they lie: the pointer-and-stride descriptor that the solver's
fixpoint kernels B and C (``csrc/life_stable.cu``, ``PlaneSet``) and the
union peel (``csrc/life_conv.cu``, ``PairSet``) take in place of stacked
operands.  Each plane of a batch of ``int64[..., 64]`` boards is passed as a
pointer and one 32-bit board stride in words (0 for a broadcast batch)."""

from __future__ import annotations

import ctypes

import torch


def _board_stride(plane):
    """The words from one board to the next of an ``int64[..., 64]`` plane
    whose last dimension is contiguous and whose batch dimensions flatten to
    one stride (a batch of one board takes 64), else None."""
    if plane.stride(-1) != 1:
        return None
    board, span = None, 1
    for size, step in zip(reversed(plane.shape[:-1]), reversed(plane.stride()[:-1])):
        if size == 1:
            continue
        if board is None:
            board = step
        elif step != board * span:
            return None
        span *= size
    return 64 if board is None else board


# the kernels take each board stride as a 32-bit int
MAX_BOARD_STRIDE = 2**31 - 1


def plane_descriptor(planes):
    """Where a kernel finds a batch of boards' planes: ``planes`` is a
    sequence of ``int64[..., 64]`` tensors of one shape.  A plane is read in
    place where its last dimension is contiguous and its batch dimensions
    flatten to one board stride below 2**31 words; any other plane is
    copied.  Returns (pointers, board strides in words, the tensors they
    name), the last to be kept alive until the launch is queued."""
    pointers, strides, kept = [], [], []
    for plane in planes:
        board = 64 if plane.is_contiguous() else _board_stride(plane)
        if board is None or board > MAX_BOARD_STRIDE:
            plane = plane.clone(memory_format=torch.contiguous_format)
            board = 64
        pointers.append(plane.data_ptr())
        strides.append(board)
        kept.append(plane)
    return pointers, strides, kept


def descriptor_words(pointers, strides):
    """The kernel's view of a set of planes: the pointers, then the board
    strides in words."""
    return (ctypes.c_int64 * (2 * len(strides)))(*pointers, *strides)
