"""LifeHistory: the 4-plane Golly "LifeHistory" overlay for visualization and
interchange.  Counterpart of :mod:`lifeapi_tpu.history` (reference
LifeHistory.hpp:8-105)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._device import resolve
from .core import board as board_mod
from .core import convolve as convolve_mod
from .core import rle as rle_mod


class LifeHistory(NamedTuple):
    state: torch.Tensor  # int64[..., 64]
    history: torch.Tensor
    marked: torch.Tensor
    original: torch.Tensor

    @staticmethod
    def create(state=None, history=None, marked=None, original=None, device=None):
        """The four planes, each empty where not given, on ``device``, else
        on the device of the given planes, else on the CUDA card."""
        planes = (state, history, marked, original)
        dev = resolve(device, like=planes)
        e = board_mod.empty(device=dev)
        return LifeHistory(*(e if p is None else p.to(dev) for p in planes))

    def move(self, dx, dy):
        return LifeHistory(*(board_mod.move(p, dx, dy) for p in self))

    def align_with(self, other):
        """Reference LifeHistory.hpp:56-59."""
        x, y = board_mod.first_on(convolve_mod.match(self.state, other)).tolist()
        return self.move(-x, -y)

    def rle(self):
        return write_rle(self)

    def rle_with_header(self):
        return "x = 0, y = 0, rule = LifeHistory\n" + self.rle()


def state_to_char(mask):
    """Reference ``StateToChar`` (LifeHistory.hpp:32-42)."""
    return {0b0000: ".", 0b0001: "A", 0b0010: "B", 0b0101: "C",
            0b0100: "D", 0b1001: "E"}.get(mask, "F")


def write_rle(h: LifeHistory):
    """Reference LifeHistory.hpp:62-68."""
    s, hist, m, o = (board_mod.to_dense(p).cpu().numpy() for p in h)

    def char(x, y):
        return state_to_char(int(s[x, y]) | int(hist[x, y]) << 1 | int(m[x, y]) << 2
                             | int(o[x, y]) << 3)

    return rle_mod.write_rle_planes(char)


_PARSE_CHARMAP = {
    "A": ("state",),
    "B": ("history",),
    "C": ("state", "marked"),
    "D": ("marked",),
    "E": ("state", "original"),
}

_BELLMAN_CHARMAP = {"C": ("state",), "E": ("history",)}


def _from_planes(planes, device):
    device = resolve(device)

    def get(name):
        if name in planes:
            return board_mod.from_dense(torch.from_numpy(planes[name]).to(device))
        return board_mod.empty(device=device)

    return LifeHistory(get("state"), get("history"), get("marked"), get("original"))


def parse(rle, device=None):
    """Reference ``LifeHistory::Parse`` (LifeHistory.hpp:70-92)."""
    return _from_planes(rle_mod.parse_dense(rle, _PARSE_CHARMAP), device)


def parse_bellman(rle, device=None):
    """Reference ``ParseBellman`` (LifeHistory.hpp:94-105): Bellman-rule
    RLEs use C for state and E for history."""
    return _from_planes(rle_mod.parse_dense(rle, _BELLMAN_CHARMAP), device)
