"""Carry state between :mod:`lifeapi_tpu` and this port, through numpy.

The system has no learned weights: what crosses over is boards, targets,
control masks, MPC problems and runs, partial still lifes, LifeHistory overlays,
welds, symmetry enums and the rollout kernels' half-word layout, and what comes back for comparison is boards, counter
planes and results.  Every function here takes numpy arrays, or objects
whose fields convert with ``np.asarray`` (the JAX package's NamedTuples
of JAX arrays), so this module never imports jax.

The ``*_from_*`` functions build on the CUDA card unless given another
``device`` (:func:`lifeapi_tpu_torch._device.resolve`).

Board layouts: the JAX package packs a board as ``uint32[..., 64, 2]``
with word 0 = bits y 0..31 and word 1 = bits y 32..63 of column x; the
port holds the same 64 bits as one ``int64`` word per column,
``int64[..., 64]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve
from .history import LifeHistory
from .stable.api import LifeStable
from .mpc.cost import CostWeights
from .mpc.solver import MPCProblem
from .stable.bitplane import BitStable
from .stable.propagate import Stable
from .symmetry.groups import StaticSymmetry
from .symmetry.transforms import SymmetryTransform
from .target import LifeTarget
from .weld import LifeWeld


def board_from_packed(packed, device=None):
    """JAX packed ``uint32[..., 64, 2]`` -> port board ``int64[..., 64]``."""
    a = np.asarray(packed, dtype=np.uint32)
    if a.shape[-2:] != (64, 2):
        raise ValueError(f"expected a packed board [..., 64, 2], got {a.shape}")
    words = a[..., 0].astype(np.uint64) | (a[..., 1].astype(np.uint64) << np.uint64(32))
    return torch.from_numpy(words.view(np.int64)).to(resolve(device))


def board_to_packed(board):
    """Port board ``int64[..., 64]`` -> JAX packed ``uint32[..., 64, 2]``."""
    if board.dtype != torch.int64 or board.shape[-1:] != (64,):
        raise ValueError(f"expected int64[..., 64], got {board.dtype} {tuple(board.shape)}")
    w = board.detach().cpu().contiguous().numpy().view(np.uint64)
    lo = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (w >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=-1)


def planes_from_packed(planes, device=None):
    """A list of JAX packed planes (e.g. the counter planes of
    ``counts_sparse_fused``) -> a list of port boards."""
    return [board_from_packed(p, device) for p in planes]


def planes_to_packed(planes):
    """A list of port boards -> a list of JAX packed planes."""
    return [board_to_packed(p) for p in planes]


def history_from_jax(history, device=None):
    """A JAX ``LifeHistory`` (four packed planes) -> the port's."""
    return LifeHistory(*(board_from_packed(p, device) for p in history))


def history_to_jax(history):
    """Port ``LifeHistory`` -> its four packed numpy planes;
    ``lifeapi_tpu.history.LifeHistory(*out)`` rebuilds the JAX one."""
    return tuple(board_to_packed(p) for p in history)


def transform_from_jax(t):
    """A JAX ``SymmetryTransform`` (or its int value) -> the port's: the two
    enums have the same values."""
    return SymmetryTransform(int(t))


def symmetry_from_jax(sym):
    """A JAX ``StaticSymmetry`` (or its int value) -> the port's."""
    return StaticSymmetry(int(sym))


def target_from_jax(target, device=None):
    """A JAX ``LifeTarget`` (or any object with packed ``wanted`` and
    ``unwanted``) -> the port's :class:`LifeTarget`."""
    return LifeTarget(
        board_from_packed(target.wanted, device),
        board_from_packed(target.unwanted, device),
    )


def dense_mask(mask, device=None):
    """A dense ``bool[64, 64]`` mask indexed ``[x, y]`` as a torch tensor."""
    return torch.from_numpy(np.array(mask, dtype=bool)).to(resolve(device))


def problem_from_jax(problem, device=None):
    """A JAX ``MPCProblem`` (initial, target, horizon, control_mask,
    protected, background, weights, tau) -> the port's
    :class:`~lifeapi_tpu_torch.mpc.solver.MPCProblem` on ``device``."""
    return MPCProblem(
        initial=board_from_packed(problem.initial, device),
        target=target_from_jax(problem.target, device),
        horizon=int(problem.horizon),
        control_mask=dense_mask(problem.control_mask, device),
        protected=(None if problem.protected is None
                   else dense_mask(problem.protected, device)),
        background=(None if problem.background is None
                    else board_from_packed(problem.background, device)),
        weights=CostWeights(*(float(w) for w in problem.weights)),
        tau=float(problem.tau),
    )


def solution_to_numpy(solution):
    """Port ``MPCSolution`` -> dict of numpy arrays in the JAX layouts."""
    return {
        "controls": board_to_packed(solution.controls),
        "control_probs": solution.control_probs.detach().cpu().numpy(),
        "final_board": board_to_packed(solution.final_board),
        "cost": solution.cost.detach().cpu().numpy(),
        "all_costs": solution.all_costs.detach().cpu().numpy(),
    }


def mpc_run_to_numpy(run):
    """Port ``MPCRun`` -> dict of numpy arrays in the JAX layouts: packed
    ``boards`` ``uint32[steps + 1, 64, 2]`` and ``applied``
    ``uint32[steps, 64, 2]``, float32 ``costs``."""
    return {
        "boards": board_to_packed(run.boards),
        "applied": board_to_packed(run.applied),
        "costs": run.costs.detach().cpu().numpy(),
    }


def placement_to_numpy(result):
    """Port ``PlacementResult`` -> dict of numpy arrays in the JAX layouts."""
    return {
        "offsets": result.offsets.cpu().numpy(),
        "interacted": result.interacted.cpu().numpy(),
        "recovered": result.recovered.cpu().numpy(),
        "reaction_changed": result.reaction_changed.cpu().numpy(),
        "final": board_to_packed(result.final),
    }


def bitstable_from_jax(bst, device=None):
    """A JAX ``BitStable`` (packed ``uint32[..., 64, 2]`` state, unknown and
    8 ruled planes) -> the port's :class:`~lifeapi_tpu_torch.stable.bitplane.
    BitStable` of ``int64[..., 64]`` planes."""
    return BitStable(board_from_packed(bst.state, device),
                     board_from_packed(bst.unknown, device),
                     tuple(board_from_packed(r, device) for r in bst.ruled))


def bitstable_to_jax(bst):
    """Port ``BitStable`` -> ``(state, unknown, ruled)`` packed numpy planes;
    ``lifeapi_tpu.stable.bitplane.BitStable(*out)`` rebuilds the JAX one."""
    return (board_to_packed(bst.state), board_to_packed(bst.unknown),
            tuple(board_to_packed(r) for r in bst.ruled))


def stable_from_jax(st, device=None):
    """A JAX dense ``Stable`` (bool state and unknown, uint8 ruled, all
    ``[..., 64, 64]`` indexed ``[x, y]``) -> the port's
    :class:`~lifeapi_tpu_torch.stable.propagate.Stable`."""
    device = resolve(device)
    return Stable(dense_mask(st.state, device), dense_mask(st.unknown, device),
                  torch.from_numpy(np.array(st.ruled, dtype=np.uint8)).to(device))


def beam_result_to_numpy(result):
    """Port ``BeamResult`` -> dict of numpy arrays in the JAX layouts:
    ``best`` stays dense ``bool[B, 64, 64]`` or becomes packed
    ``uint32[B, 64, 2]`` (from ``dense=False``), or None."""
    best = result.best
    if best is not None:
        best = (best.cpu().numpy() if best.dtype == torch.bool
                else board_to_packed(best))
    return {
        "found": result.found.cpu().numpy(),
        "best": best,
        "best_pop": result.best_pop.cpu().numpy(),
        "proved_inconsistent": result.proved_inconsistent.cpu().numpy(),
    }


def lifestable_from_jax(ls, device=None):
    """A JAX ``LifeStable`` (over a dense ``Stable``) -> the port's."""
    return LifeStable(stable_from_jax(ls.data, device))


def portfolio_result_to_numpy(result):
    """Port ``PortfolioResult`` -> dict in the JAX layouts: ``best`` a packed
    ``uint32[64, 2]`` board."""
    return {"found": bool(result.found), "best": board_to_packed(result.best),
            "best_pop": int(result.best_pop),
            "found_fraction": float(result.found_fraction)}


def weld_from_jax(weld, device=None):
    """A JAX ``LifeWeld`` (state and three frozen count planes, packed) ->
    the port's :class:`~lifeapi_tpu_torch.weld.LifeWeld`."""
    return LifeWeld(*(board_from_packed(p, device) for p in weld))


def weld_to_jax(weld):
    """Port ``LifeWeld`` -> its four packed numpy planes;
    ``lifeapi_tpu.weld.LifeWeld(*out)`` rebuilds the JAX one."""
    return tuple(board_to_packed(p) for p in weld)


def lohi_from_jax(lo, hi, device=None):
    """The JAX rollout kernels' ``uint32[64, B]`` half-word arrays -> the
    port's ``int32[64, B]`` tensors with the same bit patterns."""
    def one(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
        if a.ndim != 2 or a.shape[0] != 64:
            raise ValueError(f"expected uint32[64, B], got {a.shape}")
        return torch.from_numpy(a.view(np.int32).copy()).to(device)

    device = resolve(device)
    return one(lo), one(hi)


def lohi_to_jax(lo, hi):
    """Inverse of :func:`lohi_from_jax`: numpy ``uint32[64, B]`` pairs."""
    return tuple(t.detach().cpu().contiguous().numpy().view(np.uint32) for t in (lo, hi))
