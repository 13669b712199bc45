"""Fused multi-step Life rollouts: hand-written CUDA kernels and their plain
PyTorch twins.

Counterpart of :mod:`lifeapi_tpu.ops.step_pallas`.  Each entry point takes
boards as ``int64[B, 64]`` (one 64-bit word per column, bit y = cell y)
and dispatches on the device: a CUDA tensor launches the kernel in
``csrc/life_rollout.cu`` on the current stream, a CPU tensor takes the
plain twin.  A CUDA tensor never falls back to the twin: anything the
kernel does not take raises.

``rollout_lohi`` alone keeps the JAX kernels' half-word layout: the low
and high 32 bits of every column in two ``[64, B]`` arrays, held as
``torch.int32`` tensors with the words' bit patterns (torch's ``uint32``
lacks shifts and ``~`` on the CPU).

``LAUNCHES`` counts kernel launches per entry point, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import board as B
from ..core import step as S
from . import _build

LAUNCHES = {"rollout": 0, "controlled_rollout": 0, "catalyst_rollout": 0,
            "rollout_lohi": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, t, shape, dtype=torch.int64, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, the boards are on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _batch(boards):
    if not isinstance(boards, torch.Tensor) or boards.dim() != 2:
        raise ValueError("boards: expected int64[B, 64]")
    b = boards.shape[0]
    if not 0 < b < 2**31 // 64:
        raise ValueError(f"boards: batch {b} out of range")
    _check("boards", boards, (b, 64))
    return b


def _launch(fn, *args):
    """Call a C launcher; it returns the launch's cudaError_t."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with cudaError_t {err}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _aligned(t):
    """``t``, or a copy of it where its data does not start on 16 bytes (the
    kernel reads 16-byte chunks; an ``int64[B, 64]`` slice may start on 8)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# rollout (replaces step_pallas.rollout_eo)
# ---------------------------------------------------------------------------


def rollout_plain(boards, steps):
    """T generations of every board, in plain PyTorch."""
    return S.step_n(boards, steps)


def rollout(boards, steps):
    """Advance ``int64[B, 64]`` boards ``steps`` generations.  The kernel
    reads a lane's two adjacent columns as one 16-byte word, so boards whose
    data starts 8 bytes past 16 are copied first."""
    b = _batch(boards)
    steps = int(steps)
    if not 0 <= steps < 2**31:
        raise ValueError(f"steps {steps} out of range")
    if not boards.is_cuda:
        return rollout_plain(boards, steps)
    boards = _aligned(boards)
    out = torch.empty_like(boards)
    with torch.cuda.device(boards.device):
        _launch(_build.library().life_rollout, boards.data_ptr(),
                out.data_ptr(), b, steps, _stream(boards.device))
    LAUNCHES["rollout"] += 1
    return out


_KERNEL_INDEX = {"rollout": 0, "rollout_lohi": 1, "catalyst_rollout": 2}


def rollout_kernel_info(name):
    """How the current CUDA device runs the ``name`` kernel (``rollout``,
    ``rollout_lohi`` or ``catalyst_rollout``), 8 warps a block: (resident
    blocks an SM, from the runtime's occupancy calculator, registers a
    thread, local (spilled) bytes a thread)."""
    info = (ctypes.c_int * 3)()
    _launch(_build.library().life_rollout_info, _KERNEL_INDEX[name], info)
    return tuple(info)


# ---------------------------------------------------------------------------
# controlled rollout (replaces step_pallas.controlled_rollout_eo)
# ---------------------------------------------------------------------------


def controlled_rollout_plain(boards, toggles):
    """At each generation t: XOR ``toggles[t]``, then step."""
    for tog in toggles:
        boards = S.step(boards ^ tog)
    return boards


def controlled_rollout(boards, toggles):
    """``int64[B, 64]`` boards and generation-major toggles
    ``int64[T, B, 64]`` -> the boards after T controlled generations
    (bit-exact with :func:`lifeapi_tpu_torch.mpc.soft.hard_rollout`)."""
    b = _batch(boards)
    if not isinstance(toggles, torch.Tensor) or toggles.dim() != 3:
        raise ValueError("toggles: expected int64[T, B, 64]")
    steps = toggles.shape[0]
    _check("toggles", toggles, (steps, b, 64), device=boards.device)
    if not boards.is_cuda:
        return controlled_rollout_plain(boards, toggles)
    toggles = _aligned(toggles)
    out = torch.empty_like(boards)
    with torch.cuda.device(boards.device):
        _launch(_build.library().life_controlled_rollout, boards.data_ptr(),
                toggles.data_ptr(), out.data_ptr(), b, steps, _stream(boards.device))
    LAUNCHES["controlled_rollout"] += 1
    return out


# ---------------------------------------------------------------------------
# catalyst rollout (replaces step_pallas.catalyst_rollout_eo)
# ---------------------------------------------------------------------------


def catalyst_rollout_plain(boards, placed, placed_zoi, base_traj):
    """Step the placed boards; after step t + 1, a board has interacted
    once ``(board ^ (base_traj[t] | placed)) & placed_zoi`` is nonempty."""
    interacted = torch.zeros(boards.shape[0], dtype=torch.bool,
                             device=boards.device)
    for base in base_traj:
        boards = S.step(boards)
        interacted |= ~B.is_empty((boards ^ (base | placed)) & placed_zoi)
    return boards, interacted


def catalyst_rollout(boards, placed, placed_zoi, base_traj):
    """``int64[B, 64]`` boards, placed catalysts and their ZOIs, and the
    baseline reaction ``int64[T, 64]`` after each of T generations ->
    (final boards ``int64[B, 64]``, interacted ``bool[B]``).  The kernel
    reads a lane's two adjacent columns of each input as one 16-byte word,
    so an input whose data starts 8 bytes past 16 is copied first."""
    b = _batch(boards)
    _check("placed", placed, (b, 64), device=boards.device)
    _check("placed_zoi", placed_zoi, (b, 64), device=boards.device)
    if not isinstance(base_traj, torch.Tensor) or base_traj.dim() != 2:
        raise ValueError("base_traj: expected int64[T, 64]")
    steps = base_traj.shape[0]
    _check("base_traj", base_traj, (steps, 64), device=boards.device)
    if not boards.is_cuda:
        return catalyst_rollout_plain(boards, placed, placed_zoi, base_traj)
    boards, placed, placed_zoi, base_traj = map(_aligned, (boards, placed, placed_zoi,
                                                           base_traj))
    final = torch.empty_like(boards)
    interacted = torch.empty(b, dtype=torch.bool, device=boards.device)
    with torch.cuda.device(boards.device):
        _launch(_build.library().life_catalyst_rollout, boards.data_ptr(),
                placed.data_ptr(), placed_zoi.data_ptr(), base_traj.data_ptr(),
                final.data_ptr(), interacted.data_ptr(), b, steps,
                _stream(boards.device))
    LAUNCHES["catalyst_rollout"] += 1
    return final, interacted


# ---------------------------------------------------------------------------
# rollout on the half-word layout (replaces step_pallas.rollout_lohi)
# ---------------------------------------------------------------------------


def to_kernel_layout(boards):
    """``int64[B, 64]`` boards -> ``(lo, hi)``, each ``int32[64, B]``: the
    low and high 32 bits of column x of board b at ``[x, b]`` (JAX
    ``step_pallas.to_kernel_layout``)."""
    lo = (boards << 32) >> 32  # the low half, sign-extended
    hi = boards >> 32
    return lo.to(torch.int32).t().contiguous(), hi.to(torch.int32).t().contiguous()


def from_kernel_layout(lo, hi):
    """Inverse of :func:`to_kernel_layout`.  The low half is masked, since
    int32 -> int64 sign-extends."""
    words = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    return words.t().contiguous()


def rollout_lohi_plain(lo, hi, steps):
    """T generations on the half-word layout, in plain PyTorch: rebuild the
    64-bit words, step them, split them again."""
    return to_kernel_layout(S.step_n(from_kernel_layout(lo, hi), steps))


def rollout_lohi(lo, hi, steps):
    """Advance boards in the half-word layout ``steps`` generations:
    ``lo``/``hi`` are ``int32[64, B]`` for any B >= 1 (JAX
    ``step_pallas.rollout_lohi``, without its batch tile and padding).
    Returns the new ``(lo, hi)``."""
    if not isinstance(lo, torch.Tensor) or lo.dim() != 2 or lo.shape[0] != 64:
        raise ValueError("lo: expected int32[64, B]")
    b = lo.shape[1]
    if not 0 < b < 2**31 // 64:
        raise ValueError(f"lo: batch {b} out of range")
    _check("lo", lo, (64, b), dtype=torch.int32)
    _check("hi", hi, (64, b), dtype=torch.int32, device=lo.device)
    steps = int(steps)
    if not 0 <= steps < 2**31:
        raise ValueError(f"steps {steps} out of range")
    if not lo.is_cuda:
        return rollout_lohi_plain(lo, hi, steps)
    out_lo, out_hi = torch.empty_like(lo), torch.empty_like(hi)
    with torch.cuda.device(lo.device):
        _launch(_build.library().life_rollout_lohi, lo.data_ptr(), hi.data_ptr(),
                out_lo.data_ptr(), out_hi.data_ptr(), b, steps, _stream(lo.device))
    LAUNCHES["rollout_lohi"] += 1
    return out_lo, out_hi
