"""Torus convolution kernels: hand-written CUDA and their plain PyTorch twins.

Counterpart of :mod:`lifeapi_tpu.ops.conv_sparse_pallas` (the runtime-sparse
peel: :func:`convolve_sparse_fused`, :func:`counts_sparse_fused`; and
:func:`union_sparse_fused`, the OR over pairs of their peels, which the JAX
package's ``union_interacting(method="sparse")`` builds around that kernel) and
:mod:`lifeapi_tpu.ops.conv_pallas` (dense counts: :func:`conv_counts_fused`,
:func:`conv_small_fused`, :func:`conv_small_packed`).  Boards are
``int64[..., 64]``, dense fields ``[B, 64, 64]`` indexed ``[x, y]``.  Each
entry dispatches on the device: a CUDA tensor launches its kernel in
``csrc/life_conv.cu`` on the current stream, a CPU tensor takes the plain
twin.  A CUDA tensor never falls back to the twin: anything the kernel does
not take raises.

The TPU's batch tiles, padding and interpret flags have no counterpart: the
kernels take any batch.  The dense counts are a number-theoretic transform
on the tensor cores, with the primes, twiddles and CRT inverse of
:mod:`..core.ntt`, which the plain twins compute as well; on packed boards
the kernel expands the bits and packs the mask on chip.  The single-prime
kernels compute the counts mod 193 (``conv_pallas``'s NTT is exact in that
ring), so their results here are the residues of the exact counts on every
input, in or out of the "< 193" contract.

``LAUNCHES`` counts kernel launches per entry point, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import bitops
from ..core import board as B
from ..core import ntt
from .._device import resolve
from . import _build
from ._descriptor import descriptor_words, plane_descriptor
from .stable_cuda import first_cell_mask
from .step_cuda import _aligned, _launch, _stream

LAUNCHES = {"convolve_sparse_fused": 0, "counts_sparse_fused": 0, "union_sparse_fused": 0,
            "conv_counts_fused": 0, "conv_small_fused": 0, "conv_small_packed": 0}

MAX_PLANES = 13  # counter planes of the peel kernel: every count <= 4096 fits
MAX_PAIRS = 8  # pairs of one union_sparse_fused launch
MODULUS = ntt.PRIMES[0]  # the prime of conv_pallas's single-prime kernels


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_boards(name, t):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.shape[-1:] != (64,):
        raise TypeError(f"{name}: expected int64[..., 64] boards")


def _broadcast_pair(a, b):
    """Broadcast two boards to one shape; return (shape, a, b) with a and b
    contiguous ``int64[n, 64]`` on one device."""
    _check_boards("a", a)
    _check_boards("b", b)
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape).reshape(-1, 64).contiguous()
    b = b.expand(shape).reshape(-1, 64).contiguous()
    if not 0 < a.shape[0] < 2**31 // 64:
        raise ValueError(f"batch {a.shape[0]} out of range")
    return shape, a, b


# ---------------------------------------------------------------------------
# The peel (replaces conv_sparse_pallas.conv_sparse_lohi / counts_sparse_lohi)
# ---------------------------------------------------------------------------


def _peeled_copies(a, b):
    """Yield, once per round, ``a`` translated by the first ON cell of
    each board's remaining ``b`` (zero for boards already empty), peeling
    that cell; ends when every ``b`` is empty."""
    rem = b
    while bool((rem != 0).any()):
        cell = first_cell_mask(rem)
        live = (cell != 0).any(dim=-1)
        x = torch.argmax((cell != 0).to(torch.uint8), dim=-1)
        y = bitops.popcount64(torch.gather(cell, -1, x[..., None])[..., 0] - 1)
        rem = rem ^ cell
        yield torch.where(live[..., None], B.move_dyn(a, x, y), 0)


def convolve_sparse_fused_plain(a, b):
    """OR of ``a`` translated by every ON cell of ``b``, peeled one cell a
    round (``core.convolve.convolve_sparse_device`` of the JAX package)."""
    shape, a, b = _broadcast_pair(a, b)
    acc = torch.zeros_like(a)
    for shifted in _peeled_copies(a, b):
        acc |= shifted
    return acc.reshape(shape)


def counts_sparse_fused_plain(a, b, n_planes=6):
    """The peel with each shifted copy ripple-added into ``n_planes``
    bit-sliced counter planes: plane i holds bit i of each count, so the
    planes hold the counts mod 2**n_planes."""
    shape, a, b = _broadcast_pair(a, b)
    planes = [torch.zeros_like(a) for _ in range(n_planes)]
    for carry in _peeled_copies(a, b):
        for i, p in enumerate(planes):
            planes[i], carry = p ^ carry, p & carry
    return [p.reshape(shape) for p in planes]


def convolve_sparse_fused(a, b):
    """OR-convolution with the runtime-sparse operand ``b``: ``a`` and ``b``
    broadcastable ``int64[..., 64]`` -> ``int64[..., 64]``.  The cost is one
    round per ON cell of each board's ``b``."""
    shape, a, b = _broadcast_pair(a, b)
    if not a.is_cuda:
        return convolve_sparse_fused_plain(a, b).reshape(shape)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        _launch(_build.library().life_conv_sparse, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), a.shape[0], _stream(a.device))
    LAUNCHES["convolve_sparse_fused"] += 1
    return out.reshape(shape)


def counts_sparse_fused(a, b, n_planes=6):
    """Convolution counts with the runtime-sparse operand ``b`` as
    ``n_planes`` (1-13) counter planes ``int64[..., 64]``: bit i of the count
    of cell (x, y) is cell (x, y) of plane i, so the counts are exact below
    ``2**n_planes`` and wrap above it."""
    n_planes = int(n_planes)
    if not 1 <= n_planes <= MAX_PLANES:
        raise ValueError(f"n_planes {n_planes} not in [1, {MAX_PLANES}]")
    shape, a, b = _broadcast_pair(a, b)
    if not a.is_cuda:
        return [p.reshape(shape) for p in counts_sparse_fused_plain(a, b, n_planes)]
    out = torch.empty((n_planes, *a.shape), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        _launch(_build.library().life_counts_sparse, a.data_ptr(), b.data_ptr(),
                out.data_ptr(), a.shape[0], n_planes, _stream(a.device))
    LAUNCHES["counts_sparse_fused"] += 1
    return [p.reshape(shape) for p in out]


def _union_operands(pairs):
    """Check 1-8 (left, right) pairs of broadcastable ``int64[..., 64]``
    boards on one device; return (the broadcast shape, every left and right
    in turn expanded to it)."""
    pairs = [tuple(p) for p in pairs]
    if not 1 <= len(pairs) <= MAX_PAIRS or any(len(p) != 2 for p in pairs):
        raise ValueError(f"expected 1 to {MAX_PAIRS} (left, right) pairs")
    operands = [t for p in pairs for t in p]
    for t in operands:
        _check_boards("pair operand", t)
    if len({t.device for t in operands}) != 1:
        raise ValueError("the pairs' boards lie on more than one device")
    shape = torch.broadcast_shapes(*(t.shape for t in operands))
    n = shape[:-1].numel()
    if not 0 < n < 2**31 // 64:
        raise ValueError(f"batch {n} out of range")
    return shape, [t.expand(shape) for t in operands]


def union_sparse_fused_plain(pairs):
    """The OR over (left, right) pairs of their OR-convolutions, each board
    peeling its smaller side (the JAX package's ``union_interacting`` with
    ``method="sparse"``, per-lane swap and all)."""
    shape, operands = _union_operands(pairs)
    flat = [t.reshape(-1, 64) for t in operands]
    out = torch.zeros_like(flat[0])
    for left, right in zip(flat[::2], flat[1::2]):
        swap = (B.population(left) < B.population(right))[:, None]
        peel, other = torch.where(swap, left, right), torch.where(swap, right, left)
        for shifted in _peeled_copies(other, peel):
            out |= shifted
    return out.reshape(shape)


def union_sparse_fused(pairs):
    """OR over 1-8 (left, right) pairs of broadcastable ``int64[..., 64]``
    boards of their OR-convolutions -> ``int64[..., 64]`` of the broadcast
    shape.  On the card one launch: every operand is read where it lies, as
    a pointer and a board stride (0 for a broadcast one, such as an
    unbatched mask against a batch; an operand whose batch does not flatten
    to one stride is copied), each query peels the smaller side of each
    pair, and nothing is stacked or read back."""
    shape, operands = _union_operands(pairs)
    if not operands[0].is_cuda:
        return union_sparse_fused_plain(pairs)
    pointers, strides, copies = plane_descriptor(operands)  # copies live past the launch
    out = torch.empty((shape[:-1].numel(), 64), dtype=torch.int64, device=operands[0].device)
    with torch.cuda.device(out.device):
        _launch(_build.library().life_union_sparse, descriptor_words(pointers, strides),
                len(operands) // 2, out.data_ptr(), out.shape[0], _stream(out.device))
    LAUNCHES["union_sparse_fused"] += 1
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# Dense counts (replaces conv_pallas.conv_counts_fused, conv_small_fused and
# conv_small_packed: a tensor-core NTT)
# ---------------------------------------------------------------------------


def _dense_pair(da, db):
    """Check two dense ``[B, 64, 64]`` 0/1 fields (bool or 8-bit); return
    them as contiguous bytes."""
    for name, d in (("da", da), ("db", db)):
        if not isinstance(d, torch.Tensor) or d.dtype not in (torch.bool, torch.uint8,
                                                              torch.int8):
            raise TypeError(f"{name}: expected a bool or 8-bit [B, 64, 64] field")
        if d.dim() != 3 or d.shape[1:] != (64, 64):
            raise ValueError(f"{name}: expected shape [B, 64, 64], got {tuple(d.shape)}")
    if da.shape != db.shape or da.device != db.device:
        raise ValueError("da and db must have one shape and one device")
    if not 0 < da.shape[0] < 2**31:
        raise ValueError(f"batch {da.shape[0]} out of range")
    return da.contiguous().view(torch.uint8), db.contiguous().view(torch.uint8)


_TWIDDLES = {}


def _twiddles(device):
    """W and V of each prime of :mod:`..core.ntt` as ``bfloat16[4, 64, 64]``
    on ``device`` (exact: every entry is below 257), built once a device."""
    if device not in _TWIDDLES:
        mats = [ntt.matrix(p, inverse, device) for p in ntt.PRIMES for inverse in (False, True)]
        _TWIDDLES[device] = torch.stack(mats).to(torch.bfloat16)
    return _TWIDDLES[device]


def _packed_pair(pa, pb):
    for name, p in (("pa", pa), ("pb", pb)):
        if not isinstance(p, torch.Tensor) or p.dtype != torch.int64:
            raise TypeError(f"{name}: expected int64[B, 64] boards")
        if p.dim() != 2 or p.shape[1] != 64:
            raise ValueError(f"{name}: expected shape [B, 64], got {tuple(p.shape)}")
    if pa.shape != pb.shape or pa.device != pb.device:
        raise ValueError("pa and pb must have one shape and one device")
    if not 0 < pa.shape[0] < 2**31:
        raise ValueError(f"batch {pa.shape[0]} out of range")
    return pa.contiguous(), pb.contiguous()


def packed_counts_plain(pa, pb):
    """Exact circular-convolution counts ``int32[..., 64, 64]`` of boards
    ``int64[..., 64]``, by bit-parallel popcounts
    ``count[x][y] = sum_u popcount(a[u] & rotl(rev(b[x - u]), y + 1))``: an
    algorithm independent of the NTT, which the tests hold the twins to."""
    # rot[..., c, y] = rotl(rev(b[c]), y + 1)
    k = torch.remainder(torch.arange(1, 65, device=pb.device), 64)
    rot = bitops.rotl64(bitops.reverse64(pb)[..., :, None], k)
    counts = torch.zeros(rot.shape, dtype=torch.int64, device=pa.device)
    for u in range(64):
        # torch.roll by u along c: row x holds rev(b[x - u])
        counts += bitops.popcount64(pa[..., u, None, None] & torch.roll(rot, u, dims=-2))
    return counts.to(torch.int32)


def conv_counts_fused_plain(da, db):
    """The two-prime NTT with its CRT (:func:`..core.ntt.counts`)."""
    return ntt.counts(da != 0, db != 0).to(torch.int32)


def conv_small_fused_plain(da, db, out_or=True):
    """The single-prime NTT mod 193 (:func:`..core.ntt.residues`)."""
    residue = ntt.residues(da != 0, db != 0, MODULUS).to(torch.int32)
    return (residue != 0).to(torch.int8) if out_or else residue


def conv_small_packed_plain(pa, pb):
    """The single-prime NTT mod 193 of the boards' cells, ``!= 0``, packed."""
    return B.from_dense(ntt.residues(B.to_dense(pa), B.to_dense(pb), MODULUS) != 0)


def conv_counts_fused(da, db):
    """Exact circular-convolution counts of dense 0/1 fields ``[B, 64, 64]``
    (bool or 8-bit, non-zero = ON) -> ``int32[B, 64, 64]``, every count
    <= 4096."""
    da, db = _dense_pair(da, db)
    if not da.is_cuda:
        return conv_counts_fused_plain(da, db)
    da, db = _aligned(da), _aligned(db)
    out = torch.empty(da.shape, dtype=torch.int32, device=da.device)
    p1, p2 = ntt.PRIMES
    with torch.cuda.device(da.device):
        _launch(_build.library().life_conv_counts, da.data_ptr(), db.data_ptr(),
                _twiddles(da.device).data_ptr(), out.data_ptr(), da.shape[0], p1, p2,
                ntt.CRT_INVERSE, _stream(da.device))
    LAUNCHES["conv_counts_fused"] += 1
    return out


def conv_small_fused(da, db, out_or=True):
    """The counts mod 193 of dense 0/1 fields ``[B, 64, 64]``: with
    ``out_or`` an ``int8`` mask of ``count % 193 != 0`` (the OR-convolution
    whenever every count is below 193), else ``int32`` residues."""
    da, db = _dense_pair(da, db)
    out_or = bool(out_or)
    if not da.is_cuda:
        return conv_small_fused_plain(da, db, out_or)
    da, db = _aligned(da), _aligned(db)
    out = torch.empty(da.shape, dtype=torch.int8 if out_or else torch.int32,
                      device=da.device)
    with torch.cuda.device(da.device):
        _launch(_build.library().life_conv_small, da.data_ptr(), db.data_ptr(),
                _twiddles(da.device).data_ptr(), out.data_ptr(), da.shape[0], MODULUS,
                int(out_or), _stream(da.device))
    LAUNCHES["conv_small_fused"] += 1
    return out


def conv_small_packed(pa, pb):
    """:func:`conv_small_fused` with ``out_or`` on packed boards:
    ``int64[B, 64]`` in and out."""
    pa, pb = _packed_pair(pa, pb)
    if not pa.is_cuda:
        return conv_small_packed_plain(pa, pb)
    pa, pb = _aligned(pa), _aligned(pb)
    out = torch.empty_like(pa)
    with torch.cuda.device(pa.device):
        _launch(_build.library().life_conv_small_packed, pa.data_ptr(), pb.data_ptr(),
                _twiddles(pa.device).data_ptr(), out.data_ptr(), pa.shape[0], MODULUS,
                _stream(pa.device))
    LAUNCHES["conv_small_packed"] += 1
    return out


NTT_INSTANTIATIONS = ("ntt_conv_kernel<2, 0>", "ntt_conv_kernel<1, 1>",
                      "ntt_conv_kernel<1, 2>", "ntt_conv_kernel<1, 3>")


def ntt_kernel_info(device=None):
    """{instantiation: (resident blocks an SM, registers a thread, local
    bytes a thread)} of the NTT kernel on a CUDA ``device``, from the CUDA
    runtime's occupancy calculator and the kernels' attributes."""
    info = (ctypes.c_int * (3 * len(NTT_INSTANTIATIONS)))()
    with torch.cuda.device(resolve(device)):
        _launch(_build.library().life_conv_ntt_info, info)
    return {name: tuple(info[3 * k:3 * k + 3]) for k, name in enumerate(NTT_INSTANTIATIONS)}
