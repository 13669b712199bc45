"""The rollout kernels' step circuit, read from ``csrc/life_rollout.cu`` and
checked without a compiler or a card.

Every rollout kernel steps with ``life_step_pair`` (lane l on columns 2l and
2l + 1) and takes Rokicki's terms as the six explicit LOP3 of
``rokicki_lop3``; the catalyst kernel ORs its interaction term in as the two
LOP3 of ``interaction``.  Their truth tables and argument order are parsed
from the source and evaluated here: against Rokicki's expression on every
input, against B3/S23 on every 3x3 neighbourhood, and, in a numpy model of
a warp stepping the pair layout (a lane is a row of 32, ``__shfl_sync``
from lane l +- 1 is ``np.roll``), against the JAX package's
``catalyst_rollout_eo`` in interpret mode and the port's plain twin, bit for
bit."""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lifeapi_tpu.core import bitops as jbits
from lifeapi_tpu.ops import step_pallas as K
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.ops import _build, step_cuda
from lifeapi_tpu_torch.search import rollout_inputs
from torch_threads import one_torch_thread  # noqa: F401

SOURCE = (_build.CSRC / "life_rollout.cu").read_text()
ONE = np.uint64(1)
SIXTY_THREE = np.uint64(63)


def _circuit(name):
    """(parameters, [(output, lut, inputs)], result) of the device function
    ``name`` of the source, whose body must be LOP3 and nothing else:
    ``const u64 x = lop3<0x..>(a, b, c);`` lines and a ``return lop3<..>``."""
    m = re.search(r"__device__ __forceinline__ u64 " + name + r"\(([^)]*)\)\s*\{(.*?)\n\}",
                  SOURCE, re.S)
    assert m, f"{name} not found in life_rollout.cu"
    params = re.findall(r"u64 (\w+)", m.group(1))
    body = re.sub(r"//[^\n]*", "", m.group(2))
    statements = [s.strip() for s in body.split(";") if s.strip()]
    gates, result = [], None
    for s in statements:
        g = re.fullmatch(r"(?:const u64 (\w+) =|return) lop3<(0x[0-9a-f]+)>\((\w+), (\w+), (\w+)\)",
                         s)
        assert g, f"{name}: not an explicit LOP3: {s!r}"
        gate = (g.group(1), int(g.group(2), 16), g.group(3, 4, 5))
        if s.startswith("return"):
            result = gate
        else:
            gates.append(gate)
    assert result is not None and statements[-1].startswith("return")
    return params, gates, result


def lop3(lut, a, b, c):
    """PTX's lop3.b32 on numpy words: bit i of ``lut`` is the output where
    (a, b, c) = (i >> 2 & 1, i >> 1 & 1, i & 1), as a = 0xf0, b = 0xcc and
    c = 0xaa name it."""
    out = np.zeros_like(a)
    for i in range(8):
        if lut >> i & 1:
            out = out | ((a if i & 4 else ~a) & (b if i & 2 else ~b) & (c if i & 1 else ~c))
    return out


def evaluate(circuit, *args):
    params, gates, (_, lut, inputs) = circuit
    assert len(args) == len(params)
    env = dict(zip(params, args))
    for out, g_lut, g_inputs in gates:
        env[out] = lop3(g_lut, *(env[x] for x in g_inputs))
    return lop3(lut, *(env[x] for x in inputs))


ROKICKI = _circuit("rokicki_lop3")
INTERACTION = _circuit("interaction")


def rokicki(a, s0, s1, u0, u1, b0, b1):
    """Rokicki's next-state formula (LifeAPI.hpp:837-848) as the reference
    writes it."""
    ts0 = b0 ^ u0
    ts1 = (b0 & u0) | (ts0 & s0)
    return (b1 ^ u1 ^ ts1 ^ s1) & ((b1 | u1) ^ (ts1 | s1)) & ((ts0 ^ s0) | a)


def _bits(combos, width):
    """Each of ``width`` inputs as a column of 0/1 words over ``combos``."""
    return [np.array([(k >> (width - 1 - j)) & 1 for k in combos], dtype=np.uint64)
            for j in range(width)]


def test_rokicki_lop3_is_six_lop3_in_the_reference_argument_order():
    params, gates, result = ROKICKI
    assert params == ["a", "s0", "s1", "u0", "u1", "b0", "b1"]
    assert len(gates) + 1 == 6
    assert [lut for _, lut, _ in gates] + [result[1]] == [0x96, 0xE8, 0x16, 0x01, 0xCA, 0xE0]


def test_rokicki_lop3_equals_rokicki_on_all_128_inputs():
    args = _bits(range(128), 7)
    got = evaluate(ROKICKI, *args) & ONE
    want = rokicki(*args) & ONE
    assert np.array_equal(got, want)


def _two_bit_sum(cells):
    n = sum(cells)
    return np.uint64(n & 1), np.uint64(n >> 1)


def test_rokicki_lop3_is_b3s23_on_all_512_neighbourhoods():
    """(a, s0, s1) from the centre column (the cell and its two vertical
    neighbours), (u0, u1) and (b0, b1) the left and right columns' 3-sums,
    as life_step_pair forms them."""
    for cells in itertools.product((0, 1), repeat=9):
        left, centre, right = cells[0:3], cells[3:6], cells[6:9]
        a = np.uint64(centre[1])
        s0, s1 = np.uint64(centre[0] ^ centre[2]), np.uint64(centre[0] & centre[2])
        u0, u1 = _two_bit_sum(left)
        b0, b1 = _two_bit_sum(right)
        n = sum(cells) - centre[1]
        want = int(n == 3 or (centre[1] and n == 2))
        args = [np.array([x], dtype=np.uint64) for x in (a, s0, s1, u0, u1, b0, b1)]
        assert int(evaluate(ROKICKI, *args)[0] & ONE) == want, cells


def test_interaction_is_two_lop3_of_the_flag_term():
    params, gates, result = INTERACTION
    assert params == ["acc", "x", "base", "p", "z"]
    assert [lut for _, lut, _ in gates] + [result[1]] == [0x1E, 0xF8]
    acc, x, base, p, z = _bits(range(32), 5)
    got = evaluate(INTERACTION, acc, x, base, p, z) & ONE
    assert np.array_equal(got, (acc | ((x ^ (base | p)) & z)) & ONE)


def _rotl1(x):
    return (x << ONE) | (x >> SIXTY_THREE)


def _rotr1(x):
    return (x >> ONE) | (x << SIXTY_THREE)


def step_pair_model(even, odd):
    """life_step_pair on ``[B, 32]`` words: lane l's even and odd columns
    2l and 2l + 1.  The vertical sums as the source forms them, the
    shuffles from lane l - 1 and l + 1 as rolls over the lane axis, and
    Rokicki's terms through the source's LOP3."""
    we, ee, wo, eo = _rotl1(even), _rotr1(even), _rotl1(odd), _rotr1(odd)
    s0e, s1e, s0o, s1o = we ^ ee, we & ee, wo ^ eo, wo & eo
    c0e, c1e = s0e ^ even, (s0e & even) | s1e
    c0o, c1o = s0o ^ odd, (s0o & odd) | s1o
    u0, u1 = np.roll(c0o, 1, axis=-1), np.roll(c1o, 1, axis=-1)  # lane l - 1's odd
    b0, b1 = np.roll(c0e, -1, axis=-1), np.roll(c1e, -1, axis=-1)  # lane l + 1's even
    return (evaluate(ROKICKI, even, s0e, s1e, u0, u1, c0o, c1o),
            evaluate(ROKICKI, odd, s0o, s1o, c0e, c1e, b0, b1))


def catalyst_model(boards, placed, zoi, base):
    """The catalyst kernel's loop on numpy: ``[B, 64]`` words laid out as
    ``[B, 32, 2]`` (lane, even/odd), one accumulator a lane, the flag the
    OR over the warp's lanes (``__any_sync``)."""
    def pair(t):
        words = t.numpy().view(np.uint64).reshape(*t.shape[:-1], 32, 2)
        return words[..., 0], words[..., 1]

    even, odd = pair(boards)
    (pe, po), (ze, zo), (be, bo) = pair(placed), pair(zoi), pair(base)
    acc = np.zeros_like(even)
    for t in range(base.shape[0]):
        even, odd = step_pair_model(even, odd)
        acc = evaluate(INTERACTION, acc, even, be[t], pe, ze)
        acc = evaluate(INTERACTION, acc, odd, bo[t], po, zo)
    final = np.stack([even, odd], axis=-1).reshape(-1, 64).view(np.int64)
    return torch.from_numpy(final.copy()), torch.from_numpy((acc != 0).any(axis=1))


def _eo(packed):
    return jbits.interleave_split(*K.to_kernel_layout(packed))


def _from_eo(e, o):
    return np.asarray(K.from_kernel_layout(*jbits.interleave_merge(e, o)))


@pytest.mark.parametrize("horizon", [0, 1, 5, 16])
def test_pair_layout_catalyst_model_matches_pallas_and_twin(rng, horizon):
    """The model of the catalyst kernel's generation against JAX's
    catalyst_rollout_eo (interpret mode) and catalyst_rollout_plain on the
    glider x eater grid, final boards and flags exactly.  JAX's kernel
    cannot trace an empty horizon (its loop body indexes the baseline), so
    at T = 0 the model is held to the twin and to the semantics: the boards
    unchanged and no board interacted."""
    glider = tb.from_cells([(8, 10), (9, 8), (9, 10), (10, 9), (10, 10)], device="cpu")
    eater = tb.from_cells([(24, 21), (24, 22), (25, 21), (25, 23), (26, 23),
                           (27, 23), (27, 24)], device="cpu")
    offsets = torch.from_numpy(rng.integers(-16, 4, size=(128, 2)))
    inputs = rollout_inputs(glider, eater, offsets, horizon)
    final, interacted = catalyst_model(*inputs)

    plain_final, plain_interacted = step_cuda.catalyst_rollout_plain(*inputs)
    assert torch.equal(final, plain_final)
    assert torch.equal(interacted, plain_interacted)

    boards, placed, zoi, base = inputs
    if horizon == 0:
        assert not interacted.any() and torch.equal(final, boards)
        return
    bp = jnp.asarray(convert.board_to_packed(base))
    be, bo = jbits.interleave_split(bp[..., 0][:, :, None], bp[..., 1][:, :, None])
    planes = [_eo(jnp.asarray(convert.board_to_packed(x))) for x in (boards, placed, zoi)]
    fe, fo, ae, ao = K.catalyst_rollout_eo(
        be, bo, *planes[0], *planes[1], *planes[2], interpret=True)
    assert (convert.board_to_packed(final) == _from_eo(fe, fo)).all()
    assert (interacted.numpy() == np.asarray(jnp.any((ae | ao) != 0, axis=0))).all()
    if horizon == 16:
        assert 0 < int(interacted.sum()) < 128  # the grid holds both kinds
