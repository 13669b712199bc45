"""The port's :class:`LifeState` against :class:`lifeapi_tpu.state.LifeState`:
every method, on the same boards, bit for bit; and the cases of
``tests/test_state.py``.

Inputs are numpy-seeded boards carried into both packages by ``convert``.
``LifeState.random`` draws from a ``torch.Generator`` where JAX draws from
a key, so it is held to its own determinism and density, not to JAX's bits.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lifeapi_tpu_torch
from lifeapi_tpu.core import board as jb
from lifeapi_tpu.state import LifeState as JState
from lifeapi_tpu.symmetry import SymmetryTransform as JT
from lifeapi_tpu.target import LifeTarget as JTarget
from lifeapi_tpu_torch import LifeState, convert
from lifeapi_tpu_torch.core import strips
from lifeapi_tpu_torch.symmetry import SymmetryTransform as T
from lifeapi_tpu_torch.target import LifeTarget
from oracle import random_dense
from torch_threads import one_torch_thread  # noqa: F401

GLIDER_RLE = "bob$2bo$3o!"
SPARSE_RLE = "bob$2bo$3o6$10b2o$10b2o8$20b3o!"  # glider, block, blinker


def _pair(packed):
    """(JAX state, port state) of the same packed uint32 board."""
    packed = np.asarray(packed)
    return JState(jnp.asarray(packed)), LifeState(convert.board_from_packed(packed, device="cpu"))


def _same(j, t):
    """Results of one method in both packages are equal."""
    if isinstance(t, LifeState):
        assert isinstance(j, JState)
        assert torch.equal(t.packed, convert.board_from_packed(np.asarray(j.packed), device="cpu"))
    elif isinstance(t, (list, tuple)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _same(a, b)
    elif isinstance(t, torch.Tensor):
        assert (t.numpy() == np.asarray(j)).all(), (t, j)
    else:
        assert int(t) == int(j)


@pytest.fixture(scope="module")
def states():
    rng = np.random.default_rng(5)
    sparse = jb.move(JState.parse(SPARSE_RLE).packed, 17, 9)
    dense = jb.from_dense(jnp.asarray(random_dense(rng, p=0.3)))
    return {"sparse": _pair(sparse), "dense": _pair(dense),
            "glider": _pair(JState.parse(GLIDER_RLE, 30, 30).packed)}


CONSTRUCTORS = [
    ("parse", (GLIDER_RLE,), {}),
    ("parse", (GLIDER_RLE, 5, -3), {}),
    ("parse", (GLIDER_RLE, 5, 7), {"transform": 3}),
    ("cell", ((3, 63),), {}),
    ("checkerboard", (), {}),
    ("solid_rect", (60, 2, 7, 3), {}),
    ("solid_rect_xy", (3, 4, 9, 12), {}),
    ("nzoi_around", ((10, 20), 3), {}),
    ("from_cells", ([(0, 0), (63, 63), (5, 9)],), {}),
]


@pytest.mark.parametrize("name,args,kwargs", CONSTRUCTORS)
def test_constructors(name, args, kwargs):
    jkw = {k: JT(v) for k, v in kwargs.items()}
    tkw = {k: T(v) for k, v in kwargs.items()}
    _same(getattr(JState, name)(*args, **jkw),
          getattr(LifeState, name)(*args, **tkw, device="cpu"))


def test_random_constructor_is_seeded():
    a = LifeState.random(torch.Generator().manual_seed(3), (4,), device="cpu")
    b = LifeState.random(torch.Generator().manual_seed(3), (4,), device="cpu")
    c = LifeState.random(torch.Generator().manual_seed(3), p=0.1, device="cpu")
    assert a.packed.shape == (4, 64)
    assert bool((a == b).all())
    assert 200 < int(c.population) < 620


def test_algebra_and_repr(states):
    (ja, ta), (jb_, tb_) = states["sparse"], states["dense"]
    for op in ("__and__", "__or__", "__xor__"):
        _same(getattr(ja, op)(jb_), getattr(ta, op)(tb_))
    _same(~ja, ~ta)
    _same(ja == ja, ta == ta)
    _same(ja == jb_, ta == tb_)
    assert repr(ta) == repr(ja)
    empty = LifeState(device="cpu")
    assert empty.packed.shape == (64,) and bool(empty.is_empty)


# name, arguments (("state", key) picks a state of the fixture, ("target",
# key) that state's default target)
METHODS = [
    ("get", (18, 11)), ("get", (0, 0)), ("set", (3, 4)), ("set", (18, 10, False)),
    ("erase", (18, 11)), ("get_safe", (-46, 75)),
    ("is_empty", None), ("population", None), ("first_on", ()),
    ("find_set_neighbour", ((19, 11),)), ("find_set_neighbour", ((0, 40),)),
    ("on_cells", ()), ("xy_bounds", ()), ("width_height", ()), ("populated_columns", ()),
    ("contains", (("state", "glider"),)), ("contains", (("state", "glider"), 3, -2)),
    ("contains", (("target", "glider"),)), ("contains", (("target", "glider"), 1, 1)),
    ("are_disjoint", (("state", "glider"),)), ("are_disjoint", (("state", "glider"), 9, 9)),
    ("moved", (7, -60)), ("flip_x", ()), ("flip_y", ()), ("transposed", ()),
    ("transposed", (False,)), ("mirrored", ()), ("transformed", (JT.Rotate90,)),
    ("transformed", (JT.ReflectAcrossYeqX,)), ("align_with", (("state", "glider"),)),
    ("halve", ()), ("skew", ()), ("inv_skew", ()),
    ("zoi", ()), ("zoi_hollow", ()), ("moore_zoi", ()), ("big_zoi", ()),
    ("get_boundary", ()), ("nzoi", (3,)), ("buffer_around", ((8, 6),)),
    ("stepped", ()), ("stepped", (5,)), ("stepped_alt", ()), ("step_for", ((18, 10),)),
    ("count_neighbours", ((18, 10),)), ("count_neighbours", ((40, 40),)),
    ("interaction_counts", ()), ("interaction_offsets", (("state", "glider"),)),
    ("convolve", (("state", "glider"),)), ("match_live", (("state", "glider"),)),
    ("match_live_and_dead", (("state", "glider"), ("state", "sparse"))),
    ("match", (("state", "glider"),)), ("match", (("target", "glider"),)),
    ("component_containing", ()), ("component_containing", (("state", "glider"),)),
    ("components", ()), ("get_strip", (18,)), ("get_strip", (0, 3)),
    ("get_patch", ((18, 10), 2)), ("set_patch", ((40, 40), 1, 0b101010101)),
    ("get_hash", ()), ("get_octo_hash", ()), ("symmetry_orbit", ()),
    ("symmetry_orbit_representatives", ()), ("rle", ()),
]


def _args(args, states, pick):
    out = []
    for a in args:
        if isinstance(a, tuple) and a and a[0] in ("state", "target"):
            j, t = states[a[1]]
            if a[0] == "target":
                j, t = JTarget.from_state(j.packed), LifeTarget.from_state(t.packed)
            out.append(pick(j, t))
        elif isinstance(a, JT):
            out.append(pick(a, T(int(a))))
        else:
            out.append(a)
    return out


@pytest.mark.parametrize("which", ["sparse", "glider"])
@pytest.mark.parametrize("name,args", METHODS, ids=lambda v: str(v)[:40])
def test_method_matches_jax(states, which, name, args):
    j, t = states[which]
    if args is None:  # a property
        _same(getattr(j, name), getattr(t, name))
        return
    jr = getattr(j, name)(*_args(args, states, lambda a, b: a))
    tr = getattr(t, name)(*_args(args, states, lambda a, b: b))
    if name == "symmetry_orbit_representatives":
        assert [int(x) for x in tr] == [int(x) for x in jr]
    elif name == "rle":
        assert tr == jr
    elif name == "get_strip":
        jr = np.asarray(jr)
        words = jr[..., 0].astype(np.uint64) | (jr[..., 1].astype(np.uint64) << np.uint64(32))
        assert (tr.numpy().view(np.uint64) == words).all()
    else:
        _same(jr, tr)


def test_dense_board_methods_match_jax(states):
    """The heavier methods on a random 30% board."""
    (j, t), (jg, tg) = states["dense"], states["glider"]
    for name, args in (("stepped", (3,)), ("zoi", ()), ("xy_bounds", ()),
                       ("convolve", None), ("match_live", None), ("get_hash", ())):
        if args is None:
            _same(getattr(j, name)(jg), getattr(t, name)(tg))
        else:
            _same(getattr(j, name)(*args), getattr(t, name)(*args))


def test_convolve_sparse_route(states):
    (j, t), (jg, tg) = states["sparse"], states["glider"]
    _same(j.convolve(jg, method="sparse"), t.convolve(tg, method="sparse"))


def test_set_strip_matches_jax(states):
    j, t = states["sparse"]
    value = np.arange(4, dtype=np.uint64) * np.uint64(0x0101010101010101)
    jv = np.stack([(value & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                   (value >> np.uint64(32)).astype(np.uint32)], axis=-1)
    _same(j.set_strip(17, jnp.asarray(jv)), t.set_strip(17, torch.from_numpy(value.view(np.int64))))


def test_print_grid_matches_jax(states):
    j, t = states["sparse"]
    out_j, out_t = io.StringIO(), io.StringIO()
    with redirect_stdout(out_j):
        j.print_grid()
    with redirect_stdout(out_t):
        t.print_grid()
    assert out_t.getvalue() == out_j.getvalue()


# -- tests/test_state.py, on the port --------------------------------------------


def test_wrapper_basic():
    g = LifeState.parse(GLIDER_RLE, device="cpu")
    assert int(g.population) == 5
    assert bool(g.stepped(4) == g.moved(1, 1))
    assert not bool(g.is_empty)
    assert bool((~g | g).is_empty) is False


def test_wrapper_transform_and_match():
    g = LifeState.parse(GLIDER_RLE, device="cpu")
    back = g.transformed(T.Rotate90).transformed(T.Rotate270)
    assert bool(back == g)
    assert bool(g.moved(7, 9).match(g).get(7, 9))


def test_count_neighbours():
    blk = LifeState.from_cells([(0, 0), (0, 1), (1, 0), (1, 1)], device="cpu")
    assert int(blk.count_neighbours((0, 0))) == 3
    assert int(blk.count_neighbours((2, 2))) == 1


def test_strips_roundtrip():
    g = LifeState.parse(GLIDER_RLE, device="cpu").moved(10, 10)
    assert g.get_strip(10).shape == (4,)
    cleared = g.set_strip(10, torch.zeros(4, dtype=torch.int64))
    # strip of width 4 at column 10 covers columns 9..12
    for x, y in g.on_cells():
        assert bool(cleared.get(x, y)) == (not 9 <= x <= 12)


def test_patch_roundtrip():
    g = LifeState.parse(GLIDER_RLE, device="cpu").moved(20, 20)
    restored = LifeState(device="cpu").set_patch((21, 21), 2, g.get_patch((21, 21), 2))
    assert bool(restored == g)


def test_strip_indices():
    covered = set()
    for s in strips.strip_indices((1 << 5) | (1 << 6) | (1 << 40)):
        assert 0 <= s <= 60
        covered.update(range(s, s + 4))
    assert {5, 6, 40} <= covered


# The generator of a default-device draw: the constructor raises before it
# draws where there is no card.
_DEFAULT = "cuda" if torch.cuda.is_available() else "cpu"


@pytest.mark.parametrize("build", [
    lambda d: LifeState(device=d),
    lambda d: LifeState.parse(GLIDER_RLE, device=d),
    lambda d: LifeState.cell((3, 4), device=d),
    lambda d: LifeState.random(torch.Generator(d or _DEFAULT).manual_seed(1), device=d),
    lambda d: LifeState.checkerboard(device=d),
    lambda d: LifeState.solid_rect(1, 2, 3, 4, device=d),
    lambda d: LifeState.solid_rect_xy(1, 2, 3, 4, device=d),
    lambda d: LifeState.nzoi_around((10, 20), 3, device=d),
    lambda d: LifeState.from_cells([(1, 1)], device=d),
], ids=["empty", "parse", "cell", "random", "checkerboard", "solid_rect",
        "solid_rect_xy", "nzoi_around", "from_cells"])
def test_constructors_default_to_cuda(build):
    """With no device a constructor builds on the card, and raises where
    there is none rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert build(None).packed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(None)
    assert build("cpu").packed.device.type == "cpu"


def test_package_root_exports():
    assert lifeapi_tpu_torch.LifeState is LifeState
    assert lifeapi_tpu_torch.strips is strips
