"""The port's symmetry layer (``lifeapi_tpu_torch.symmetry``) against
:mod:`lifeapi_tpu.symmetry`, exact: transforms, groups, lattice maps,
hashes and fingerprints, orbits, symmetrization and the offset algebra."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lifeapi_tpu.core import board as jb
from lifeapi_tpu.symmetry import groups as jgroups
from lifeapi_tpu.symmetry import lattice as jlattice
from lifeapi_tpu.symmetry import offsets as joffsets
from lifeapi_tpu.symmetry import orbits as jorbits
from lifeapi_tpu.symmetry import transforms as jtr
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch.core import board as tb
from lifeapi_tpu_torch.symmetry import groups, lattice, offsets, orbits, transforms
from lifeapi_tpu_torch.symmetry.groups import StaticSymmetry as S
from lifeapi_tpu_torch.symmetry.transforms import SymmetryTransform as T
from oracle import random_dense
from torch_threads import one_torch_thread  # noqa: F401


def _pair(dense):
    packed = jb.from_dense(jnp.asarray(dense))
    return packed, convert.board_from_packed(packed, device="cpu")


def _same(got, expect):
    assert np.array_equal(convert.board_to_packed(got), np.asarray(expect))


def _compact(rng):
    """A random pattern inside a 25 x 25 box, so its bounds never straddle
    the seam, with one cell forced ON."""
    d = random_dense(rng, p=0.1)
    d[:, 25:] = False
    d[25:, :] = False
    d[2, 3] = True
    return d


def test_enums_have_the_jax_values():
    assert [(t.name, int(t)) for t in T] == [(t.name, int(t)) for t in jtr.SymmetryTransform]
    assert [(s.name, int(s)) for s in S] == [(s.name, int(s)) for s in jgroups.StaticSymmetry]
    for s in S:
        assert [int(t) for t in groups.GROUPS[s]] == [int(t) for t in jgroups.GROUPS[s]]
        assert [int(t) for t in groups.CHAINS[s]] == [int(t) for t in jgroups.CHAINS[s]]
        assert groups.symmetry_to_string(s) == jgroups.symmetry_to_string(int(s))
        assert convert.symmetry_from_jax(jgroups.StaticSymmetry(int(s))) is s
    for t in T:
        assert int(transforms.transform_inverse(t)) == int(jtr.transform_inverse(int(t)))
        assert convert.transform_from_jax(jtr.SymmetryTransform(int(t))) is t
        for vec in ((3, -5), (0, 7)):
            assert transforms.commute_translation(t, vec) == jtr.commute_translation(int(t), vec)


@pytest.mark.parametrize("t", list(T))
def test_transform_matches_jax(rng, t):
    jp, tp = _pair(random_dense(rng, p=0.3, batch=(3,)))
    _same(transforms.transform(tp, t), jtr.transform(jp, int(t)))
    _same(transforms.transform_moved(tp, 5, -9, t), jtr.transform_moved(jp, 5, -9, int(t)))
    d = torch.from_numpy(random_dense(rng, p=0.3))
    assert np.array_equal(transforms.transform_dense(d, t).numpy(),
                          np.asarray(jtr.transform_dense(jnp.asarray(d.numpy()), int(t))))


def test_groups_and_names():
    for s in S:
        _same(groups.fundamental_domain(s, device="cpu"), jgroups.fundamental_domain(int(s)))
        assert groups.symmetry_from_string(groups.symmetry_to_string(s)) == s
    for name in ("garbage", "D4_+2", "C2_2", "D4x", "D2/odd", "D8_4"):
        assert int(groups.symmetry_from_string(name)) == int(jgroups.symmetry_from_string(name))
    for ch in ".|-\\/+@x*?":
        assert [int(t) for t in groups.char_to_transforms(ch)] == \
            [int(t) for t in jgroups.char_to_transforms(ch)]


@pytest.mark.parametrize("name", ["halve_x", "halve_y", "halve", "skew", "inv_skew"])
def test_lattice_matches_jax(rng, name):
    jp, tp = _pair(random_dense(rng, p=0.3, batch=(2,)))
    _same(getattr(lattice, name)(tp), getattr(jlattice, name)(jp))


def test_hashes_match_jax(rng):
    jp, tp = _pair(_compact(rng))
    assert orbits.board_hash(tp) == jorbits.board_hash(jp)
    assert orbits.octo_hash(tp) == jorbits.octo_hash(jp)
    assert orbits.canonical_hash(tp) == jorbits.canonical_hash(jp)
    assert orbits.octo_hash(tb.move(tp, 3, 5)) == orbits.octo_hash(tp)
    for t in (T.Rotate90, T.ReflectAcrossYeqX, T.ReflectAcrossXEven):
        assert orbits.canonical_hash(transforms.transform(tp, t)) == orbits.canonical_hash(tp)
    # tied maximal gaps: still translation invariant, and equal to JAX
    cells = [(0, 5), (21, 5), (22, 5), (43, 5), (0, 6)]
    base = tb.from_cells(cells, device="cpu")
    assert orbits.octo_hash(base) == jorbits.octo_hash(jb.from_cells(cells))
    assert orbits.canonical_hash(tb.move(base, 22, 11)) == orbits.canonical_hash(base)


def test_fingerprint_matches_jax(rng):
    dense = random_dense(rng, p=0.4, batch=(32,))
    dense[0] = True  # every word all ones: the largest products
    jp, tp = _pair(dense)
    ja, jb_ = jorbits.fingerprint(jp)
    ta, tb_ = orbits.fingerprint(tp)
    assert ta.dtype == tb_.dtype == torch.int64
    assert np.array_equal(ta.numpy(), np.asarray(ja).astype(np.int64))
    assert np.array_equal(tb_.numpy(), np.asarray(jb_).astype(np.int64))
    assert len(set(zip(ta.tolist(), tb_.tolist()))) == 32


@pytest.mark.parametrize("cells", [
    [(1, 0), (1, 1), (1, 2)],  # blinker: 2 images
    [(0, 0), (0, 1), (1, 0), (1, 1)],  # block: 1
    [(1, 0), (2, 1), (0, 2), (1, 2), (2, 2)],  # glider phase: 8
    [(24, 21), (24, 22), (25, 21), (25, 23), (26, 23), (27, 23), (27, 24)],  # eater
])
def test_orbits_match_jax(cells):
    jp, tp = jb.from_cells(cells), tb.from_cells(cells, device="cpu")
    got, expect = orbits.symmetry_orbit(tp), jorbits.symmetry_orbit(jp)
    assert len(got) == len(expect)
    for g, e in zip(got, expect):
        _same(g, e)
    assert [int(t) for t in orbits.symmetry_orbit_representatives(tp)] == \
        [int(t) for t in jorbits.symmetry_orbit_representatives(jp)]


def test_matches_live_and_dead_sym_matches_jax(rng):
    live = [(0, 0), (1, 0), (0, 1), (2, 1)]
    jl, tl = jb.from_cells(live), tb.from_cells(live, device="cpu")
    jd, td = jb.boundary(jl), tb.boundary(tl)
    jstate = jb.move(jl, 10, 10) | jb.move(jtr.transform(jl, 6), 40, 30)
    tstate = tb.move(tl, 10, 10) | tb.move(transforms.transform(tl, T.Rotate90), 40, 30)
    got = orbits.matches_live_and_dead_sym(tstate, tl, td)
    _same(got, jorbits.matches_live_and_dead_sym(jstate, jl, jd))
    assert torch.equal(got & tstate, tstate)


def test_offsets_match_jax():
    for s in (S.C2, S.C4, S.D4, S.D2AcrossX):
        for vec in ((3, 5), (60, 1), (7, 62)):
            assert offsets.halve_offset(s, vec) == joffsets.halve_offset(int(s), vec)
    for t in (T.ReflectAcrossX, T.ReflectAcrossY, T.ReflectAcrossYeqX,
              T.ReflectAcrossYeqNegXP1, T.Rotate90):
        for vec in ((2, 4), (9, 61)):
            assert offsets.perp_component(t, vec) == joffsets.perp_component(int(t), vec)
    jp, tp = jb.from_cells([(2, 3), (4, 3), (5, 9)]), tb.from_cells([(2, 3), (4, 3), (5, 9)], device="cpu")
    for s in (S.C1, S.C2, S.C4, S.D2AcrossX, S.D2AcrossY, S.D2diagodd, S.D2negdiagodd,
              S.D4, S.D4diag):
        for off in ((0, 0), (3, 5), (4, 60)):
            _same(offsets.symmetricize(tp, s, off), joffsets.symmetricize(jp, int(s), off))
    with pytest.raises(NotImplementedError):
        offsets.symmetricize(tp, S.D8)
    for s in S:
        _same(offsets.symmetricize_coset(tp, s), joffsets.symmetricize_coset(jp, int(s)))
    for s in (S.C2, S.C4, S.D2AcrossX, S.D2AcrossY, S.D2diagodd, S.D2negdiagodd):
        sym_t = offsets.symmetricize(tp, s, (2, 2))
        sym_j = joffsets.symmetricize(jp, int(s), (2, 2))
        _same(offsets.intersecting_offsets(tp, sym_t, s),
              joffsets.intersecting_offsets(jp, sym_j, int(s)))


def test_fundamental_domain_covers_board_under_symmetricize():
    """Reference tests/SymmetryTest.cpp:7-15, on the port alone."""
    for s, off in ((S.C4, (3, 7)), (S.D4diag, (5, 9)), (S.D2diagodd, (3, 61)), (S.C2, (0, 0))):
        domain = tb.move(groups.fundamental_domain(s, device="cpu"), *offsets.halve_offset(s, off))
        assert bool(tb.is_empty(~offsets.symmetricize(domain, s, off))), (s.name, off)
