"""The port's one device rule (``lifeapi_tpu_torch._device.resolve``): every
public function that takes ``device`` builds on the CUDA card when given
none and no tensor, raises where there is no card, and builds on the CPU
when asked.  The file imports neither jax nor the JAX package, so it also
runs on the card:

    python -m pytest --noconftest tests/test_torch_device.py -q
"""

import importlib
import inspect
import pathlib
import pkgutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lifeapi_tpu_torch
from lifeapi_tpu_torch import _device, convert, graft_entry, history
from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.core import convolve, ntt, rle
from lifeapi_tpu_torch.examples import bellman_pipeline
from lifeapi_tpu_torch.native import build as native
from lifeapi_tpu_torch.ops import conv_cuda, stable_cuda
from lifeapi_tpu_torch.parallel import mesh
from lifeapi_tpu_torch.stable import api, bitplane, complete, propagate
from lifeapi_tpu_torch.state import LifeState
from lifeapi_tpu_torch.symmetry import groups
from lifeapi_tpu_torch.utils import checkpoint, prng, roofline

PORT = pathlib.Path(lifeapi_tpu_torch.__file__).resolve().parent
EATER = "2b2o$bobo$bo$2o!"


def _packed(n=()):
    """A JAX-layout packed board ``uint32[..., 64, 2]`` with a few cells."""
    a = np.zeros((*n, 64, 2), dtype=np.uint32)
    a[..., 3, 0] = 0b1011
    a[..., 40, 1] = 1 << 31
    return a


def _dense():
    d = np.zeros((64, 64), dtype=bool)
    d[20:24, 30:33] = True
    return d


_PROBLEM = SimpleNamespace(
    initial=_packed(), target=SimpleNamespace(wanted=_packed(), unwanted=_packed()),
    horizon=4, control_mask=_dense(), protected=_dense(), background=_packed(),
    weights=(1.0, 0.01, 0.0, 0.0), tau=1.0)
_STABLE = SimpleNamespace(state=_dense(), unknown=~_dense(),
                          ruled=np.zeros((64, 64), dtype=np.uint8))


def _rle_file(tmp_path):
    path = tmp_path / "b.rle"
    path.write_text(EATER + "\n")
    return path


def _checkpoint_file(tmp_path):
    path = tmp_path / "ckpt.pt"
    checkpoint.save(path, {"boards": B.cell_mask(1, 2, device="cpu")})
    return path


def _mesh_of(d):
    m = mesh.make_mesh(device=d)
    mesh.destroy()
    return m.device_type


def _group_of(d, tmp_path):
    mesh.initialize_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, device=d)
    backend = torch.distributed.get_backend()
    mesh.destroy()
    return "cuda" if backend == "nccl" else "cpu"


# name -> call(device, tmp_path): the public functions that take ``device``.
# Each is called with device=None and, unless in CARD_ONLY, with "cpu".
CASES = {
    "core.board:empty": lambda d, t: B.empty((2,), device=d),
    "core.board:full": lambda d, t: B.full(device=d),
    "core.board:random": lambda d, t: B.random(torch.Generator().manual_seed(1), (3,), device=d),
    "core.board:from_cells": lambda d, t: B.from_cells([(1, 2)], device=d),
    "core.board:cell_mask": lambda d, t: B.cell_mask(3, 4, device=d),
    "core.board:checkerboard": lambda d, t: B.checkerboard(device=d),
    "core.board:solid_rect": lambda d, t: B.solid_rect(1, 2, 3, 4, device=d),
    "core.board:solid_rect_xy": lambda d, t: B.solid_rect_xy(1, 2, 3, 4, device=d),
    "core.board:nzoi_around": lambda d, t: B.nzoi_around((10, 20), 3, device=d),
    "core.board:cell_zoi": lambda d, t: B.cell_zoi((10, 20), device=d),
    "core.rle:parse": lambda d, t: rle.parse(EATER, device=d),
    "core.convolve:default_corona": lambda d, t: convolve.default_corona(device=d),
    "core.ntt:matrix": lambda d, t: ntt.matrix(193, False, device=d),
    "history:LifeHistory.create": lambda d, t: history.LifeHistory.create(device=d),
    "history:parse": lambda d, t: history.parse("AB$2C!", device=d),
    "history:parse_bellman": lambda d, t: history.parse_bellman("C2E$bC3E$!", device=d),
    "symmetry.groups:fundamental_domain": lambda d, t: groups.fundamental_domain(
        groups.StaticSymmetry.D4, device=d),
    "stable.propagate:make": lambda d, t: propagate.make(batch=(2,), device=d),
    "stable.api:LifeStable.from_boards": lambda d, t: api.LifeStable.from_boards(device=d),
    "stable.bitplane:make": lambda d, t: bitplane.make(batch=(2,), device=d),
    "stable.complete:draw_offsets": lambda d, t: complete.draw_offsets(
        torch.Generator().manual_seed(9), 8, device=d),
    "native.build:from_packed64": lambda d, t: native.from_packed64(
        np.arange(64, dtype=np.uint64), device=d),
    "utils.prng:KeySequence.__init__": lambda d, t: prng.KeySequence(42, device=d)(),
    "utils.checkpoint:restore": lambda d, t: checkpoint.restore(_checkpoint_file(t), device=d),
    "utils.checkpoint:load_rle": lambda d, t: checkpoint.load_rle(_rle_file(t), device=d),
    "utils.roofline:step_lane_ops_per_board": lambda d, t: roofline.step_lane_ops_per_board(
        device=d),
    "utils.roofline:fixpoint_step_lane_ops_per_board":
        lambda d, t: roofline.fixpoint_step_lane_ops_per_board(device=d),
    "utils.roofline:simple_step_lane_ops_per_board":
        lambda d, t: roofline.simple_step_lane_ops_per_board(device=d),
    "utils.roofline:card_issue_peak": lambda d, t: roofline.card_issue_peak(device=d),
    "convert:board_from_packed": lambda d, t: convert.board_from_packed(_packed((2,)), device=d),
    "convert:planes_from_packed": lambda d, t: convert.planes_from_packed(
        [_packed(), _packed()], device=d),
    "convert:history_from_jax": lambda d, t: convert.history_from_jax(
        [_packed()] * 4, device=d),
    "convert:target_from_jax": lambda d, t: convert.target_from_jax(_PROBLEM.target, device=d),
    "convert:dense_mask": lambda d, t: convert.dense_mask(_dense(), device=d),
    "convert:problem_from_jax": lambda d, t: convert.problem_from_jax(_PROBLEM, device=d),
    "convert:bitstable_from_jax": lambda d, t: convert.bitstable_from_jax(
        SimpleNamespace(state=_packed(), unknown=_packed(), ruled=[_packed()] * 8), device=d),
    "convert:stable_from_jax": lambda d, t: convert.stable_from_jax(_STABLE, device=d),
    "convert:lifestable_from_jax": lambda d, t: convert.lifestable_from_jax(
        SimpleNamespace(data=_STABLE), device=d),
    "convert:weld_from_jax": lambda d, t: convert.weld_from_jax([_packed()] * 4, device=d),
    "convert:lohi_from_jax": lambda d, t: convert.lohi_from_jax(
        np.ones((64, 3), np.uint32), np.zeros((64, 3), np.uint32), device=d),
    "examples.bellman_pipeline:build": lambda d, t: bellman_pipeline.build(EATER, 1, 2, device=d),
    "graft_entry:flagship_problem": lambda d, t: graft_entry.flagship_problem(device=d),
    "graft_entry:entry": lambda d, t: graft_entry.entry(device=d),
    "graft_entry:dryrun_multichip": lambda d, t: graft_entry.dryrun_multichip(1, device=d),
    "parallel.mesh:make_mesh": lambda d, t: _mesh_of(d),
    "parallel.mesh:initialize_distributed": lambda d, t: _group_of(d, t),
    "ops.conv_cuda:ntt_kernel_info": lambda d, t: conv_cuda.ntt_kernel_info(device=d),
    "ops.stable_cuda:fixpoint_kernel_info": lambda d, t: stable_cuda.fixpoint_kernel_info(
        False, device=d),
    "ops.stable_cuda:beam_kernel_info": lambda d, t: stable_cuda.beam_kernel_info(4, device=d),
    "state:LifeState.__init__": lambda d, t: LifeState(device=d),
    "state:LifeState.parse": lambda d, t: LifeState.parse(EATER, 3, 4, device=d),
    "state:LifeState.cell": lambda d, t: LifeState.cell((3, 4), device=d),
    "state:LifeState.random": lambda d, t: LifeState.random(torch.Generator().manual_seed(1),
                                                            device=d),
    "state:LifeState.checkerboard": lambda d, t: LifeState.checkerboard(device=d),
    "state:LifeState.solid_rect": lambda d, t: LifeState.solid_rect(1, 2, 3, 4, device=d),
    "state:LifeState.solid_rect_xy": lambda d, t: LifeState.solid_rect_xy(1, 2, 3, 4, device=d),
    "state:LifeState.nzoi_around": lambda d, t: LifeState.nzoi_around((10, 20), 3, device=d),
    "state:LifeState.from_cells": lambda d, t: LifeState.from_cells([(1, 1)], device=d),
}

# Called only with no device: they read or launch on a card ("cpu" has no
# meaning for them), or make and destroy process groups.
CARD_ONLY = {
    "utils.roofline:card_issue_peak", "graft_entry:dryrun_multichip",
    "parallel.mesh:make_mesh", "parallel.mesh:initialize_distributed",
    "ops.conv_cuda:ntt_kernel_info", "ops.stable_cuda:fixpoint_kernel_info",
    "ops.stable_cuda:beam_kernel_info",
}

# Results that hold no tensor: a count of lane-ops.
NO_TENSOR = {
    "utils.roofline:step_lane_ops_per_board", "utils.roofline:fixpoint_step_lane_ops_per_board",
    "utils.roofline:simple_step_lane_ops_per_board",
}

# Public functions whose ``device`` has no default: a caller always names it.
DEVICE_REQUIRED = {
    "examples:Stages.__init__",
    "examples.bellman_pipeline:run", "examples.complete_still_life:run",
    "examples.eater_catches_glider:run", "examples.mpc_demo:problem", "examples.mpc_demo:run",
    "examples.portfolio_minimise:run", "examples.receding_mpc:problem",
    "examples.receding_mpc:run", "examples.sharded_portfolio_demo:instance",
    "examples.sharded_portfolio_demo:run", "examples.unweldable_prefilter:run",
}


def _devices(x):
    """The devices of every tensor (and generator) in a result."""
    if isinstance(x, (torch.Tensor, torch.Generator)):
        return {x.device.type}
    if isinstance(x, LifeState):
        return _devices(x.packed)
    if isinstance(x, api.LifeStable):
        return _devices(x.data)
    if isinstance(x, str):  # a mesh's device type
        return {x}
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return set().union(*map(_devices, x)) if x else set()
    if hasattr(x, "__dict__"):
        return _devices(list(vars(x).values()))
    return set()


def _public_device_functions():
    """``module:qualname`` of every public function and method of the port
    that takes a ``device`` parameter, with whether it has a default."""
    found = {}
    for info in pkgutil.walk_packages(lifeapi_tpu_torch.__path__, "lifeapi_tpu_torch."):
        if any(part.startswith("_") for part in info.name.split(".")):
            continue
        mod = importlib.import_module(info.name)
        short = info.name.removeprefix("lifeapi_tpu_torch.")
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            members = [(name, obj)] if inspect.isfunction(obj) else []
            if inspect.isclass(obj):
                members = [(f"{name}.{m}", inspect.unwrap(getattr(f, "__func__", f)))
                           for m, f in vars(obj).items()
                           if m == "__init__" or not m.startswith("_")]
            for qual, fn in members:
                if not inspect.isfunction(fn):
                    continue
                param = inspect.signature(fn).parameters.get("device")
                if param is not None:
                    found[f"{short}:{qual}"] = param.default is not inspect.Parameter.empty
    return found


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_device_means_the_card(name, tmp_path):
    """With no device, the call builds on the card; without a card it
    raises (naming device='cpu' where the CPU would do) rather than fall
    back to the CPU."""
    if torch.cuda.is_available():
        assert _devices(CASES[name](None, tmp_path)) <= {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="CUDA" if name in CARD_ONLY else "device='cpu'"):
            CASES[name](None, tmp_path)


@pytest.mark.parametrize("name", sorted(set(CASES) - CARD_ONLY))
def test_cpu_when_asked(name, tmp_path):
    assert _devices(CASES[name]("cpu", tmp_path)) == (set() if name in NO_TENSOR else {"cpu"})


def test_lifestable_with_no_data_builds_on_the_card():
    if torch.cuda.is_available():
        assert _devices(api.LifeStable()) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.LifeStable()


def test_every_function_that_takes_device_is_covered():
    """A new public function with a ``device`` parameter must join CASES
    (or, with no default, DEVICE_REQUIRED)."""
    found = _public_device_functions()
    assert {n for n, has_default in found.items() if has_default} == set(CASES)
    assert {n for n, has_default in found.items() if not has_default} == DEVICE_REQUIRED


def test_one_resolver():
    """No module but ``_device.py`` decides the default device itself."""
    copies = [p.relative_to(PORT).as_posix() for p in sorted(PORT.rglob("*.py"))
              if p.name != "_device.py" and '"cuda" if device is None' in p.read_text()]
    assert copies == []


_CPU_BOARD = B.cell_mask(5, 6, device="cpu")


@pytest.mark.parametrize("build", [
    lambda d: propagate.make(state=_CPU_BOARD, device=d),
    lambda d: propagate.make(state=_CPU_BOARD, unknown=B.zoi(_CPU_BOARD), device=d),
    lambda d: bitplane.make(state=_CPU_BOARD, device=d),
    lambda d: bitplane.make(unknown=_CPU_BOARD, device=d),
    lambda d: api.LifeStable.from_boards(state=_CPU_BOARD, device=d),
    lambda d: history.LifeHistory.create(state=_CPU_BOARD, device=d),
    lambda d: LifeState(_CPU_BOARD, device=d),
], ids=["propagate", "propagate_both", "bitplane", "bitplane_unknown", "from_boards",
        "history", "lifestate"])
def test_named_device_moves_given_tensors(build):
    """A named device wins over the given tensors' device; with none the
    result stays on the tensors' device.  The named device is the card
    where there is one, else "meta", which needs no card."""
    elsewhere = "cuda" if torch.cuda.is_available() else "meta"
    assert _devices(build(elsewhere)) == {elsewhere}
    assert _devices(build(None)) == {"cpu"}


def test_placements_take_their_tensors_device():
    dx = torch.tensor([0, 1, 2])
    assert _devices(bellman_pipeline.build(EATER, dx, dx)) == {"cpu"}


@pytest.mark.parametrize("device, like, want", [
    ("cpu", (), "cpu"),
    ("meta", (_CPU_BOARD,), "meta"),
    (None, (None, 3, _CPU_BOARD), "cpu"),
    (None, (_CPU_BOARD.to("meta"), _CPU_BOARD), "meta"),
    (torch.device("cpu"), (), "cpu"),
])
def test_resolve(device, like, want):
    assert _device.resolve(device, like) == torch.device(want)


@pytest.mark.parametrize("device, like", [(None, ()), ("cuda", ()), (None, (None, 1))])
def test_resolve_refuses_a_missing_card(device, like, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve(device, like, who="the test builds")


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.5, 0.2])
def test_one_seed_one_draw_on_every_device(p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = B.random(torch.Generator().manual_seed(3), (256,), p=p)
    host = B.random(torch.Generator().manual_seed(3), (256,), p=p, device="cpu")
    assert card.device.type == "cuda" and torch.equal(card.cpu(), host)
