"""The port's CUDA rollout kernels against their plain PyTorch twins, on the
card.  Every test skips without CUDA.  The file imports neither jax nor
the JAX package, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q
"""

import pytest
import torch

from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.ops import step_cuda
from lifeapi_tpu_torch.search import rollout_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_boards(gen, b, p, device):
    return B.from_dense(torch.rand((b, 64, 64), generator=gen) < p).to(device)


def _rollout_case(gen, device):
    boards = _random_boards(gen, 1000, 0.35, device)
    return "rollout", (boards, 37), step_cuda.rollout_plain


def _controlled_case(gen, device):
    boards = _random_boards(gen, 77, 0.3, device)
    toggles = _random_boards(gen, 9 * 77, 0.02, device).view(9, 77, 64)
    return "controlled_rollout", (boards, toggles), step_cuda.controlled_rollout_plain


def _catalyst_case(gen, device):
    glider = B.from_cells([(8, 10), (9, 8), (9, 10), (10, 9), (10, 10)])
    eater = B.from_cells([(24, 21), (24, 22), (25, 21), (25, 23), (26, 23),
                          (27, 23), (27, 24)])
    offsets = torch.randint(-12, 12, (333, 2), generator=gen)
    args = [t.to(device) for t in rollout_inputs(glider, eater, offsets, 41)]
    return "catalyst_rollout", tuple(args), step_cuda.catalyst_rollout_plain


@pytest.mark.parametrize("case", [_rollout_case, _controlled_case, _catalyst_case])
def test_kernel_matches_plain_twin(device, case):
    name, args, plain = case(torch.Generator().manual_seed(0), device)
    kernel = getattr(step_cuda, name)
    before = step_cuda.LAUNCHES[name]
    got = kernel(*args)
    torch.cuda.synchronize()
    assert step_cuda.LAUNCHES[name] == before + 1
    expect = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    expect = expect if isinstance(expect, tuple) else (expect,)
    for g, e in zip(got, expect):
        assert g.device == e.device and g.dtype == e.dtype
        assert torch.equal(g, e)


@pytest.mark.parametrize("case", [_rollout_case, _controlled_case, _catalyst_case])
def test_kernel_rejects_bad_input(device, case):
    name, args, _ = case(torch.Generator().manual_seed(1), device)
    kernel = getattr(step_cuda, name)
    with pytest.raises(TypeError):
        kernel(args[0].to(torch.int32), *args[1:])
    strided = torch.empty((args[0].shape[0], 128), dtype=torch.int64,
                          device=device)[:, ::2]
    with pytest.raises(ValueError):
        kernel(strided, *args[1:])
