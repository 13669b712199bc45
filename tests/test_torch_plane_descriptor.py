"""Where kernels B and C find a ``BitStable``'s planes
(``stable_cuda.plane_descriptor``), on CPU tensors: a plane is read in place
where its last dimension is contiguous and its batch dimensions flatten to
one board stride below 2**31 words; any other plane is copied.  The kernels
themselves run on the card (``tests/test_torch_cuda_kernels.py``)."""

import pytest
import torch

from lifeapi_tpu_torch.core import board as B
from lifeapi_tpu_torch.ops import stable_cuda
from lifeapi_tpu_torch.stable import bitplane as BP
from torch_threads import one_torch_thread  # noqa: F401


def _bitstable(batch):
    gen = torch.Generator().manual_seed(0)
    state = B.random(gen, batch, device="cpu")
    return BP.make(state=state, unknown=B.random(gen, batch, device="cpu") & ~state)


def _planes(bst):
    return (bst.state, bst.unknown, *bst.ruled)


def _in_place(planes, kept):
    return all(k is p for k, p in zip(kept, planes))


def test_from_planes_view_is_read_in_place_at_stride_640():
    stacked = BP.to_planes(_bitstable((5,))).contiguous()
    planes = _planes(BP.from_planes(stacked))
    pointers, strides, kept = stable_cuda.plane_descriptor(planes)
    assert _in_place(planes, kept)
    assert strides == [BP.N_PLANES * 64] * BP.N_PLANES
    assert [p - pointers[0] for p in pointers] == [512 * i for i in range(BP.N_PLANES)]
    assert pointers[0] == stacked.data_ptr()
    # the planes API's words, computed from the stacked tensor alone
    assert list(stable_cuda._stacked(stacked, 1)) == pointers + strides


def test_plane_major_outputs_are_contiguous_planes():
    """The entries' results: plane i of an ``int64[10, N, 64]`` at i * N *
    512 bytes, board stride 64."""
    out = torch.empty((BP.N_PLANES, 7, 64), dtype=torch.int64)
    words = list(stable_cuda._stacked(out, 0))
    pointers, strides, _ = stable_cuda.plane_descriptor(out.unbind(0))
    assert words == pointers + strides and strides == [64] * BP.N_PLANES
    assert words[1] - words[0] == 7 * 512


def test_make_planes_are_read_in_place_at_stride_64():
    planes = _planes(_bitstable((7,)))
    pointers, strides, kept = stable_cuda.plane_descriptor(planes)
    assert _in_place(planes, kept)
    assert strides == [64] * BP.N_PLANES
    assert pointers == [p.data_ptr() for p in planes]


def test_two_dim_batch_flattens_without_a_copy():
    stacked = BP.to_planes(_bitstable((2, 3))).contiguous()
    planes = _planes(BP.from_planes(stacked))
    assert planes[0].stride() == (3 * 640, 640, 1)
    _, strides, kept = stable_cuda.plane_descriptor(planes)
    assert _in_place(planes, kept) and strides == [640] * BP.N_PLANES
    made = _planes(_bitstable((2, 3)))
    _, strides, kept = stable_cuda.plane_descriptor(made)
    assert _in_place(made, kept) and strides == [64] * BP.N_PLANES


def test_a_broadcast_batch_is_read_in_place_at_stride_0():
    plane = B.from_cells([(3, 4)], device="cpu").expand(2, 6, 64)
    _, strides, kept = stable_cuda.plane_descriptor((plane,))
    assert kept[0] is plane and strides == [0]


def test_planes_8_bytes_past_16_are_read_in_place():
    """The kernels read a board word by word, so 8-byte alignment, which
    every int64 tensor has, is all a plane needs: a plane whose data starts
    8 bytes past 16, and one of odd board stride, are read where they lie."""
    bst = _bitstable((4,))
    store = torch.zeros(4 * 64 + 1, dtype=torch.int64)
    shifted = store[1:].view(4, 64)
    shifted.copy_(bst.state)
    assert shifted.data_ptr() % 16 == 8 and shifted.is_contiguous()
    odd = torch.cat([bst.unknown, bst.unknown[:, :1]], dim=-1)[:, :64]
    assert odd.stride() == (65, 1)
    planes = (shifted, odd, *_planes(bst)[2:])
    pointers, strides, kept = stable_cuda.plane_descriptor(planes)
    assert _in_place(planes, kept)
    assert pointers[:2] == [shifted.data_ptr(), odd.data_ptr()]
    assert strides == [64, 65] + [64] * (BP.N_PLANES - 2)


class _HugeStride:
    """A stand-in for a plane of two boards 2**31 words apart, which no
    test machine can hold."""

    shape = (2, 64)

    def is_contiguous(self):
        return False

    def stride(self, dim=None):
        return (2**31, 1) if dim is None else (2**31, 1)[dim]

    def data_ptr(self):
        return 4096

    def clone(self, memory_format=None):
        return torch.zeros(2, 64, dtype=torch.int64)


def test_a_board_stride_past_32_bits_is_copied():
    plane = _HugeStride()
    _, strides, kept = stable_cuda.plane_descriptor((plane,))
    assert kept[0] is not plane and strides == [64]


@pytest.mark.parametrize("make", [
    lambda t: torch.cat([t, t], dim=-1)[..., ::2],   # last dimension strided
    lambda t: t.transpose(0, 1),                      # batch does not flatten
])
def test_planes_that_break_the_rule_are_copied(make):
    state = _bitstable((3, 2)).state
    plane = make(state)
    pointers, strides, kept = stable_cuda.plane_descriptor((plane,))
    assert kept[0] is not plane and kept[0].is_contiguous()
    assert torch.equal(kept[0], plane) and strides == [64]
    assert pointers[0] == kept[0].data_ptr()


def test_bitstable_planes_are_checked():
    bst = _bitstable((4,))
    planes, batch, n = stable_cuda._bitstable_planes(bst)
    assert batch == (4,) and n == 4 and len(planes) == BP.N_PLANES
    with pytest.raises(TypeError):
        stable_cuda._bitstable_planes(bst._replace(unknown=bst.unknown.to(torch.int32)))
    with pytest.raises(ValueError):
        stable_cuda._bitstable_planes(bst._replace(unknown=bst.unknown[:3]))
    with pytest.raises(ValueError):
        stable_cuda._bitstable_planes(bst._replace(ruled=bst.ruled[:7]))
    with pytest.raises(ValueError):
        stable_cuda._bitstable_planes(_bitstable((0,)))
