"""The port's flagship entry points (``lifeapi_tpu_torch.graft_entry``)
against ``__graft_entry__``: the forward step on JAX's own example logits
(soft costs at rtol 1e-4, hard costs and final boards exactly), and the
multi-device dry run on 1, 2 and 4 gloo ranks, each held by the dry run
itself to a mesh of one rank.  The spawned ranks meet on a ``file://``
rendezvous in a temporary directory of their own."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as J
from lifeapi_tpu_torch import convert
from lifeapi_tpu_torch import graft_entry as G
from torch_threads import one_torch_thread  # noqa: F401


def test_entry_equals_jax_on_its_logits():
    jfn, (jlogits,) = J.entry()
    soft, hard, finals = (np.asarray(x) for x in jax.jit(jfn)(jlogits))
    fn, (example,) = G.entry(device="cpu")
    assert tuple(example.shape) == (4, 8, 64, 64) and example.dtype == torch.float32
    got = fn(torch.from_numpy(np.array(jlogits)))
    np.testing.assert_allclose(got[0].detach().numpy(), soft, rtol=1e-4)
    assert np.array_equal(got[1].numpy(), hard)
    assert np.array_equal(convert.board_to_packed(got[2]), finals)


def test_entry_example_is_one_draw():
    """The example logits come from a CPU generator at seed 0, so two calls
    give the same draw, and forward runs on them."""
    fn, (a,) = G.entry(device="cpu")
    _, (b,) = G.entry(device="cpu")
    assert torch.equal(a, b)
    soft, hard, finals = fn(a)
    assert soft.shape == hard.shape == (4,) and finals.shape == (4, 64)
    assert torch.isfinite(soft).all() and torch.isfinite(hard).all()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_gloo(n):
    G.dryrun_multichip(n, device="cpu")
    assert not dist.is_initialized()


def test_dryrun_needs_the_cards(monkeypatch):
    """A CUDA dry run raises when the machine lacks a card or holds fewer
    than asked for; it never falls back to the CPU."""
    with pytest.raises(RuntimeError):
        G.dryrun_multichip(2, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="holds 1"):
        G.dryrun_multichip(2, device="cuda")


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        G.entry()
    with pytest.raises(RuntimeError):
        G.dryrun_multichip(1)
