"""Device-mesh construction over ``torch.distributed`` (counterpart of
:mod:`lifeapi_tpu.parallel.mesh`).

The framework's two scaling dimensions (SURVEY.md section 2.8):
``scenario`` (independent MPC problems or search seeds, the data-parallel
dimension across hosts) and ``candidate`` (control candidates or branch
portfolios per scenario, within a host).  One process drives one device;
the mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over every
process of the group, rank r at coordinate ``(r // n_candidate, r %
n_candidate)``, so a rank's block of a batch sharded over both dimensions
is block r.

The backend follows the device: NCCL for CUDA, gloo for the CPU.  A
process with no group gets a world-size-1 group on an in-process store
when it asks for a mesh, as a one-device JAX mesh needs no launcher.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import resolve

SCENARIO_AXIS = "scenario"
CANDIDATE_AXIS = "candidate"

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device):
    kind = resolve(device, who="the mesh is built").type
    if kind not in _BACKENDS:
        raise ValueError(f"no collective backend for device type {kind!r}")
    return kind


def initialize_distributed(coordinator=None, num_processes=None, process_id=None,
                           device=None):
    """Join this process to a group of ``num_processes`` as rank
    ``process_id``.  ``coordinator`` is ``"host:port"`` of rank 0 (a TCP
    rendezvous) or an init-method URL such as ``file:///path``; ``None``
    reads torchrun's environment (``env://``).  The backend follows
    ``device`` (default CUDA)."""
    backend = _BACKENDS[_device_type(device)]
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def make_mesh(n_scenario=None, n_candidate=None, device=None):
    """2D mesh ``(scenario, candidate)`` over every process of the group.

    Defaults put every process on the scenario dimension.  On a multi-host
    cluster the scenario dimension should span hosts and the candidate
    dimension stay within one.  The group's backend must be the device's."""
    kind = _device_type(device)
    if not dist.is_initialized():
        dist.init_process_group(_BACKENDS[kind], store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() != _BACKENDS[kind]:
        raise RuntimeError(f"the process group's backend is {dist.get_backend()}; "
                           f"a {kind} mesh needs {_BACKENDS[kind]}")
    n = dist.get_world_size()
    if n_scenario is None and n_candidate is None:
        n_scenario, n_candidate = n, 1
    elif n_scenario is None:
        n_scenario = n // n_candidate
    elif n_candidate is None:
        n_candidate = n // n_scenario
    if n_scenario * n_candidate != n:
        raise ValueError(f"mesh {n_scenario} x {n_candidate} does not cover "
                         f"{n} processes")
    return DeviceMesh(kind, torch.arange(n).reshape(n_scenario, n_candidate),
                      mesh_dim_names=(SCENARIO_AXIS, CANDIDATE_AXIS))


def destroy():
    """Tear the process group down (and with it every mesh over it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
