"""Sharded runners over ``torch.distributed`` (counterpart of
:mod:`lifeapi_tpu.parallel`)."""

from . import elite, mesh  # noqa: F401
from .mesh import destroy, initialize_distributed, make_mesh  # noqa: F401
