"""lifeapi_tpu_torch — the PyTorch / CUDA port of :mod:`lifeapi_tpu`.

Same module names as the JAX package, so each counterpart is easy to find;
the workflows of its ``examples/`` are in :mod:`lifeapi_tpu_torch.examples`.
Boards are ``torch.int64[..., 64]`` (one word per column, bit y = cell y).
The bit-exact rollout kernels (``csrc/life_rollout.cu``), the still-life
solver's propagation and beam-search kernels (``csrc/life_stable.cu``), the
convolution kernels (``csrc/life_conv.cu``) and the calibration kernel
(``csrc/life_calibrate.cu``) are hand-written CUDA for Hopper, built by
``nvcc`` at first use on a CUDA tensor; every kernel has a plain PyTorch
twin that CPU tensors take.
This package never imports jax.
"""

from .core import bitops, board, convolve, rle, step, strips  # noqa: F401
from .state import LifeState  # noqa: F401
from .target import LifeTarget  # noqa: F401
from . import history, mpc, ops, search, stable, symmetry, utils, weld  # noqa: F401
from . import convert  # noqa: F401

__version__ = "0.1.0"
