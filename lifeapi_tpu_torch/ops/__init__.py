from . import soft_cuda, stable_cuda, step_cuda  # noqa: F401
