from . import stable_cuda, step_cuda  # noqa: F401
