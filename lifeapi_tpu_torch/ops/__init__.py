from . import step_cuda  # noqa: F401
