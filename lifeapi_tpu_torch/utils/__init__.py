from . import debug  # noqa: F401
