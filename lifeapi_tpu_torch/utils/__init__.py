from . import checkpoint, debug, profiling, prng  # noqa: F401
