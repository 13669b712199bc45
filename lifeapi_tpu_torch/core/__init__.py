from . import bitops, board, rle, step  # noqa: F401
