from . import bitplane, complete, host, nibble, options, propagate  # noqa: F401
from .complete import (  # noqa: F401
    BeamResult, CompletionResult, complete_stable, complete_stable_beam,
    complete_stable_beam_queued,
)
from .propagate import Stable  # noqa: F401
