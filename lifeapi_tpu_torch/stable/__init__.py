from . import (  # noqa: F401
    api, bitplane, complete, host, nibble, options, propagate, rules_vec, ternary,
)
from .api import LifeStable  # noqa: F401
from .complete import (  # noqa: F401
    BeamResult, CompletionResult, PortfolioResult, complete_stable, complete_stable_beam,
    complete_stable_beam_queued, complete_stable_portfolio,
)
from .propagate import Stable  # noqa: F401
