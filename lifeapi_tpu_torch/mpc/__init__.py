from . import cost, reachability, receding, soft, solver, symmetric  # noqa: F401
from .cost import CostWeights  # noqa: F401
from .solver import MPCProblem, MPCSolution  # noqa: F401
