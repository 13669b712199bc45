from . import cost, soft, solver  # noqa: F401
from .cost import CostWeights  # noqa: F401
from .solver import MPCProblem, MPCSolution  # noqa: F401
