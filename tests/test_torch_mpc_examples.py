"""The port's ``examples/mpc_demo`` on the CPU: the demo configuration
(horizon 8, 16 candidates, 150 iterations) reaches the block, as
``tests/test_mpc.py::test_gradient_solver_reaches_target`` asks of the JAX
package, and its controls replay to the same final board in numpy."""

from lifeapi_tpu_torch.examples import mpc_demo
from torch_threads import one_torch_thread  # noqa: F401


def test_mpc_demo_reaches_target():
    r = mpc_demo.run("cpu")
    assert r["hamming"] == 0
    assert r["replayed"]
    assert r["solution"].all_costs.shape == (16,) and r["solution"].controls.shape == (8, 64)
    assert 0 < r["toggles"] < 16
