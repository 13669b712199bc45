"""The port and its benchmark harness never import jax or the JAX
package, and the harness never imports the JAX package's benchmarks."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "lifeapi_tpu_torch"
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
BENCH = sorted(p.relative_to(ROOT).as_posix() for p in (ROOT / "bench_torch").glob("*.py"))
# the port's scripts at the root of the repo
ROOT_SCRIPTS = ["chip_smoke", "device_times", "soft_accuracy"]


def _module(path):
    return path[:-len(".py")].replace("/", ".").removesuffix(".__init__")


def test_every_module_imports_with_jax_blocked():
    mods = [_module(p) for p in SOURCES + BENCH] + ROOT_SCRIPTS
    code = "\n".join([
        "import importlib, sys",
        "sys.modules['jax'] = None",
        "sys.modules['lifeapi_tpu'] = None",
        "sys.modules['bench'] = None",
        "sys.modules['benches'] = None",
        f"for m in {mods!r}:",
        "    importlib.import_module(m)",
        "bad = [m for m in sys.modules if m.startswith(('jax.', 'lifeapi_tpu.', 'benches.'))]",
        "assert not bad, bad",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", SOURCES + BENCH + [f"{m}.py" for m in ROOT_SCRIPTS])
def test_source_names_no_jax(path):
    text = (ROOT / path).read_text()
    for word in ("import jax", "from jax", "import lifeapi_tpu\n", "from lifeapi_tpu ",
                 "from lifeapi_tpu.", "import lifeapi_tpu.", "torch.compile"):
        assert word not in text, (path, word)


@pytest.mark.parametrize("path", BENCH)
def test_bench_names_no_jax_benchmark(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(bench|benches)\b(?!_)", text, re.M), path
    assert "bench.py" not in text and "benches/" not in text, path
