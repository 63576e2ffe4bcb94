"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package, the package imports and
runs with both blocked, and its entry points refuse to run without a CUDA
device unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax_or_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import numpy as np
import repro_torch
from repro_torch import (Assignment, BalanceConfig, Hash32, KeyedStage,
                         RebalanceController, WordCount)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)

def stage(**kw):
    c = RebalanceController(Assignment(Hash32(4, seed=2)),
                            BalanceConfig(theta_max=0.0, window=2))
    return KeyedStage(WordCount(), c, window=2, state_backend="device",
                      substrate="kernels", **kw)

try:
    stage()
except RuntimeError as e:
    assert "device='cpu'" in str(e)
else:
    raise AssertionError("KeyedStage without device= ran with no CUDA")
s = stage(device="cpu")
r = s.process_interval_arrays(np.arange(200, dtype=np.int64) % 37)
assert r.tuples == 200 and s.total_state_keys() == 37
print("ok")
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
