"""What a benchmark run loads and reads: no JAX, nothing of the JAX
package (``repro``, compared as a whole top-level name), nothing under
``benchmarks/``; and the reference's modules import nothing of the
program."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL

PROBE = r'''
import json, sys
opened = []
sys.addaudithook(lambda ev, a: opened.append(str(a[0]))
                 if ev == "open" and a and isinstance(a[0], str) else None)
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
from bench import harness, control
import importlib.util
spec = importlib.util.spec_from_file_location("bench_run",
                                              root + "/bench/run.py")
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
small = json.loads(sys.argv[2])
results = []
for cell in ("wc-k1m.drift", "stock-selfjoin.burst", "wc-k1m.steady"):
    for trace in (False, True):
        r = harness.run_cell(cell, 7, 0.2, trace, device="cpu",
                             overrides=small, log=lambda s: None)
        results.append(r["correct"])
    harness.run_cell(cell, 7, 0.2, False, device="cpu", overrides=small,
                     stage_factory=control.ControlStage, log=lambda s: None)
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened, "correct": results}))
'''

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


@pytest.fixture(scope="module")
def probe():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT),
                          json.dumps(SMALL)], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_forbidden_module_is_loaded(probe):
    assert probe["correct"] == [True] * 6
    assert "repro_torch" in probe["modules"]
    assert not FORBIDDEN & set(probe["modules"])


def test_nothing_under_benchmarks_is_read(probe):
    bench_dir = str(ROOT / "benchmarks") + "/"
    assert not [p for p in probe["opened"] if p.startswith(bench_dir)]


def test_harness_refuses_the_forbidden_names_whole(monkeypatch):
    from bench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_loaded() == ["repro"]


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


REFERENCE_SIDE = ["reference", "judge", "traffic", "yardstick"] + sorted(
    f"operators/{p.stem}"
    for p in (ROOT / "bench" / "operators").glob("*.py"))


@pytest.mark.parametrize("module", REFERENCE_SIDE)
def test_reference_side_imports_numpy_and_the_standard_library(module):
    allowed = {"numpy", "__future__", "dataclasses", "typing", "importlib",
               "pathlib", "types"}
    assert _imports(ROOT / "bench" / f"{module}.py") <= allowed


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    """Without a card run.py finds none; in a directory of only the
    benchmark's files it finds no program either. Both exit non-zero with
    no result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for root in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", "wc-k1m.steady",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=root)
        if root == ROOT and out.returncode == 0:
            pytest.skip("a card is present: run.py ran")
        assert out.returncode != 0 and out.stdout.strip() == ""
        assert "no result" in out.stderr
