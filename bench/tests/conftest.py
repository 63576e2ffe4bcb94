"""Shared set-up of the benchmark's own tests: the checkout's root and
``src`` on the path, the small sizes that a CPU run can hold, and the
fixture that decides whether there is a card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

#: a cell's configuration and traffic cut to what a CPU test run holds
SMALL = {"config": {"keys": 4000, "tuples_per_interval": 20000},
         "traffic": {"cycle_intervals": 4}}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the routing kernel has no CPU "
                    "mode")
    return "cuda"


def keyed_stage():
    """The keyed-stage runner, as the harness loads it."""
    from bench import harness
    return harness.load_file(ROOT, "runners", "keyed_stage")
