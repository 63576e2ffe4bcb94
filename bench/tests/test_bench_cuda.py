"""The benchmark on the card: each cell runs briefly and reads correct, the
traced run reads the device's time and the routing kernel. These tests
carry the ``cuda`` marker and skip where torch finds no card:

    python3 -m pytest -m cuda bench/tests/test_bench_cuda.py
"""

import pytest

from bench import control, harness

pytestmark = pytest.mark.cuda

CELLS = ("wc-k1m.drift", "stock-selfjoin.burst", "wc-k1m.steady")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_reads_correct(cuda, cell):
    r = harness.run_cell(cell, 2**31 + 101, 2.0, False, device=cuda,
                         log=lambda s: None)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert set(r["metrics"]) == {"tuples_per_s", "parallel_efficiency",
                                 "setup_s"}


def test_traced_run_reads_the_device(cuda):
    r = harness.run_cell("wc-k1m.drift", 2**31 + 103, 3.0, True,
                         device=cuda, log=lambda s: None)
    assert r["correct"]
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    assert 0 < r["metrics"]["routing_lookup.roofline"]["value"] <= 100
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]


def test_control_on_the_card_reads_not_correct(cuda):
    r = harness.run_cell("stock-selfjoin.burst", 2**31 + 105, 2.0, False,
                         device=cuda, stage_factory=control.ControlStage,
                         log=lambda s: None)
    assert not r["correct"]
