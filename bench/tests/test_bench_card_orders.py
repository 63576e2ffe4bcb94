"""The reader of ``controller.card_orders``: the program's count
``plan_card_orders`` per interval of the window on hand-made reports,
nothing to read without a record or from a program whose planner orders
psi on the host alone, and 0 in a traced CPU run of each cell (a stage on
the CPU hands its controller no card)."""

import types

import pytest

from bench import harness
from conftest import ROOT, SMALL

NAME = "controller.card_orders"


def _run(reports):
    run = harness.Run(harness.load_cell("wc-k1m.drift", ROOT))
    run.reports = reports
    run.intervals = len(reports)
    return run


def _report(counts):
    return types.SimpleNamespace(
        trace=None if counts is None
        else types.SimpleNamespace(spans={}, counts=counts))


def _read(run):
    return harness.load_reader(run.cell, NAME).read(run)


def test_card_orders_per_window_interval():
    run = _run([_report({"plan_card_orders": 1, "plan_trials": 3}),
                _report({"plan_card_orders": 1}), _report({}),
                _report(None)])
    assert _read(run) == pytest.approx(2 / 4, rel=1e-12)


@pytest.mark.parametrize("reports", [[], [_report(None), _report(None)]],
                         ids=["no_report", "untraced"])
def test_nothing_to_read_without_a_record(reports):
    assert _read(_run(reports)) is None


def test_nothing_to_read_from_a_host_only_planner(monkeypatch):
    from repro_torch.core.balancer import llfd
    monkeypatch.delattr(llfd, "CARD_ORDER_MIN_KEYS")
    assert _read(_run([_report({"plan_card_orders": 1})])) is None


def test_the_metric_moves_throughput_in_every_cell():
    for cell in ("wc-k1m.drift", "stock-selfjoin.burst", "wc-k1m.steady"):
        names = {m["name"] for m in harness.metric_entries(
            harness.load_cell(cell, ROOT), True)}
        assert NAME in names, cell


@pytest.mark.parametrize("cell", ["wc-k1m.drift", "stock-selfjoin.burst"])
def test_a_traced_cpu_run_reads_no_card_order(cell):
    r = harness.run_cell(cell, 2**31 + 37, 0.3, True, device="cpu",
                         overrides=SMALL, log=lambda s: None)
    assert r["correct"]
    assert r["metrics"][NAME]["value"] == 0.0
