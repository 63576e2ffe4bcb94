"""The readers of the program's own spans and counters (the reports' trace
records): their sums per interval on hand-made reports, nothing to read
without a record, and a traced CPU run of each cell that reports all six."""

import types

import pytest

from bench import harness
from conftest import ROOT, SMALL, keyed_stage

READERS = ("engine.copy_back_ms", "engine.copy_back_mb", "engine.outputs_ms",
           "engine.mirrors_ms", "controller.trial_ms", "controller.trials")


def _record(spans=None, counts=None):
    return types.SimpleNamespace(spans=spans or {}, counts=counts or {})


def _report(trace):
    return types.SimpleNamespace(trace=trace)


def _run(reports):
    run = harness.Run(harness.load_cell("wc-k1m.drift", ROOT))
    run.reports = reports
    run.intervals = len(reports)
    return run


def _read(name, run):
    return harness.load_reader(run.cell, name).read(run)


def test_span_and_count_readers_per_window_interval():
    reports = [
        _report(_record({"stage.copy_back": 0.004, "stage.outputs": 0.010,
                         "stage.mirrors": 0.002, "stage.stats": 0.001,
                         "plan.trial": 0.030, "plan.prepare": 0.5},
                        {"d2h_bytes": 16_777_232, "plan_trials": 3})),
        _report(_record({"stage.copy_back": 0.002, "stage.outputs": 0.006,
                         "stage.mirrors": 0.003},
                        {"d2h_bytes": 20_971_540})),
        _report(_record()),
        _report(None)]            # an interval outside the profiler
    run = _run(reports)
    want = {"engine.copy_back_ms": 6.0 / 4, "engine.outputs_ms": 16.0 / 4,
            "engine.mirrors_ms": 6.0 / 4, "controller.trial_ms": 30.0 / 4,
            "engine.copy_back_mb": 37.748772 / 4, "controller.trials": 3 / 4}
    for name, value in want.items():
        assert _read(name, run) == pytest.approx(value, rel=1e-12), name


@pytest.mark.parametrize("reports", [
    [], [_report(None), _report(None)],
    [types.SimpleNamespace(task_loads=None)]],      # a report with no field
    ids=["no_report", "untraced", "no_trace_field"])
def test_readers_read_nothing_without_a_record(reports):
    run = _run(reports)
    assert [_read(name, run) for name in READERS] == [None] * len(READERS)


@pytest.mark.parametrize("cell", ["wc-k1m.drift", "stock-selfjoin.burst",
                                  "wc-k1m.steady"])
def test_a_traced_cpu_run_reports_all_six(cell):
    """The copied-back bytes are exact: four int32 ring outputs over the
    domain each interval, plus the dense F(k) table in each interval whose
    table the previous round's plan changed."""
    stages = []

    def factory(cfg, device, bench):
        stages.append(keyed_stage().make_stage(cfg, device, bench))
        return stages[-1]

    r = harness.run_cell(cell, 2**31 + 29, 0.3, True, device="cpu",
                         overrides=SMALL, stage_factory=factory,
                         log=lambda s: None)
    assert r["correct"]
    metrics = {n: m["value"] for n, m in r["metrics"].items()}
    assert set(READERS) <= set(metrics)
    window = [rep for rep in stages[0].reports if rep.trace is not None]
    d1 = stages[0].backend.fleet.domain + 1
    changed = sum(rep.plan_time_s > 0 for rep in window)
    assert metrics["engine.copy_back_mb"] == pytest.approx(
        (16 * d1 * len(window) + 4 * d1 * changed) / len(window) / 1e6,
        rel=1e-12)
