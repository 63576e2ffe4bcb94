"""The metrics' arithmetic on hand-made runs, reports and traces."""

import dataclasses
import statistics

import numpy as np
import pytest

from bench import harness, tracing, yardstick
from conftest import ROOT


@dataclasses.dataclass
class Report:
    task_loads: np.ndarray
    migrated_bytes: float = 0.0
    plan_time_s: float = 0.0
    tuples: int = 0


def _run(**kw):
    cell = harness.load_cell("wc-k1m.drift", ROOT)
    run = harness.Run(cell)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def _read(name, run):
    return harness.load_reader(run.cell, name).read(run)


def test_rate_is_all_tuples_over_all_the_window():
    run = _run(intervals=3, tuples=12_000_000, window_s=1.5,
               interval_ms=[100.0, 900.0, 500.0])
    assert _read("tuples_per_s", run) == 8_000_000


def test_rate_reads_nothing_without_an_interval():
    assert _read("tuples_per_s", _run(intervals=0, window_s=2.0)) is None


def test_parallel_efficiency_sums_means_over_sums_of_max_and_stall():
    reports = [Report(np.array([1.0, 3.0])),                 # mean 2, max 3
               Report(np.array([2.0, 2.0]), migrated_bytes=2e6)]  # +stall 2
    run = _run(reports=reports)
    bw = run.config["migration_bandwidth"]
    want = 100.0 * (2.0 + 2.0) / (3.0 + 2.0 + 2e6 / bw)
    assert _read("parallel_efficiency", run) == pytest.approx(want, rel=1e-15)


def test_interval_p90_is_statistics_quantiles_inclusive():
    ms = [float(x) for x in range(1, 21)]
    run = _run(interval_ms=ms)
    assert _read("engine.interval_ms_p90", run) == pytest.approx(
        statistics.quantiles(ms, n=10, method="inclusive")[8])
    assert "20 intervals" in run.notes[0]


def test_plan_and_migration_per_interval():
    reports = [Report(np.ones(2), migrated_bytes=3e6, plan_time_s=0.2),
               Report(np.ones(2)), Report(np.ones(2), plan_time_s=0.1)]
    run = _run(reports=reports)
    assert _read("controller.plan_ms", run) == pytest.approx(100.0)
    assert _read("controller.migrated_mb", run) == pytest.approx(1.0)


def test_span_metrics_per_window_interval():
    run = _run(intervals=4, spans={
        "device_step": [tracing.Call(10.0), tracing.Call(30.0)],
        "route_dense": [tracing.Call(2.0)], "route_copy": [tracing.Call(1.0)]})
    assert _read("device_step.ms", run) == pytest.approx(10.0)
    assert _read("route.ms", run) == pytest.approx(0.75)


def _trace(events, w0=0.0, w1=1000.0):
    return tracing.DeviceTrace(window_s=(w1 - w0) / 1e6, busy_s=0.0,
                               events=events, device_ops=[], idle_gaps=[])


def test_roofline_is_least_time_over_kernel_time():
    name = ("(anonymous namespace)::routing_lookup_kernel(int const*, long, "
            "int, (anonymous namespace)::Table, int*)")
    ev = [(name, "kernel", 0.0, 10.0), (name, "kernel", 50.0, 30.0),
          ("other_kernel(int)", "kernel", 5.0, 100.0)]
    calls = [tracing.Call(0.1, {"keys": 1 << 20, "buckets": 12288,
                                "cuda": True}),
             tracing.Call(0.1, {"keys": 1 << 20, "buckets": 12288,
                                "cuda": True})]
    run = _run(trace=_trace(ev), spans={"routing_lookup": calls})
    least = 2 * (8 * (1 << 20) + 16 * 12288) / yardstick.HBM_BYTES_PER_S
    assert _read("routing_lookup.roofline", run) == pytest.approx(
        100 * least / 40e-6)


def test_roofline_reads_nothing_without_a_launch_or_a_trace():
    assert _read("routing_lookup.roofline", _run(trace=_trace([]))) is None
    assert _read("routing_lookup.roofline", _run()) is None


def test_roofline_refuses_calls_that_do_not_match_launches():
    ev = [("routing_lookup_kernel(int)", "kernel", 0.0, 10.0)]
    run = _run(trace=_trace(ev), spans={"routing_lookup": []})
    assert _read("routing_lookup.roofline", run) is None
    assert "not read" in run.notes[0]


def test_routing_lookup_bytes_reads_and_writes_each_once():
    assert yardstick.routing_lookup_bytes(10, 3) == 40 + 48 + 40
    assert yardstick.least_seconds(3.35e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 989e12) == pytest.approx(1.0)


def test_device_idle_from_busy_and_window():
    t = _trace([])
    t.busy_s, t.window_s = 0.25, 1.0
    assert _read("device.idle", _run(trace=t)) == pytest.approx(75.0)
    assert _read("device.idle", _run()) is None


def test_busy_union_and_idle_by_innermost_span():
    busy = tracing._union([(10, 20), (15, 30), (50, 60)])
    assert busy == [(10, 30), (50, 60)]
    marks = [{"name": "engine.interval", "ts": 0, "dur": 80},
             {"name": "controller", "ts": 40, "dur": 30}]
    idle = tracing._idle_by_span(busy, marks, 0.0, 100.0)
    # idle: 0-10 and 30-40 in the interval, 40-50 and 60-70 in the
    # controller, 70-80 in the interval, 80-100 outside every span
    assert idle["engine.interval"] == pytest.approx(30e-6)
    assert idle["controller"] == pytest.approx(20e-6)
    assert idle["harness"] == pytest.approx(20e-6)


@pytest.mark.parametrize("demangled,name", [
    ("(anonymous namespace)::routing_lookup_kernel(int const*, long)",
     "routing_lookup_kernel"),
    ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp)",
     "reduce_kernel"),
    ("routing_lookup_kernel", "routing_lookup_kernel")])
def test_kernel_function_names(demangled, name):
    assert tracing.function_name(demangled) == name
