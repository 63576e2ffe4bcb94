"""The port's own spans and counters (:mod:`repro_torch.trace`) on the CPU.

Without a profiler every report's ``trace`` is ``None`` and no
``record_function`` range is opened. Under ``torch.profiler.profile`` a
device-backend WordCount stage that replans books every span on its
reports and in the profiler's events, counts the bytes it copies back
(four int32 ring outputs over the domain a traffic interval, the dense
F(k) table a table change, two an eviction-only interval) and the
planner's trials, and computes exactly what it computes untraced. An
interval that raises at a crash site leaves no record current. Plans whose
psi order ran on a device book ``plan_card_orders``; the one
``cuda``-marked test runs the stage on the card and skips without one.

No JAX here: only the port's stage, fixed seeds, ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import (Assignment, BalanceConfig, Hash32, KeyedStage,
                         RebalanceController, WordCount)
from repro_torch import trace
from repro_torch.core.balancer import llfd

SPANS = ("stage.pause", "stage.histogram", "stage.upload", "stage.copy_back",
         "stage.seen", "stage.outputs", "stage.mirrors", "stage.stats",
         "route.build", "route.upload", "plan.prepare", "plan.trial",
         "plan.finish", "plan.order")
KEYS = 3000
DOMAIN = 4096                       # the power of two above KEYS


def _stage(device="cpu"):
    """A stage whose small table makes Mixed run several trials."""
    controller = RebalanceController(
        Assignment(Hash32(5, seed=3)),
        BalanceConfig(theta_max=0.05, table_max=10, window=3))
    return KeyedStage(WordCount(), controller, window=3,
                      state_backend="device", substrate="kernels",
                      device=device)


def _traffic(n=8, seed=11):
    """Zipf(1.0) over KEYS, ranks permuted: some intervals replan, some
    keep their table."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, KEYS + 1)
    perm = rng.permutation(KEYS)
    return [perm[rng.choice(KEYS, 5000, p=p / p.sum())].astype(np.int64)
            for _ in range(n)]


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _run(stage, intervals, emits=False):
    """Each interval's report, and whether its dense F(k) table changed."""
    changed = []
    for keys in intervals:
        before = stage.backend._dest_dense_cache
        if emits:
            stage.process_interval_emits(keys)
        else:
            stage.process_interval_arrays(keys)
        changed.append(stage.backend._dest_dense_cache is not before)
    return stage.reports[-len(intervals):], changed


def test_no_profiler_no_trace_and_no_range(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    stage = _stage()
    reports, _ = _run(stage, _traffic())
    assert all(r.trace is None for r in reports)
    assert calls == [] and trace.current() is None
    assert trace.span("stage.outputs") is trace.span("plan.trial")


@pytest.mark.parametrize("emits", [False, True], ids=["arrays", "emits"])
def test_every_span_is_booked_and_in_the_profiler_events(emits):
    stage = _stage()
    with _profiled() as prof:
        reports, _ = _run(stage, _traffic(), emits)
    assert all(r.trace is not None for r in reports)
    assert sum(r.table_size != reports[0].table_size for r in reports)
    booked = set().union(*(r.trace.spans for r in reports))
    assert booked == set(SPANS)
    assert all(s > 0 for r in reports for s in r.trace.spans.values())
    events = {e.name for e in prof.events()}
    assert set(SPANS) <= events
    assert trace.current() is None


def test_copy_back_bytes_are_the_ring_outputs_and_the_table():
    stage = _stage()
    intervals = _traffic()
    with _profiled():
        reports, changed = _run(stage, intervals)
        quiet, = _run(stage, [np.zeros(0, np.int64)])[0]
    assert stage.backend.fleet.domain == DOMAIN
    assert 1 < sum(changed) < len(changed)
    for r, table_changed in zip(reports, changed):
        assert r.trace.counts["d2h_bytes"] == \
            4 * 4 * (DOMAIN + 1) + table_changed * 4 * (DOMAIN + 1)
    # a tuple-free interval copies back the evicted held totals only
    assert quiet.trace.counts["d2h_bytes"] == 2 * 4 * (DOMAIN + 1)
    assert "stage.copy_back" in quiet.trace.spans


def test_plan_trials_are_the_planners_own():
    stage = _stage()
    with _profiled():
        reports, _ = _run(stage, _traffic())
    planned = {ev.interval: ev.result.meta["trials"]
               for ev in stage.controller.history if ev.result is not None}
    assert max(planned.values()) > 1
    for r in reports:
        assert r.trace.counts.get("plan_trials", 0) == \
            planned.get(r.interval, 0)
        assert ("plan.trial" in r.trace.spans) == (r.interval in planned)


def _card_orders_per_plan(stage):
    """Each traced report's ``plan_card_orders``, and whether its interval
    planned."""
    with _profiled():
        reports, _ = _run(stage, _traffic())
    planned = {ev.interval for ev in stage.controller.history
               if ev.result is not None}
    assert planned
    return [(r.trace.counts.get("plan_card_orders", 0), r.interval in planned)
            for r in reports]


@pytest.mark.parametrize("min_keys,device", [
    (None, None), (1000, None), (None, "cpu"), (1000, "cpu")],
    ids=["no_device", "no_device_low_threshold", "under_threshold",
         "device"])
def test_plan_card_orders_are_booked_once_per_card_ordered_plan(
        monkeypatch, min_keys, device):
    """A CPU stage hands its controller no device, so no plan orders psi
    on a card. Handed one (torch's sort on the CPU stands in for the
    card's), each plan over at least ``CARD_ORDER_MIN_KEYS`` head keys
    books one card order; the stage's ~3000 keys stay under the default."""
    if min_keys is not None:
        monkeypatch.setattr(llfd, "CARD_ORDER_MIN_KEYS", min_keys)
    stage = _stage()
    assert stage.controller.plan_device is None
    if device is not None:
        stage.controller.plan_device = torch.device(device)
    engaged = min_keys is not None and device is not None
    for booked, planned in _card_orders_per_plan(stage):
        assert booked == (engaged and planned)


@pytest.mark.cuda
@pytest.mark.parametrize("min_keys", [None, 1000],
                         ids=["under_threshold", "on_the_card"])
def test_a_cuda_stage_orders_its_plans_on_its_card(monkeypatch, min_keys):
    """A stage on the card hands its controller the card: its plans book
    one card order each over the threshold and none under it, and plan
    exactly what a CPU stage plans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage's kernels have no CPU "
                    "mode")
    if min_keys is not None:
        monkeypatch.setattr(llfd, "CARD_ORDER_MIN_KEYS", min_keys)
    stage, host = _stage("cuda"), _stage()
    assert stage.controller.plan_device == torch.device("cuda")
    for booked, planned in _card_orders_per_plan(stage):
        assert booked == (min_keys is not None and planned)
    _run(host, _traffic())
    assert [ev.result.assignment.table for ev in stage.controller.history
            if ev.result is not None] == \
        [ev.result.assignment.table for ev in host.controller.history
         if ev.result is not None]


def test_tracing_changes_nothing_the_stage_computes():
    intervals = _traffic(8, seed=5)
    plain, traced = _stage(), _stage()
    _run(plain, intervals)
    with _profiled():
        _run(traced, intervals)
    # plan_time_s is the planner's wall time, which no two runs share
    fields = [f.name for f in dataclasses.fields(plain.reports[0])
              if f.name not in ("trace", "task_loads", "plan_time_s")]
    for a, b in zip(plain.reports, traced.reports, strict=True):
        assert [getattr(a, f) for f in fields] == \
            [getattr(b, f) for f in fields]
        np.testing.assert_array_equal(a.task_loads, b.task_loads)
    assert plain.outputs == traced.outputs
    assert plain.emitted_sum == traced.emitted_sum
    assert plain.controller.assignment.table == \
        traced.controller.assignment.table
    for ring in ("vals", "pres"):
        assert torch.equal(getattr(plain.backend.fleet, ring),
                           getattr(traced.backend.fleet, ring))


class _Crash(RuntimeError):
    pass


@pytest.mark.parametrize("site", ["deliver", "mid"])
def test_an_interval_that_raises_leaves_no_record(site):
    stage = _stage()
    first, second = _traffic(2)

    def failpoint(at, _stage):
        if at == site:
            raise _Crash(at)

    with _profiled():
        stage.process_interval_arrays(first)
        stage.failpoint = failpoint
        with pytest.raises(_Crash):
            stage.process_interval_arrays(second)
        assert trace.current() is None
    assert trace.current() is None


def test_record_nests_and_restores_the_outer_one():
    with _profiled():
        outer = trace.begin()
        mine = trace.current()
        inner = trace.begin()
        trace.count("d2h_bytes", 8)
        with trace.span("stage.outputs"):
            pass
        assert trace.end(inner).counts == {"d2h_bytes": 8}
        assert trace.current() is mine and mine.counts == {}
        assert trace.end(outer) is mine
    assert trace.current() is None
