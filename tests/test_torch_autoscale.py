"""The port's autoscaling loop against the JAX package's, on the CPU.

The drift and burst traffic shapes give the JAX ``AutoscaleLoop``'s
decision lists (interval, sizes, reason, predicted bytes and stall,
applied) and report streams exactly, on the columnar store and on the
device ring (``device="cpu"``); so do the migration-cost damper's veto,
the router rejection, the heartbeat monitor and ``scale_to``'s
rejections. The chip phase's burst (quiet, hot, quiet) runs here at a
small size: the device ring against the columnar store, as the chip holds
them.

The JAX stages avoid ring width 6 (window 5), fleets of 6 or 9 tasks and
hash seed 99: other test files count the JAX device steps' traces under
those signatures.
"""

import dataclasses
import types

import numpy as np
import pytest

from repro.core import Assignment as RefAssignment
from repro.core import AutoscaleConfig as RefAutoscaleConfig
from repro.core import AutoscaleLoop as RefAutoscaleLoop
from repro.core import AutoscalePolicy as RefAutoscalePolicy
from repro.core import BalanceConfig as RefConfig
from repro.core import HeartbeatMonitor as RefHeartbeatMonitor
from repro.core import ModHash as RefModHash
from repro.core import RebalanceController as RefController
from repro.core.balancer import KeyStats as RefKeyStats
from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.streams import KeyedStage as RefStage
from repro.streams import PartialWordCount as RefPartialWordCount
from repro.streams import WordCount as RefWordCount
from repro.streams import WorkloadGen as RefGen
from repro_torch.core import (Assignment, AutoscaleConfig, AutoscaleLoop,
                              AutoscalePolicy, BalanceConfig, Hash32,
                              HeartbeatMonitor, KeyStats, ModHash,
                              RebalanceController)
from repro_torch.streams import KeyedStage, PartialWordCount, WordCount

REPORT_FIELDS = ("interval", "tuples", "makespan", "migration_stall",
                 "throughput", "skewness", "theta", "migrated_bytes",
                 "table_size", "buffered")


def make_stage(port, n_tasks, hash_seed, theta_max=0.2, window=2,
               backend="columnar", hash32=False, **kwargs):
    if port:
        hc = Hash32 if hash32 else ModHash
        controller = RebalanceController(
            Assignment(hc(n_tasks, seed=hash_seed)),
            BalanceConfig(theta_max=theta_max, table_max=400, window=window),
            algorithm="mixed")
        return KeyedStage(WordCount(), controller, window=window,
                          state_backend=backend, device="cpu", **kwargs)
    hc = RefHash32 if hash32 else RefModHash
    controller = RefController(
        RefAssignment(hc(n_tasks, seed=hash_seed)),
        RefConfig(theta_max=theta_max, table_max=400, window=window),
        algorithm="mixed")
    return RefStage(WordCount() if port else RefWordCount(), controller,
                    window=window, state_backend=backend, **kwargs)


def make_loop(port, stage, monitor=True, **cfg):
    if port:
        return AutoscaleLoop(stage, AutoscaleConfig(**cfg),
                             monitor=HeartbeatMonitor() if monitor else None)
    return RefAutoscaleLoop(stage, RefAutoscaleConfig(**cfg),
                            monitor=RefHeartbeatMonitor() if monitor
                            else None)


def drive(loops, gen_args, counts):
    """Step every loop through the same traffic, drawn by one generator that
    follows the first loop's live table; every loop must hold the same
    table after each step (so each would have drawn the same keys)."""
    gen = RefGen(**gen_args)
    sizes = [[] for _ in loops]
    for i, count in enumerate(counts):
        gen.interval(loops[0].stage.controller.assignment, fluctuate=i > 0)
        keys = gen.draw_tuples(count).astype(np.int64)
        for loop, ns in zip(loops, sizes):
            loop.step(keys)
            ns.append(loop.stage.n_tasks)
        tables = [loop.stage.controller.assignment.table for loop in loops]
        assert all(t == tables[0] for t in tables), "tables diverged"
    return sizes


def decisions(loop):
    return [dataclasses.astuple(d) for d in loop.decisions]


def assert_reports_identical(got, want):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for field in REPORT_FIELDS:
            assert getattr(rg, field) == getattr(rw, field), \
                (rw.interval, field)
        np.testing.assert_array_equal(rg.task_loads, rw.task_loads)


def assert_loops_identical(got, want):
    assert decisions(got) == decisions(want)
    assert_reports_identical(got.stage.reports, want.stage.reports)
    assert got.stage.outputs == want.stage.outputs
    assert got.stalled_tasks == want.stalled_tasks
    assert got.stage.n_tasks == want.stage.n_tasks


def _no_oscillation(decs, min_gap=4):
    applied = [d for d in decs if d.applied]
    return all(cur.reason == prev.reason
               or cur.interval - prev.interval >= min_gap
               for prev, cur in zip(applied, applied[1:]))


# -- traffic shapes -----------------------------------------------------------

@pytest.mark.parametrize("backend", ["columnar", "device"])
def test_drift_shape_matches_jax(backend):
    """Steady overload under fluctuating keys: the fleet grows to demand
    and stays. (The JAX package's drift test draws with f = 2.5, which its
    generator's swap loop never reaches at these fleets: 200,000 swaps, ~4
    s an interval. f = 0.4 drifts the keys every interval at a fraction of
    that cost; the decisions are held to the JAX loop's on the same
    trace.)"""
    hash32 = backend == "device"
    port = make_loop(True, make_stage(True, 2, 0, backend=backend,
                                      hash32=hash32),
                     target_load=200.0, max_tasks=16)
    ref = make_loop(False, make_stage(False, 2, 0, hash32=hash32),
                    target_load=200.0, max_tasks=16)
    ns, _ = drive([port, ref], dict(k=2000, z=1.1, f=0.4, seed=3, window=2),
                  [900] * 25)
    assert_loops_identical(port, ref)
    applied = [d for d in port.decisions if d.applied]
    assert applied and all(d.reason == "scale-out" for d in applied)
    assert _no_oscillation(port.decisions)
    assert len(set(ns[-5:])) == 1 and ns[-1] >= 4


@pytest.mark.parametrize("backend", ["columnar", "device"])
def test_burst_shape_matches_jax(backend):
    """Quiet -> hot burst -> quiet: one scale-out during the burst, one
    scale-in after it drains."""
    hash32 = backend == "device"
    port = make_loop(True, make_stage(True, 4, 1, backend=backend,
                                      hash32=hash32), monitor=False,
                     target_load=200.0, min_tasks=2, max_tasks=16)
    ref = make_loop(False, make_stage(False, 4, 1, hash32=hash32),
                    monitor=False, target_load=200.0, min_tasks=2,
                    max_tasks=16)
    ns, _ = drive([port, ref], dict(k=1000, z=1.0, f=0.5, seed=4, window=2),
                  [300] * 4 + [1600] * 8 + [300] * 10)
    assert_loops_identical(port, ref)
    reasons = {d.reason for d in port.decisions if d.applied}
    assert reasons == {"scale-out", "scale-in"}
    assert _no_oscillation(port.decisions)
    assert max(ns) >= 6 and ns[-1] < max(ns)


def test_chip_burst_shape_device_ring_equals_columnar():
    """``chip_smoke.py``'s autoscale leg at a small size: starting at the
    full fleet, quiet -> 4x -> quiet traffic scales in, out, and in again;
    the device ring's decisions and reports equal the columnar stage's
    (the chip's check), and both equal the JAX loop's."""
    n, target = 15, 4000 / 15

    def loop(port, backend):
        return make_loop(port, make_stage(port, n, 0, theta_max=0.08,
                                          window=3, backend=backend,
                                          hash32=True),
                         target_load=target, min_tasks=4, max_tasks=n)

    dev, col, ref = loop(True, "device"), loop(True, "columnar"), \
        loop(False, "columnar")
    ns, _, _ = drive([dev, col, ref],
                     dict(k=3000, z=0.85, f=1.0, seed=0, window=3),
                     [1000] * 4 + [4000] * 5 + [1000] * 5)
    assert_loops_identical(dev, col)
    assert_loops_identical(dev, ref)
    applied = [(d.reason, d.from_tasks, d.to_tasks)
               for d in dev.decisions if d.applied]
    assert [a[0] for a in applied] == ["scale-in", "scale-out", "scale-in"]
    assert applied[0][2] == 4 and applied[1][2] == n
    assert dev.stalled_tasks == []
    assert ns[-1] < n


# -- the damper, the monitor and the rejections ----------------------------------

def test_damper_vetoes_unpayable_migration_as_jax():
    port = make_loop(True, make_stage(True, 2, 0, migration_bandwidth=1e-6),
                     monitor=False, target_load=200.0, max_tasks=16)
    ref = make_loop(False, make_stage(False, 2, 0, migration_bandwidth=1e-6),
                    monitor=False, target_load=200.0, max_tasks=16)
    drive([port, ref], dict(k=2000, z=1.1, f=0.3, seed=3, window=2),
          [900] * 8)
    assert_loops_identical(port, ref)
    assert port.decisions and not any(d.applied for d in port.decisions)
    assert all(d.predicted_stall > 0 for d in port.decisions)
    assert port.stage.n_tasks == 2


def test_policy_sizing_and_migration_prediction_match_jax():
    rng = np.random.default_rng(5)
    keys = np.arange(400, dtype=np.int64)
    freq = rng.zipf(1.4, size=400).astype(np.float64)
    mem = rng.integers(1, 40, size=400).astype(np.float64)
    table = {int(k): int(k) % 5 for k in keys[::9]}
    port = AutoscalePolicy(AutoscaleConfig(target_load=50.0, min_tasks=2,
                                           max_tasks=12))
    ref = RefAutoscalePolicy(RefAutoscaleConfig(target_load=50.0,
                                                min_tasks=2, max_tasks=12))
    for total in (0.0, 10.0, 99.0, 401.0, 5000.0):
        assert port.desired_tasks(total) == ref.desired_tasks(total)
    for n_new in (2, 3, 7, 11):
        assert port.predict_migration_bytes(
            KeyStats(keys, freq, mem, freq),
            Assignment(ModHash(5, seed=2), dict(table)), n_new) == \
            ref.predict_migration_bytes(
                RefKeyStats(keys, freq, mem, freq),
                RefAssignment(RefModHash(5, seed=2), dict(table)), n_new)
    assert port.predict_migration_bytes(None, None, 3) == 0.0


@pytest.mark.parametrize("kwargs", [
    dict(target_load=0.0), dict(target_load=1.0, min_tasks=5, max_tasks=4),
    dict(target_load=1.0, low=1.0), dict(target_load=1.0, high=0.9),
    dict(target_load=1.0, patience=0), dict(target_load=1.0, cooldown=-1)])
def test_config_validation_matches_jax(kwargs):
    with pytest.raises(ValueError) as got:
        AutoscaleConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        RefAutoscaleConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_loop_rejects_router_strategies_as_jax():
    port_ctrl = RebalanceController(Assignment(ModHash(4, seed=0)),
                                    BalanceConfig(theta_max=0.2, window=2),
                                    algorithm="pkg")
    ref_ctrl = RefController(RefAssignment(RefModHash(4, seed=0)),
                             RefConfig(theta_max=0.2, window=2),
                             algorithm="pkg")
    with pytest.raises(ValueError, match="router") as got:
        AutoscaleLoop(KeyedStage(PartialWordCount(), port_ctrl, window=2,
                                 device="cpu"),
                      AutoscaleConfig(target_load=100.0))
    with pytest.raises(ValueError) as want:
        RefAutoscaleLoop(RefStage(RefPartialWordCount(), ref_ctrl,
                                  window=2),
                         RefAutoscaleConfig(target_load=100.0))
    assert str(got.value) == str(want.value)


def _report(interval, loads, tuples=None):
    loads = np.asarray(loads, dtype=np.float64)
    return types.SimpleNamespace(interval=interval, tuples=(
        int(loads.sum()) if tuples is None else tuples),
        task_loads=loads, makespan=float(loads.max()))


def test_heartbeat_monitor_matches_jax():
    port, ref = HeartbeatMonitor(patience=2), RefHeartbeatMonitor(patience=2)
    rows = [[5, 5, 5], [5, 0, 5], [5, 0, 5], [5, 0, 5], [5, 4, 5],
            [0, 0, 0], [0, 3, 0], [0, 3, 0], [2, 3, 0]]
    for i, loads in enumerate(rows, start=1):
        r = _report(i, loads, tuples=0 if i == 6 else None)
        assert port.observe(r) == ref.observe(r)
        assert port.flagged == ref.flagged
    assert port.flagged == {2}
    with pytest.raises(ValueError, match="patience"):
        HeartbeatMonitor(patience=0)


def test_loop_records_stalled_tasks_as_jax():
    """A task whose lane reads zero while traffic flows is flagged by the
    loop's monitor, on the same interval as in the JAX loop."""
    # theta_max 50: the controller never replans the silent lane away
    port = make_loop(True, make_stage(True, 5, 2, theta_max=50.0),
                     target_load=1e6, min_tasks=5, max_tasks=8)
    ref = make_loop(False, make_stage(False, 5, 2, theta_max=50.0),
                    target_load=1e6, min_tasks=5, max_tasks=8)
    # keys that all hash away from one task: a silent lane
    dest = ModHash(5, seed=2)(np.arange(4000, dtype=np.int64))
    keys = np.arange(4000, dtype=np.int64)[dest != 3][:600]
    for _ in range(4):
        port.step(keys)
        ref.step(keys)
    assert port.stalled_tasks == ref.stalled_tasks == [(3, 3)]
    assert_loops_identical(port, ref)


@pytest.mark.parametrize("bad", [0, -1, -7])
def test_scale_to_rejects_empty_fleet_before_any_mutation(bad):
    stage = make_stage(True, 4, 0, backend="object")
    stage.process_interval_arrays(np.arange(100, dtype=np.int64) % 23)
    before = len(stage.stores)
    with pytest.raises(ValueError, match="n_tasks >= 1"):
        stage.scale_to(bad)
    assert len(stage.stores) == before and stage.n_tasks == 4


def test_scale_to_router_rejection_fires_before_store_growth():
    controller = RebalanceController(Assignment(ModHash(4, seed=0)),
                                     BalanceConfig(theta_max=0.2, window=2),
                                     algorithm="pkg")
    stage = KeyedStage(PartialWordCount(), controller, window=2,
                       device="cpu")
    stage.process_interval_arrays(np.arange(100, dtype=np.int64) % 23)
    before = len(stage.stores)
    with pytest.raises(ValueError):
        stage.scale_to(8)
    assert len(stage.stores) == before and stage.n_tasks == 4
    fresh = make_stage(True, 4, 0)
    with pytest.raises(RuntimeError, match="at least one processed"):
        fresh.scale_to(6)
