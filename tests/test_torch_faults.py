"""The port's failure injection and restore-and-replay recovery against the
JAX package's, on the CPU.

The recovery-lossless property: the same recorded traffic through a
fault-free stage and through a stage under ``ChaosRunner`` (kills at both
crash sites, dropped and duplicated deliveries, store stalls) gives
identical ``IntervalReport`` streams, task loads, outputs, emitted sums and
held keys — on the object, columnar and device (``device="cpu"``)
backends and on the per-tuple loop. The port's runner also reproduces the
JAX runner's ``RecoveryEvent`` list and reports bit for bit on the same
trace. (The JAX package's own ``[sharded]`` chaos legs fail on this tree
and are no oracle; its device backend is not used here — the port's device
ring is held against the JAX object and columnar stages, whose reports it
equals.)

Also: delivery faults, stall healing, a kill before the first cadence
checkpoint, checkpoint transparency, the disk round trip through
``CheckpointStore`` into a fresh stage, sketch-mode controller state across
recovery, a seeded loop of random fault schedules, and the injector's
sites.

The JAX stages avoid ring width 6 (window 5), fleets of 6 or 9 tasks and
hash seed 99: other test files count the JAX device steps' traces under
those signatures.
"""

import numpy as np
import pytest

from repro.core import Assignment as RefAssignment
from repro.core import BalanceConfig as RefConfig
from repro.core import RebalanceController as RefController
from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.streams import ChaosRunner as RefChaosRunner
from repro.streams import DropDelivery as RefDrop
from repro.streams import DuplicateDelivery as RefDuplicate
from repro.streams import FaultPlan as RefFaultPlan
from repro.streams import KeyedStage as RefStage
from repro.streams import KillTask as RefKill
from repro.streams import StallTask as RefStall
from repro.streams import WordCount as RefWordCount
from repro.streams import WorkloadGen as RefGen
from repro_torch.core import (Assignment, BalanceConfig, Hash32,
                              RebalanceController)
from repro_torch.core.balancer import SketchConfig
from repro_torch.streams import (ChaosRunner, CheckpointStore, DropDelivery,
                                 DuplicateDelivery, FaultInjector, FaultPlan,
                                 KeyedStage, KillTask, RecoveryEvent,
                                 StallTask, TaskKilled, TaskStalled,
                                 WordCount, checkpoint_stage, restore_stage)

REPORT_FIELDS = ("interval", "tuples", "makespan", "migration_stall",
                 "throughput", "skewness", "theta", "migrated_bytes",
                 "table_size", "buffered")

#: the port's backend under test -> the JAX backend its reports equal
LEGS = {"object": "object", "columnar": "columnar", "device": "columnar",
        "per_tuple": "per_tuple"}

#: the chip phase's fault plan (``chip_smoke.py``), by fault kind
CHIP_PLAN = (("kill", 3, "mid"), ("kill", 4, "deliver"), ("drop", 5),
             ("duplicate", 6), ("stall", 7, 2), ("kill", 8, "mid"))


def make_stage(port, leg="object", n_tasks=7, window=3, theta_max=0.05,
               table_max=400, seed=0, stats_mode="exact", **kwargs):
    """WordCount under Mixed. ``leg`` "per_tuple" is the object store's
    per-tuple loop; the device leg needs Hash32 (every leg takes it, so one
    trace serves all)."""
    vectorized = leg != "per_tuple"
    backend = "object" if leg == "per_tuple" else leg
    if port:
        controller = RebalanceController(
            Assignment(Hash32(n_tasks, seed=seed)),
            BalanceConfig(theta_max=theta_max, table_max=table_max,
                          window=window),
            algorithm="mixed", stats_mode=stats_mode,
            sketch=SketchConfig(capacity=64) if stats_mode == "sketch"
            else None)
        return KeyedStage(WordCount(), controller, window=window,
                          state_backend=backend, vectorized=vectorized,
                          device="cpu", **kwargs)
    from repro.core.balancer.sketch import SketchConfig as RefSketchConfig
    controller = RefController(
        RefAssignment(RefHash32(n_tasks, seed=seed)),
        RefConfig(theta_max=theta_max, table_max=table_max, window=window),
        algorithm="mixed", stats_mode=stats_mode,
        sketch=RefSketchConfig(capacity=64) if stats_mode == "sketch"
        else None)
    return RefStage(RefWordCount(), controller, window=window,
                    state_backend=LEGS[leg] if vectorized else "object",
                    vectorized=vectorized, **kwargs)


def make_trace(n_iv=10, n_tuples=600, k=800, seed=2, window=3):
    """A per-interval key trace recorded once; every stage under test sees
    the same arrays."""
    gen = RefGen(k=k, z=1.1, f=0.8, seed=seed, window=window)
    pilot = make_stage(False, window=window)
    out = []
    for i in range(n_iv):
        gen.interval(pilot.controller.assignment, fluctuate=i > 0)
        keys = gen.draw_tuples(n_tuples).astype(np.int64)
        out.append(keys)
        pilot.process_interval_arrays(keys)
    return out


@pytest.fixture(scope="module")
def trace():
    return make_trace()


def plan(port, spec):
    """A FaultPlan of either package from ``(kind, interval, arg)`` rows."""
    if port:
        kill, drop, dup, stall, fp = KillTask, DropDelivery, \
            DuplicateDelivery, StallTask, FaultPlan
    else:
        kill, drop, dup, stall, fp = RefKill, RefDrop, RefDuplicate, \
            RefStall, RefFaultPlan
    faults = []
    for row in spec:
        kind, iv = row[0], row[1]
        if kind == "kill":
            faults.append(kill(interval=iv, task=iv % 3, site=row[2]))
        elif kind == "stall":
            faults.append(stall(interval=iv, task=1, attempts=row[2]))
        elif kind == "drop":
            faults.append(drop(interval=iv))
        else:
            faults.append(dup(interval=iv))
    return fp(faults)


def assert_reports_identical(got, want):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for field in REPORT_FIELDS:
            assert getattr(rg, field) == getattr(rw, field), \
                (rw.interval, field)
        np.testing.assert_array_equal(np.asarray(rg.task_loads),
                                      np.asarray(rw.task_loads))


def assert_same_run(got, want):
    assert_reports_identical(got.reports, want.reports)
    assert got.outputs == want.outputs
    assert got.emitted_sum == want.emitted_sum
    assert got.total_state_keys() == want.total_state_keys()
    assert got.controller.assignment.table == want.controller.assignment.table


def events(runner):
    return [(e.interval, e.kind, e.replayed) for e in runner.events]


def run_plain(stage, trace):
    for keys in trace:
        stage.process_interval_arrays(keys)
    return stage


def run_chaos(stage, spec, trace, port=True, every=2, **kw):
    cls = ChaosRunner if port else RefChaosRunner
    runner = cls(stage, plan(port, spec), checkpoint_every=every, **kw)
    for keys in trace:
        runner.process_interval(keys)
    return runner


# -- the recovery-lossless property -------------------------------------------

@pytest.mark.parametrize("leg", sorted(LEGS))
def test_kill_recovery_is_lossless_and_matches_jax(leg, trace):
    """Kills at both crash sites restore and replay to the fault-free
    stage's exact run, and to the JAX runner's events and reports."""
    spec = (("kill", 3, "mid"), ("kill", 5, "deliver"), ("kill", 7, "mid"))
    oracle = run_plain(make_stage(True, leg), trace)
    stage = make_stage(True, leg)
    runner = run_chaos(stage, spec, trace)
    ref = make_stage(False, leg)
    ref_runner = run_chaos(ref, spec, trace, port=False)
    assert [(e.interval, e.kind) for e in runner.events] == \
        [(3, "kill@mid"), (5, "kill@deliver"), (7, "kill@mid")]
    assert events(runner) == events(ref_runner)
    assert_same_run(stage, oracle)
    assert_same_run(stage, ref)


@pytest.mark.parametrize("leg", ["object", "columnar", "device"])
def test_chip_fault_plan_matches_jax(leg, trace):
    """The chip phase's six-fault plan at a small size: one RecoveryEvent a
    fault, the JAX runner's list, and a lossless run."""
    oracle = run_plain(make_stage(True, leg), trace)
    stage = make_stage(True, leg)
    runner = run_chaos(stage, CHIP_PLAN, trace)
    ref_runner = run_chaos(make_stage(False, leg), CHIP_PLAN, trace,
                           port=False)
    assert len(runner.events) == len(CHIP_PLAN)
    assert events(runner) == events(ref_runner)
    assert_same_run(stage, oracle)
    assert_reports_identical(stage.reports, ref_runner.stage.reports)
    assert all(isinstance(e, RecoveryEvent) for e in runner.events)
    assert runner.buffered_intervals() == []      # the last cadence trimmed


@pytest.mark.parametrize("leg", ["object", "columnar"])
def test_delivery_faults_are_recovered(leg, trace):
    spec = (("drop", 4), ("duplicate", 7))
    oracle = run_plain(make_stage(True, leg), trace)
    stage = make_stage(True, leg)
    runner = run_chaos(stage, spec, trace)
    ref_runner = run_chaos(make_stage(False, leg), spec, trace, port=False)
    assert [(e.interval, e.kind) for e in runner.events] == \
        [(4, "drop"), (7, "duplicate")]
    assert events(runner) == events(ref_runner)
    assert_same_run(stage, oracle)


@pytest.mark.parametrize("leg", ["columnar", "device"])
def test_stall_heals_under_retry_and_is_lossless(leg, trace):
    spec = (("stall", 4, 3),)
    oracle = run_plain(make_stage(True, leg), trace)
    stage = make_stage(True, leg)
    runner = run_chaos(stage, spec, trace, every=3)
    ref_runner = run_chaos(make_stage(False, leg), spec, trace, port=False,
                           every=3)
    assert [e.kind for e in runner.events] == ["stall@deliver"]
    assert runner.events[0].replayed >= 1
    assert events(runner) == events(ref_runner)
    assert_same_run(stage, oracle)


@pytest.mark.parametrize("leg", ["object", "device"])
def test_kill_before_first_cadence_checkpoint(leg, trace):
    """Recovery from the interval-0 snapshot the runner takes at
    construction."""
    oracle = run_plain(make_stage(True, leg), trace)
    stage = make_stage(True, leg)
    runner = run_chaos(stage, (("kill", 1, "mid"),), trace, every=4)
    assert events(runner) == [(1, "kill@mid", 1)]
    assert_same_run(stage, oracle)


# -- checkpoints ----------------------------------------------------------------

@pytest.mark.parametrize("leg", ["object", "per_tuple", "columnar", "device"])
def test_checkpointing_is_observationally_free(leg, trace):
    plain = run_plain(make_stage(True, leg), trace)
    stage = make_stage(True, leg)
    for keys in trace:
        stage.process_interval_arrays(keys)
        checkpoint_stage(stage)
    assert_same_run(stage, plain)


@pytest.mark.parametrize("leg", ["object", "per_tuple"])
def test_restore_rewinds_and_replays_identically(leg, trace):
    stage = make_stage(True, leg)
    run_plain(stage, trace[:5])
    ckpt = checkpoint_stage(stage)
    run_plain(stage, trace[5:])
    first = list(stage.reports)
    for _ in range(2):                    # one checkpoint restores twice
        restore_stage(stage, ckpt)
        assert stage._interval == 5
        run_plain(stage, trace[5:])
        assert_reports_identical(stage.reports, first)


@pytest.mark.parametrize("leg", ["object", "device"])
def test_disk_roundtrip_into_fresh_stage(leg, tmp_path, trace):
    store = CheckpointStore(tmp_path / "ckpts")
    src = make_stage(True, leg)
    run_plain(src, trace[:6])
    store.save(checkpoint_stage(src))
    run_plain(src, trace[6:])
    fresh = make_stage(True, leg)
    ckpt = store.load_latest()
    assert ckpt.interval == 6 == store.latest_interval()
    restore_stage(fresh, ckpt)
    run_plain(fresh, trace[6:])
    assert_same_run(fresh, src)


def test_runner_persists_cadence_checkpoints(tmp_path, trace):
    store = CheckpointStore(tmp_path, keep=2)
    stage = make_stage(True, "object")
    runner = run_chaos(stage, (("kill", 5, "mid"),), trace, every=3,
                       store=store)
    assert store.latest_interval() == 9
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.pkl")) == \
        ["ckpt_00000006.pkl", "ckpt_00000009.pkl"]
    assert runner.buffered_intervals() == [10]
    fresh = make_stage(True, "object")
    restore_stage(fresh, store.load_latest())
    fresh.process_interval_arrays(trace[9])
    assert_reports_identical(fresh.reports, stage.reports)


@pytest.mark.parametrize("leg", ["columnar", "device"])
def test_sketch_mode_controller_state_survives_recovery(leg, trace):
    """The checkpoint carries the count-min planes and the SpaceSaving
    head, so the replanning after a restore matches the fault-free run and
    the JAX runner."""
    spec = (("kill", 4, "mid"), ("drop", 8))
    oracle = run_plain(make_stage(True, leg, stats_mode="sketch"), trace)
    stage = make_stage(True, leg, stats_mode="sketch")
    runner = run_chaos(stage, spec, trace)
    ref = make_stage(False, leg, stats_mode="sketch")
    ref_runner = run_chaos(ref, spec, trace, port=False)
    assert events(runner) == events(ref_runner)
    assert len(runner.events) == 2
    assert_same_run(stage, oracle)
    assert_reports_identical(stage.reports, ref.reports)
    assert stage.controller.triggered_intervals() == \
        ref.controller.triggered_intervals()


def test_random_fault_schedules_recover_losslessly():
    """A seeded loop over fault schedules (kill interval and site, cadence,
    an optional dropped delivery) on both host backends, each held against
    the fault-free run and the JAX runner."""
    short = make_trace(n_iv=6, n_tuples=300, k=300, seed=5)
    oracles = {leg: run_plain(make_stage(True, leg), short)
               for leg in ("object", "columnar")}
    rng = np.random.default_rng(20)
    for _ in range(12):
        leg = ("object", "columnar")[int(rng.integers(2))]
        kill_iv = int(rng.integers(1, 7))
        site = ("deliver", "mid")[int(rng.integers(2))]
        every = int(rng.integers(1, 4))
        drop_iv = int(rng.integers(0, 7))          # 0: no drop
        spec = [("kill", kill_iv, site)]
        if drop_iv and drop_iv != kill_iv:
            spec.append(("drop", drop_iv))
        stage = make_stage(True, leg)
        runner = run_chaos(stage, spec, short, every=every)
        ref_runner = run_chaos(make_stage(False, leg), spec, short,
                               port=False, every=every)
        assert len(runner.events) == len(spec)
        assert events(runner) == events(ref_runner)
        assert_same_run(stage, oracles[leg])


# -- the injector ----------------------------------------------------------------

def test_injector_sites_and_fault_validation():
    with pytest.raises(ValueError, match="fail site"):
        KillTask(interval=1, site="late")
    with pytest.raises(ValueError, match="attempts"):
        StallTask(interval=1, attempts=0)
    with pytest.raises(TypeError, match="unknown fault"):
        FaultPlan(["kill"])
    with pytest.raises(ValueError, match="checkpoint_every"):
        ChaosRunner(make_stage(True, "object"), checkpoint_every=0)
    p = FaultPlan([KillTask(interval=2, task=3, site="deliver"),
                   KillTask(interval=2, site="mid"),
                   StallTask(interval=3, task=1, attempts=2),
                   DropDelivery(interval=4)])
    assert p.take_delivery_fault(4) == (0, "drop")
    assert p.take_delivery_fault(4) == (1, None)       # consumed
    stage = make_stage(True, "columnar")
    inj = FaultInjector(p).install(stage)
    assert stage.failpoint is inj
    stage._interval = 1
    with pytest.raises(TaskKilled) as e:
        stage._failpoint("deliver")                  # interval 2 arriving
    assert (e.value.task, e.value.interval, e.value.site) == \
        (3, 2, "deliver")
    stage._failpoint("deliver")                      # fired once only
    stage._interval = 2
    with pytest.raises(TaskKilled):
        stage._failpoint("mid")
    for _ in range(2):
        with pytest.raises(TaskStalled):
            stage._failpoint("deliver")              # interval 3, 2 tries
    stage._failpoint("deliver")                      # healed
    stage.failpoint = None
    stage._failpoint("mid")                          # no seam: no-op


def test_uncaught_fault_propagates_without_a_report(trace):
    """Outside a runner a kill at "mid" leaves the interval half-applied
    and unreported; a restore discards it."""
    stage = make_stage(True, "device")
    run_plain(stage, trace[:2])
    ckpt = checkpoint_stage(stage)
    FaultInjector(FaultPlan([KillTask(interval=3, site="mid")])) \
        .install(stage)
    with pytest.raises(TaskKilled):
        stage.process_interval_arrays(trace[2])
    assert len(stage.reports) == 2 and stage._interval == 3
    restore_stage(stage, ckpt)
    run_plain(stage, trace[2:])
    assert_same_run(stage, run_plain(make_stage(True, "device"), trace))
