"""The port's sketch-mode statistics against the JAX package's, on the CPU.

* ``CountMinSketch``, ``SpaceSavingTracker`` and ``SketchStats``: the same
  seeded batches give equal planes, tracker keys, counts, err, side
  counters, offset and snapshot fields (``base_loads`` included), and a
  JAX ``state_dict`` continues identically in the port.
* The controller's ``ingest``, ``observe`` and ``on_interval(None)``.
* Sketch-mode stages: the port's device backend on the ``"kernels"``
  substrate (``device="cpu"``, so each kernel's plain version runs) against
  the JAX device backend, and the port's columnar backend against the JAX
  columnar backend: identical reports, tables, triggered intervals,
  ``last_stats`` and held keys, through tracker truncation and ``scale_to``.
* ``load_reference_state`` with a sketch caught mid-interval.

Everything is float64 numpy on the host, so comparisons are strict
equality. The JAX stages here avoid ring width 6 (window 5), fleets of 6 or
9 tasks and hash seed 99: other test files count the JAX device steps'
traces under those signatures.
"""

import numpy as np
import pytest

from repro.core import Assignment as RefAssignment
from repro.core import BalanceConfig as RefConfig
from repro.core import RebalanceController as RefController
from repro.core.balancer import CountMinSketch as RefCMS
from repro.core.balancer import SketchConfig as RefSketchConfig
from repro.core.balancer import SketchStats as RefSketchStats
from repro.core.balancer import SpaceSavingTracker as RefTracker
from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.streams import KeyedStage as RefStage
from repro.streams import WordCount as RefWordCount
from repro.streams import WorkloadGen as RefGen
from repro_torch.convert import load_reference_state
from repro_torch.core import (Assignment, BalanceConfig, Hash32,
                              RebalanceController)
from repro_torch.core.balancer import (CountMinSketch, SketchConfig,
                                       SketchStats, SpaceSavingTracker)
from repro_torch.streams import KeyedStage, WordCount

REPORT_FIELDS = ("interval", "tuples", "makespan", "migration_stall",
                 "throughput", "skewness", "theta", "migrated_bytes",
                 "table_size", "buffered")
STATS_FIELDS = ("keys", "cost", "mem", "freq", "base_loads")


def _batches(seed, n_batches=6, domain=3000, size=4000):
    """Seeded (keys, cost, mem, freq) batches: zipf-ish repeated keys, then
    a sorted-unique batch (the pre-aggregated path) and a zero-cost batch
    (the engine's held-size fold)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        keys = (rng.zipf(1.3, size=size) % domain).astype(np.int64)
        if b % 3 == 1:
            keys = np.unique(keys)
        cost = rng.random(keys.size) * 4.0
        if b % 3 == 2:
            cost = np.zeros(keys.size)
        mem = rng.random(keys.size) * 100.0
        freq = rng.integers(1, 5, size=keys.size).astype(np.float64)
        out.append((keys, cost, mem, freq))
    return out


def _assert_tracker_equal(got, want):
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.err, want.err)
    for ch in ("cost", "mem", "freq"):
        np.testing.assert_array_equal(got.side(ch), want.side(ch))
    assert got.offset == want.offset
    assert got.total == want.total
    assert got.nbytes == want.nbytes


def _assert_stats_equal(got, want):
    for f in STATS_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


# -- the three sketch structures ------------------------------------------------

@pytest.mark.parametrize("width,depth,channels", [
    (1 << 10, 2, ("cost",)),
    (1000, 3, ("cost", "mem", "freq")),
], ids=["pow2_cost", "mod_all_channels"])
def test_count_min_sketch_matches_jax(width, depth, channels):
    got = CountMinSketch(width, depth, seed=11, channels=channels)
    want = RefCMS(width, depth, seed=11, channels=channels)
    probe = np.arange(0, 3000, 7, dtype=np.int64)
    for keys, cost, mem, freq in _batches(1):
        weights = {"cost": cost, "mem": mem, "freq": freq}
        got.update(keys, **{ch: weights[ch] for ch in channels})
        want.update(keys, **{ch: weights[ch] for ch in channels})
        for ch in channels:
            np.testing.assert_array_equal(got.planes[ch], want.planes[ch])
            np.testing.assert_array_equal(got.query(probe, ch),
                                          want.query(probe, ch))
    np.testing.assert_array_equal(got.state_dict()["seeds"],
                                  want.state_dict()["seeds"])
    assert got.nbytes == want.nbytes


@pytest.mark.parametrize("capacity", [16, 200, 4096],
                         ids=["truncating", "some_truncation", "covering"])
def test_space_saving_tracker_matches_jax(capacity):
    got, want = SpaceSavingTracker(capacity), RefTracker(capacity)
    probe = np.arange(0, 3000, 3, dtype=np.int64)
    for keys, cost, mem, freq in _batches(2):
        got.update(keys, cost, cost=cost, mem=mem, freq=freq)
        want.update(keys, cost, cost=cost, mem=mem, freq=freq)
        _assert_tracker_equal(got, want)
        np.testing.assert_array_equal(got.estimate(probe),
                                      want.estimate(probe))
    assert len(got) == len(want) <= capacity
    if capacity < 4096:
        assert got.offset > 0.0               # the tracker did truncate
    else:
        assert got.offset == 0.0


@pytest.mark.parametrize("capacity,channels", [
    (32, ("cost",)),
    (512, ("cost", "mem", "freq")),
])
def test_sketch_stats_snapshot_matches_jax(capacity, channels):
    n_dest = 7
    got = SketchStats(SketchConfig(width=256, depth=2, capacity=capacity,
                                   channels=channels), n_dest, seed=5)
    want = RefSketchStats(RefSketchConfig(width=256, depth=2,
                                          capacity=capacity,
                                          channels=channels), n_dest, seed=5)
    table = {3: 0, 17: 6, 2999: 2, 123456: 4}     # one key never streamed
    ga = Assignment(Hash32(n_dest, seed=5), dict(table))
    wa = RefAssignment(RefHash32(n_dest, seed=5), dict(table))
    for keys, cost, mem, freq in _batches(3):
        live = cost.any()
        got.update(keys, ga.dest(keys) if live else None, cost, mem=mem,
                   freq=freq)
        want.update(keys, wa.dest(keys) if live else None, cost, mem=mem,
                    freq=freq)
        _assert_tracker_equal(got.tracker, want.tracker)
        _assert_stats_equal(got.snapshot(ga), want.snapshot(wa))
    snap = got.snapshot(ga)
    assert snap.base_loads.shape == (n_dest,)
    assert 123456 in snap.keys.tolist()
    assert got.nbytes == want.nbytes
    # a shrunk fleet's stale snapshot truncates the totals as the JAX one does
    small = Assignment(Hash32(4, seed=5))
    _assert_stats_equal(got.snapshot(small),
                        want.snapshot(RefAssignment(RefHash32(4, seed=5))))
    # the JAX state_dict continues identically in the port
    resumed = SketchStats(got.config, n_dest, seed=0)
    resumed.load_state_dict(want.state_dict())
    keys, cost, mem, freq = _batches(4, n_batches=1)[0]
    resumed.update(keys, ga.dest(keys), cost, mem=mem, freq=freq)
    want.update(keys, wa.dest(keys), cost, mem=mem, freq=freq)
    _assert_tracker_equal(resumed.tracker, want.tracker)
    _assert_stats_equal(resumed.snapshot(ga), want.snapshot(wa))
    for ch, plane in want.cms.planes.items():
        np.testing.assert_array_equal(resumed.cms.planes[ch], plane)
    resumed.end_interval()
    want.end_interval()
    _assert_stats_equal(resumed.snapshot(ga), want.snapshot(wa))
    with pytest.raises(ValueError, match="geometry"):
        SketchStats(SketchConfig(width=512), n_dest).load_state_dict(
            want.state_dict())


# -- the controller ----------------------------------------------------------

def test_controller_sketch_events_match_jax():
    n_dest = 8
    kw = dict(theta_max=0.05, table_max=60, window=2)
    ref = RefController(RefAssignment(RefHash32(n_dest, seed=4)),
                        RefConfig(**kw), stats_mode="sketch",
                        sketch=RefSketchConfig(capacity=48))
    port = RebalanceController(Assignment(Hash32(n_dest, seed=4)),
                               BalanceConfig(**kw), stats_mode="sketch",
                               sketch=SketchConfig(capacity=48))
    assert port.sketch.cms.state_dict()["seeds"].tolist() == \
        ref.sketch.cms.state_dict()["seeds"].tolist()
    gen = RefGen(k=1500, z=1.1, f=0.8, seed=6, window=2)
    for i in range(4):
        stats = gen.interval(ref.assignment, fluctuate=i > 0)
        if i % 2:
            ev_r = ref.observe(stats.keys, stats.cost, stats.mem,
                               freq=stats.freq, interval=10 + i)
            ev_p = port.observe(stats.keys, stats.cost, stats.mem,
                                freq=stats.freq, interval=10 + i)
        else:
            half = stats.keys.size // 2
            for lo, hi in ((0, half), (half, stats.keys.size)):
                sl = slice(lo, hi)
                for c in (ref, port):
                    c.ingest(stats.keys[sl], stats.cost[sl],
                             mem=stats.mem[sl], freq=stats.freq[sl])
            ev_r, ev_p = ref.on_interval(None), port.on_interval(None)
        assert (ev_p.interval, ev_p.triggered, ev_p.theta_before) == \
            (ev_r.interval, ev_r.triggered, ev_r.theta_before)
        _assert_stats_equal(port.last_stats, ref.last_stats)
        assert port.last_stats.keys.size < stats.keys.size   # head only
        if ev_r.result is not None:
            assert ev_p.result.assignment.table == \
                ev_r.result.assignment.table
            np.testing.assert_array_equal(ev_p.result.loads,
                                          ev_r.result.loads)
        assert port.sketch.tracker.total == 0.0           # reset per round
    assert port.triggered_intervals() == ref.triggered_intervals()
    assert port.assignment_version == ref.assignment_version > 0
    assert port.assignment.table == ref.assignment.table


def test_controller_sketch_guards():
    a = Assignment(Hash32(4))
    exact = RebalanceController(a, BalanceConfig())
    assert exact.sketch is None
    keys = np.arange(10, dtype=np.int64)
    ev = exact.observe(keys, np.arange(10.0), np.ones(10), interval=3)
    assert ev.interval == 3 and ev.triggered
    np.testing.assert_array_equal(exact.last_stats.keys, keys)
    assert exact.last_stats.base_loads is None
    with pytest.raises(ValueError, match="ingest"):
        exact.ingest(np.arange(3), np.ones(3))
    with pytest.raises(ValueError, match="on_interval"):
        exact.on_interval(None)
    with pytest.raises(ValueError, match="sketch="):
        RebalanceController(a, BalanceConfig(), sketch=SketchConfig())
    with pytest.raises(ValueError, match="stats_mode"):
        RebalanceController(a, BalanceConfig(), stats_mode="approx")
    sk = RebalanceController(a, BalanceConfig(), stats_mode="sketch")
    assert sk.sketch.config == SketchConfig()
    sk.ingest(np.zeros(0, np.int64), np.zeros(0))         # empty: a no-op
    assert sk.sketch.tracker.total == 0.0


# -- sketch-mode stages against the JAX package's ----------------------------

def ref_stage(backend, algorithm="mixed", n_tasks=7, window=3, seed=3,
              capacity=64, table_max=100):
    ctrl = RefController(
        RefAssignment(RefHash32(n_tasks, seed=seed)),
        RefConfig(theta_max=0.03, table_max=table_max, window=window),
        algorithm=algorithm, stats_mode="sketch",
        sketch=RefSketchConfig(capacity=capacity))
    return RefStage(RefWordCount(), ctrl, window=window, vectorized=True,
                    state_backend=backend)


def port_stage(backend, algorithm="mixed", n_tasks=7, window=3, seed=3,
               capacity=64, table_max=100):
    ctrl = RebalanceController(
        Assignment(Hash32(n_tasks, seed=seed)),
        BalanceConfig(theta_max=0.03, table_max=table_max, window=window),
        algorithm=algorithm, stats_mode="sketch",
        sketch=SketchConfig(capacity=capacity))
    return KeyedStage(WordCount(), ctrl, window=window, state_backend=backend,
                      substrate="kernels", device="cpu")


def assert_sketch_stages_identical(got, want):
    assert len(got.reports) == len(want.reports)
    for rg, rw in zip(got.reports, want.reports):
        for field in REPORT_FIELDS:
            assert getattr(rg, field) == getattr(rw, field), field
        np.testing.assert_array_equal(rg.task_loads, rw.task_loads)
    assert got.controller.assignment.table == want.controller.assignment.table
    assert got.controller.triggered_intervals() == \
        want.controller.triggered_intervals()
    _assert_stats_equal(got.last_stats, want.last_stats)
    assert got.last_stats is got.controller.last_stats
    assert got.total_state_keys() == want.total_state_keys()
    assert got.outputs == want.outputs
    assert got.emitted_sum == want.emitted_sum


@pytest.mark.parametrize("backend,algorithm,capacity,scale_step", [
    ("device", "mixed", 48, 5),
    ("columnar", "mixed", 48, 5),
    ("columnar", "minmig", 4096, None),
    ("columnar", "compact_mixed", 32, 8),
], ids=["device_truncating_scale_in", "columnar_truncating_scale_in",
        "columnar_covering", "columnar_compact_scale_out"])
def test_sketch_stage_matches_jax(backend, algorithm, capacity, scale_step):
    stages = [port_stage(backend, algorithm, capacity=capacity),
              ref_stage(backend, algorithm, capacity=capacity)]
    gen = RefGen(k=4000, z=1.0, f=0.8, seed=5, window=3)
    for i in range(5):
        if i:
            gen.interval(stages[1].controller.assignment)
        keys = gen.draw_tuples(12000).astype(np.int64)
        emits = [s.process_interval_emits(keys)[1:] for s in stages]
        np.testing.assert_array_equal(emits[0][0], emits[1][0])
        np.testing.assert_array_equal(emits[0][1], emits[1][1])
        if i == 2 and scale_step is not None:
            for s in stages:
                s.scale_to(scale_step)
            assert stages[0]._migrated_bytes_pending == \
                stages[1]._migrated_bytes_pending
        assert_sketch_stages_identical(*stages)
    tracker_bound = capacity + stages[0].controller.assignment.table_size
    assert stages[0].last_stats.keys.size <= tracker_bound
    assert stages[0].last_stats.base_loads is not None
    assert len(stages[0].controller.triggered_intervals()) > 1
    # an idle interval folds only held sizes (zero cost) and still closes
    for s in stages:
        s.process_interval_arrays(np.zeros(0, np.int64))
    assert_sketch_stages_identical(*stages)


# -- carrying a sketch-mode JAX stage across ---------------------------------

def _snapshot(stage):
    ck = stage.backend.checkpoint()
    a = stage.controller.assignment
    tk, td = a.table_arrays()
    ls = stage.last_stats
    return {
        "packs": [dict(keys=p.keys, vals=p.vals, sizes=p.sizes,
                       present=p.present, col_iv=p.col_iv)
                  for p in ck["packs"]],
        "col_iv": ck.get("col_iv", np.full(stage.window + 1, -1)),
        "table_keys": tk, "table_dests": td,
        "n_dest": a.n_dest, "hash_seed": a.hash_router.seed,
        "assignment_version": stage.controller.assignment_version,
        "last_stats": dict(keys=ls.keys, cost=ls.cost, mem=ls.mem,
                           freq=ls.freq, base_loads=ls.base_loads),
        "interval": stage._interval,
        "pending_delta": stage._pending_delta_arr,
        "migrated_bytes_pending": stage._migrated_bytes_pending,
        "plan_time_pending": stage._plan_time_pending,
        "output_keys": np.fromiter(stage.outputs.keys(), dtype=np.int64),
        "output_values": np.fromiter(stage.outputs.values(), dtype=np.int64),
        "emitted_sum": stage.emitted_sum,
        "sketch": stage.controller.sketch.state_dict(),
    }


def test_load_reference_state_carries_the_sketch():
    ref = ref_stage("columnar", n_tasks=5, capacity=40)
    gen = RefGen(k=3000, z=1.1, f=0.8, seed=9, window=3)
    for i in range(3):
        if i:
            gen.interval(ref.controller.assignment)
        ref.process_interval_arrays(gen.draw_tuples(8000).astype(np.int64))
    # a partial fold caught mid-interval: the next round plans on it too
    extra = np.arange(0, 400, 3, dtype=np.int64)
    ref.controller.ingest(extra, np.full(extra.size, 25.0),
                          freq=np.ones(extra.size))
    snap = _snapshot(ref)
    assert snap["sketch"]["tracker"]["total"] > 0.0
    exact = KeyedStage(WordCount(), RebalanceController(
        Assignment(Hash32(5, seed=3)), BalanceConfig(window=3)), window=3,
        state_backend="columnar", device="cpu")
    with pytest.raises(ValueError, match="stats_mode='sketch'"):
        load_reference_state(exact, snap)
    ports = [port_stage(b, n_tasks=5, capacity=40)
             for b in ("columnar", "device")]
    n_before = len(ref.reports), len(ref.controller.history)
    for port in ports:
        load_reference_state(port, snap)
        _assert_stats_equal(port.last_stats, ref.last_stats)
    for _ in range(3):
        gen.interval(ref.controller.assignment)
        keys = gen.draw_tuples(8000).astype(np.int64)
        ref.process_interval_arrays(keys)
        for port in ports:
            port.process_interval_arrays(keys)
    ref.reports = ref.reports[n_before[0]:]
    ref.controller.history = ref.controller.history[n_before[1]:]
    assert ref.controller.triggered_intervals()
    for port in ports:
        assert_sketch_stages_identical(port, ref)
