"""The port's interval protocol against the JAX package's, end to end on
the CPU.

* The port's device backend on the ``"kernels"`` substrate (``device="cpu"``,
  so each kernel's plain PyTorch version runs) and on ``"numpy"`` (the plain
  dense route), and its columnar backend, against the JAX ``state_backend="device"`` stage and the JAX object-store
  oracle: identical IntervalReport streams, task loads, outputs, emit
  streams and ``key_location``, through rebalances, window eviction and
  ``scale_to``, in add and max mode. Every compared quantity is an exact
  dyadic (integer counts; the self-join pinned to ``probe_cost=1/64``), so
  comparisons are strict equality.
* The port's columnar + ``"kernels"`` stage against the JAX columnar +
  ``"pallas"`` stage (Pallas in interpret mode): routing is integer and
  exact, stats are float32 and agree to 1e-6 relative.
* ``load_reference_state``: a JAX stage's state carried into a port stage
  mid-run; both then compute identical intervals.

The JAX stages here avoid ring width 6 (window 5), fleets of 6 or 9 tasks
and hash seed 99: other test files count the JAX device steps' traces under
those signatures.
"""

import numpy as np
import pytest

from repro.core import Assignment as RefAssignment
from repro.core import BalanceConfig as RefConfig
from repro.core import RebalanceController as RefController
from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.streams import KeyedStage as RefStage
from repro.streams import MergeCounts as RefMergeCounts
from repro.streams import WindowedSelfJoin as RefSelfJoin
from repro.streams import WordCount as RefWordCount
from repro.streams import WorkloadGen as RefGen
from repro_torch.convert import load_reference_state
from repro_torch.core import (Assignment, BalanceConfig, Hash32,
                              RebalanceController)
from repro_torch.streams import (KeyedStage, MergeCounts, WindowedSelfJoin,
                                 WordCount, WorkloadGen)

REPORT_FIELDS = ("interval", "tuples", "makespan", "migration_stall",
                 "throughput", "skewness", "theta", "migrated_bytes",
                 "table_size", "buffered")


def ref_stage(op, backend, n_tasks=5, window=3, theta_max=0.05,
              table_max=300, seed=1, **kwargs):
    controller = RefController(
        RefAssignment(RefHash32(n_tasks, seed=seed)),
        RefConfig(theta_max=theta_max, table_max=table_max, window=window),
        algorithm="mixed")
    return RefStage(op, controller, window=window, vectorized=True,
                    state_backend=backend, **kwargs)


def port_stage(op, backend, n_tasks=5, window=3, theta_max=0.05,
               table_max=300, seed=1, substrate="kernels", **kwargs):
    controller = RebalanceController(
        Assignment(Hash32(n_tasks, seed=seed)),
        BalanceConfig(theta_max=theta_max, table_max=table_max,
                      window=window),
        algorithm="mixed")
    return KeyedStage(op, controller, window=window, state_backend=backend,
                      substrate=substrate, device="cpu", **kwargs)


def assert_same_reports(got, want):
    assert len(got.reports) == len(want.reports)
    for rg, rw in zip(got.reports, want.reports):
        for field in REPORT_FIELDS:
            assert getattr(rg, field) == getattr(rw, field), field
        np.testing.assert_array_equal(rg.task_loads, rw.task_loads)


def assert_stages_identical(got, want):
    assert_same_reports(got, want)
    assert got.outputs == want.outputs
    assert got.emitted_sum == want.emitted_sum
    assert got.total_state_keys() == want.total_state_keys()
    assert got.controller.assignment.table == want.controller.assignment.table
    held = set()
    for store in want.stores:
        held.update(store.keys)
    for k in held:
        loc = want.key_location(k)
        assert got.key_location(k) == loc, k
        assert len(loc) == 1, k


# -- device and columnar backends vs the JAX device stage and object oracle --

@pytest.mark.parametrize("seed,z,f,window,theta,op_kind,scale_step", [
    (2, 1.1, 0.8, 3, 0.0, "wordcount", None),
    (11, 0.9, 1.0, 4, 0.03, "selfjoin", 7),
    (23, 1.2, 0.3, 2, 0.0, "wordcount", 3),
], ids=["wordcount_rebalance", "selfjoin_scale_out", "wordcount_scale_in"])
def test_port_matches_jax_device_and_object(seed, z, f, window, theta,
                                            op_kind, scale_step):
    def op(port):
        if op_kind == "wordcount":
            return WordCount() if port else RefWordCount()
        return (WindowedSelfJoin(probe_cost=1.0 / 64) if port
                else RefSelfJoin(probe_cost=1.0 / 64))

    kw = dict(window=window, theta_max=theta, table_max=250, seed=seed % 13)
    stages = [port_stage(op(True), "device", **kw),
              port_stage(op(True), "device", substrate="numpy", **kw),
              port_stage(op(True), "columnar", **kw),
              ref_stage(op(False), "device", **kw),
              ref_stage(op(False), "object", **kw)]
    gens = [WorkloadGen(k=400, z=z, f=f, seed=seed, window=window)
            for _ in range(3)] + \
        [RefGen(k=400, z=z, f=f, seed=seed, window=window) for _ in range(2)]
    for i in range(5):
        keys = emits = None
        for gen, stage in zip(gens, stages):
            if i:
                gen.interval(stage.controller.assignment)
            drawn = gen.draw_tuples(1000).astype(np.int64)
            if keys is None:
                keys = drawn
            else:
                np.testing.assert_array_equal(drawn, keys)
            _, ek, ev = stage.process_interval_emits(drawn, np.full(1000, i))
            if emits is None:
                emits = (ek, ev)
            else:
                np.testing.assert_array_equal(ek, emits[0])
                np.testing.assert_array_equal(ev, emits[1])
        if scale_step is not None and i == 2:
            for stage in stages:
                stage.scale_to(scale_step)
            assert len({s._migrated_bytes_pending for s in stages}) == 1
    assert any(r.table_size > 0 for r in stages[-1].reports)
    for stage in stages[:-1]:
        assert_stages_identical(stage, stages[-1])


try:                                    # optional [test] extra
    from hypothesis import given, settings, strategies as st
except ImportError:                     # pragma: no cover - bare env
    pass
else:
    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1),
           z=st.floats(0.6, 1.3),
           f=st.floats(0.0, 1.2),
           window=st.integers(2, 4),
           theta=st.sampled_from([0.0, 0.03, 0.2]),
           selfjoin=st.booleans(),
           scale_step=st.sampled_from([None, 3, 7]))
    def test_port_device_matches_jax_object_property(seed, z, f, window,
                                                     theta, selfjoin,
                                                     scale_step):
        """Randomized workloads: the port's device ring on the kernels
        substrate against the JAX object-store oracle."""
        kw = dict(window=window, theta_max=theta, table_max=250,
                  seed=seed % 13)
        stages = [port_stage(WindowedSelfJoin(probe_cost=1.0 / 64)
                             if selfjoin else WordCount(), "device", **kw),
                  ref_stage(RefSelfJoin(probe_cost=1.0 / 64)
                            if selfjoin else RefWordCount(), "object", **kw)]
        gens = [WorkloadGen(k=400, z=z, f=f, seed=seed, window=window),
                RefGen(k=400, z=z, f=f, seed=seed, window=window)]
        for i in range(4):
            for gen, stage in zip(gens, stages):
                if i:
                    gen.interval(stage.controller.assignment)
                drawn = gen.draw_tuples(800).astype(np.int64)
                stage.process_interval_arrays(drawn, np.full(800, i))
            if scale_step is not None and i == 1:
                for stage in stages:
                    stage.scale_to(scale_step)
        assert_stages_identical(*stages)


def test_port_max_mode_matches_jax_device_and_object():
    """MergeCounts folds with a scatter-max on the device ring."""
    rng = np.random.default_rng(3)
    stages = [port_stage(MergeCounts(), "device", window=2),
              port_stage(MergeCounts(), "columnar", window=2),
              ref_stage(RefMergeCounts(), "device", window=2),
              ref_stage(RefMergeCounts(), "object", window=2)]
    for i in range(4):
        keys = rng.integers(0, 150, size=1200).astype(np.int64)
        vals = rng.integers(1, 40, size=1200)
        if i == 2:
            keys = keys[:0]                   # an idle interval evicts
            vals = vals[:0]
        for stage in stages:
            stage.process_interval_arrays(keys, vals)
    for stage in stages[:-1]:
        assert_stages_identical(stage, stages[-1])


def test_port_device_empty_intervals_and_eviction():
    stages = [port_stage(WordCount(), "device", window=2),
              ref_stage(RefWordCount(), "object", window=2)]
    for stage in stages:
        stage.process_interval_arrays(np.array([1, 2, 3], dtype=np.int64))
        for _ in range(3):                       # idle intervals: state ages out
            stage.process_interval_arrays(np.zeros(0, dtype=np.int64))
    assert_stages_identical(*stages)
    assert stages[0].total_state_keys() == 0


def test_port_device_rejects_out_of_domain_keys_and_values():
    stage = port_stage(WordCount(), "device", device_domain_max=1 << 12)
    with pytest.raises(ValueError, match="non-negative"):
        stage.process_interval_arrays(np.array([3, -1], dtype=np.int64))
    with pytest.raises(ValueError, match="device_domain_max"):
        stage.process_interval_arrays(np.array([1 << 12], dtype=np.int64))
    stage = port_stage(MergeCounts(), "device")
    with pytest.raises(ValueError, match="int32"):
        stage.process_interval_arrays(np.array([1], dtype=np.int64),
                                      np.array([1 << 40]))


# -- columnar + kernels vs JAX columnar + pallas -----------------------------

def test_port_kernels_stats_match_jax_pallas():
    kw = dict(n_tasks=7, window=2, seed=4)
    stages = [port_stage(WordCount(), "columnar", substrate="kernels", **kw),
              ref_stage(RefWordCount(), "columnar", substrate="pallas", **kw),
              port_stage(WordCount(), "columnar", substrate="numpy", **kw)]
    gens = [WorkloadGen(k=500, z=1.1, f=0.8, seed=7, window=2),
            RefGen(k=500, z=1.1, f=0.8, seed=7, window=2),
            WorkloadGen(k=500, z=1.1, f=0.8, seed=7, window=2)]
    for i in range(4):
        keys = None
        for gen, stage in zip(gens, stages):
            if i:
                gen.interval(stage.controller.assignment)
            drawn = gen.draw_tuples(2000).astype(np.int64)
            if keys is None:
                keys = drawn
            else:
                np.testing.assert_array_equal(drawn, keys)
            stage.process_interval_arrays(drawn, None)
        port, ref, plain = stages
        np.testing.assert_array_equal(port.last_stats.keys,
                                      ref.last_stats.keys)
        np.testing.assert_array_equal(port.last_stats.freq,
                                      ref.last_stats.freq)
        np.testing.assert_allclose(port.last_stats.cost, ref.last_stats.cost,
                                   rtol=1e-6)
        np.testing.assert_allclose(port.last_stats.cost,
                                   plain.last_stats.cost, rtol=1e-6)
    for rp, rr in zip(stages[0].reports, stages[1].reports):
        # routing is integer-exact, so migration/table decisions coincide
        assert rp.table_size == rr.table_size
        assert rp.migrated_bytes == rr.migrated_bytes
        assert rp.buffered == rr.buffered
        np.testing.assert_allclose(rp.task_loads, rr.task_loads, rtol=1e-5)
    assert stages[0].outputs == stages[1].outputs == stages[2].outputs
    assert any(r.table_size > 0 for r in stages[1].reports)


def test_kernels_substrate_routing_cache_and_validation():
    stage = port_stage(WordCount(), "columnar", n_tasks=7, seed=4)
    keys = np.arange(512, dtype=np.int64)
    stage.controller.assignment.table = {int(k): 0 for k in range(129)}
    np.testing.assert_array_equal(stage._dest_batch(keys),
                                  stage.controller.assignment.dest(keys))
    assert stage._table_capacity == 256
    stage.controller.assignment.table = {int(k): 1 for k in range(100)}
    stage.controller.assignment_version += 1
    np.testing.assert_array_equal(stage._dest_batch(keys),
                                  stage.controller.assignment.dest(keys))
    assert stage._table_capacity == 256          # high-water, never shrinks
    assert len(stage._route_cache[1]) == 256
    with pytest.raises(ValueError, match=r"\[0, 2\^31\)"):
        stage._dest_batch(np.array([2**31], dtype=np.int64))


def test_stage_validation():
    c = RebalanceController(Assignment(Hash32(4)), BalanceConfig())
    with pytest.raises(ValueError, match="substrate"):
        KeyedStage(WordCount(), c, substrate="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown state backend"):
        KeyedStage(WordCount(), c, state_backend="tiled", device="cpu")
    # the sharded backend exists, and needs the caller's process group
    with pytest.raises(ValueError, match="process group"):
        KeyedStage(WordCount(), c, state_backend="sharded", device="cpu")
    assert KeyedStage(WordCount(), c, state_backend="object",
                      device="cpu").state_backend == "object"
    # auto picks the device ring only on CUDA
    assert KeyedStage(WordCount(), c, device="cpu").state_backend == \
        "columnar"


# -- carrying a running JAX stage's state across ------------------------------

def _snapshot(stage):
    """What the port needs of a JAX stage, as numpy arrays and ints.
    ``checkpoint()`` extracts and reinstalls every pack: transparent."""
    ck = stage.backend.checkpoint()
    a = stage.controller.assignment
    tk, td = a.table_arrays()
    ls = stage.last_stats
    out_keys = np.fromiter(stage.outputs.keys(), dtype=np.int64)
    return {
        "packs": [dict(keys=p.keys, vals=p.vals, sizes=p.sizes,
                       present=p.present, col_iv=p.col_iv)
                  for p in ck["packs"]],
        "col_iv": ck.get("col_iv", np.full(stage.window + 1, -1)),
        "table_keys": tk, "table_dests": td,
        "n_dest": a.n_dest, "hash_seed": a.hash_router.seed,
        "assignment_version": stage.controller.assignment_version,
        "last_stats": dict(keys=ls.keys, cost=ls.cost, mem=ls.mem,
                           freq=ls.freq),
        "interval": stage._interval,
        "pending_delta": stage._pending_delta_arr,
        "migrated_bytes_pending": stage._migrated_bytes_pending,
        "plan_time_pending": stage._plan_time_pending,
        "output_keys": out_keys,
        "output_values": np.array([stage.outputs[k] for k in out_keys],
                                  dtype=np.int64),
        "emitted_sum": stage.emitted_sum,
    }


@pytest.mark.parametrize("src,dst", [("device", "device"),
                                     ("device", "columnar"),
                                     ("columnar", "device")])
def test_load_reference_state_continues_identically(src, dst):
    kw = dict(n_tasks=7, window=3, theta_max=0.0, table_max=200, seed=8)
    ref = ref_stage(RefWordCount(), src, **kw)
    gen = RefGen(k=600, z=1.1, f=0.8, seed=12, window=3)
    for i in range(3):
        if i:
            gen.interval(ref.controller.assignment)
        ref.process_interval_arrays(gen.draw_tuples(1500).astype(np.int64))
    assert ref.controller.assignment.table_size > 0
    assert ref._pending_delta_arr is not None     # a migration in flight
    port = port_stage(WordCount(), dst, **kw)
    load_reference_state(port, _snapshot(ref))
    assert port.total_state_keys() == ref.total_state_keys()
    n_before = len(ref.reports)
    for i in range(3):
        gen.interval(ref.controller.assignment)
        keys = gen.draw_tuples(1500).astype(np.int64)
        _, ek, ev = ref.process_interval_emits(keys)
        _, pk, pv = port.process_interval_emits(keys)
        np.testing.assert_array_equal(pk, ek)
        np.testing.assert_array_equal(pv, ev)
    ref.reports = ref.reports[n_before:]
    assert_stages_identical(port, ref)


def test_load_reference_state_refuses_mismatched_stage():
    ref = ref_stage(RefWordCount(), "device", n_tasks=4, seed=8)
    ref.process_interval_arrays(np.arange(50, dtype=np.int64))
    snap = _snapshot(ref)
    with pytest.raises(ValueError, match="tasks"):
        load_reference_state(port_stage(WordCount(), "device", n_tasks=5,
                                        seed=8), snap)
    with pytest.raises(ValueError, match="seed"):
        load_reference_state(port_stage(WordCount(), "device", n_tasks=4,
                                        seed=7), snap)
    busy = port_stage(WordCount(), "device", n_tasks=4, seed=8)
    busy.process_interval_arrays(np.arange(5, dtype=np.int64))
    with pytest.raises(ValueError, match="fresh"):
        load_reference_state(busy, snap)
