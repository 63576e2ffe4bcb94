"""The port's multi-stage topologies and checkpointed recovery against the
JAX package's, on the CPU.

* Topologies: the three-stage filter -> count -> top-k pipeline of
  ``examples/stream_topology.py`` (its filter fleet resized, see below), a
  two-stage self-join pipeline and ``router_merge_topology`` under each
  choice router give the JAX ``Topology``'s reports, emit streams and
  outputs bit for bit; the merge stage's counts equal a single-stage
  WordCount's (the single-route oracle); a merge stage on the device ring
  (``device="cpu"``) equals the columnar one; ``substrate="kernels"``
  agrees with numpy to 1e-5, as the JAX package holds its Pallas
  substrate.
* Checkpoints, on the columnar and device backends, in exact and sketch
  mode: observationally free; a restore rewinds and replays identically
  (a router's live loads included); a disk round trip through
  ``CheckpointStore`` into a fresh stage; the refusals; a topology
  checkpoint; and the port's checkpointed replay against the JAX
  package's on the same trace.
* ``load_reference_state`` carries a JAX PKG split stage and a JAX Mixed
  merge stage, caught after 2 intervals, into the port; both packages then
  compute 2 more intervals identically.

Costs are dyadic (WordCount 1.0, MergeCounts 0.5, Filter 0.25, self-join
probe_cost 1/64), so comparisons are strict equality. The JAX stages avoid
ring width 6 (window 5), fleets of 6 or 9 tasks and hash seed 99 (so no
``router_merge_topology`` seed 98): other test files count the JAX device
steps' traces under those signatures.
"""

import os

import numpy as np
import pytest

from repro.core.balancer import Assignment as RefAssignment
from repro.core.balancer import ModHash as RefModHash
from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.streams import Filter as RefFilter
from repro.streams import MergeCounts as RefMergeCounts
from repro.streams import PartialWordCount as RefPartialWordCount
from repro.streams import StageSpec as RefStageSpec
from repro.streams import Topology as RefTopology
from repro.streams import WindowedSelfJoin as RefSelfJoin
from repro.streams import WordCount as RefWordCount
from repro.streams import WorkloadGen as RefGen
from repro.streams import keyed_stage as ref_keyed_stage
from repro.streams import router_merge_topology as ref_router_merge
from repro.streams.checkpoint import checkpoint_stage as ref_checkpoint_stage
from repro.streams.checkpoint import restore_stage as ref_restore_stage
from repro_torch.convert import load_reference_state
from repro_torch.core import Hash32, ModHash
from repro_torch.core.balancer import SketchConfig
from repro_torch.streams import (CheckpointStore, Filter, MergeCounts,
                                 PartialWordCount, StageSpec, Topology,
                                 WindowedSelfJoin, WordCount,
                                 checkpoint_stage, keyed_stage,
                                 restore_stage, router_merge_topology)

REPORT_FIELDS = ("interval", "tuples", "makespan", "migration_stall",
                 "throughput", "skewness", "theta", "migrated_bytes",
                 "table_size", "buffered")
ROUTERS = ("pkg", "potc", "wchoices")


def assert_same_stage_reports(got, want):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for field in REPORT_FIELDS:
            assert getattr(rg, field) == getattr(rw, field), \
                (rw.interval, field)
        np.testing.assert_array_equal(rg.task_loads, rw.task_loads)


def assert_same_topology(got, want):
    assert len(got.reports) == len(want.reports)
    for rg, rw in zip(got.reports, want.reports):
        assert (rg.interval, rg.tuples_in, rg.stage_tuples, rg.critical_path,
                rg.throughput, rg.migrated_bytes, rg.buffered) == \
            (rw.interval, rw.tuples_in, rw.stage_tuples, rw.critical_path,
             rw.throughput, rw.migrated_bytes, rw.buffered)
        assert_same_stage_reports(rg.stage_reports, rw.stage_reports)
    np.testing.assert_array_equal(got.last_emit_keys, want.last_emit_keys)
    np.testing.assert_array_equal(got.last_emit_values, want.last_emit_values)
    for sg, sw in zip(got.specs, want.specs):
        assert sg.stage.outputs == sw.stage.outputs, sg.name
        assert sg.stage.emitted_sum == sw.stage.emitted_sum, sg.name
        assert sg.stage.controller.assignment.table == \
            sw.stage.controller.assignment.table
        assert sg.stage.total_state_keys() == sw.stage.total_state_keys()
    assert got.rebalances_by_stage() == want.rebalances_by_stage()


def drive(topos, intervals, tuples, k, z, f, gen_seed, window, values=True):
    """Drive topologies on identical source streams; the generator follows
    each one's first stage's live assignment, and the streams must not
    diverge."""
    gens = [RefGen(k=k, z=z, f=f, seed=gen_seed, window=window)
            for _ in topos]
    for i in range(intervals):
        keys = None
        for gen, topo in zip(gens, topos):
            if i:
                gen.interval(topo.specs[0].stage.controller.assignment)
            drawn = gen.draw_tuples(tuples).astype(np.int64)
            if keys is None:
                keys = drawn
            assert np.array_equal(drawn, keys), "streams diverged"
            topo.process_interval(drawn,
                                  (drawn * 7 + i) % 11 if values else None)
    return topos


# -- topologies --------------------------------------------------------------

def three_stage(port, theta=0.04):
    """filter -> count -> top-k front, as examples/stream_topology.py builds
    it, with a 5-task filter fleet (not 6) and window 3."""
    if port:
        ks, flt, wc, mc, spec = keyed_stage, Filter, WordCount, \
            MergeCounts, StageSpec
        extra = {"device": "cpu"}
    else:
        ks, flt, wc, mc, spec = ref_keyed_stage, RefFilter, RefWordCount, \
            RefMergeCounts, RefStageSpec
        extra = {}
    s1 = ks(flt(lambda k, v: (k + v) % 4 != 0), n_tasks=5, theta_max=theta,
            table_max=300, window=3, seed=0, **extra)
    s2 = ks(wc(), n_tasks=8, theta_max=theta, table_max=400, window=3,
            seed=1, **extra)
    s3 = ks(mc(), n_tasks=4, theta_max=theta, table_max=200, window=3,
            seed=2, **extra)
    return (Topology if port else RefTopology)([
        spec("filter", s1), spec("count", s2),
        spec("topk", s3, rekey=lambda k, v: k % 32)])


def test_three_stage_pipeline_matches_jax():
    port, ref = drive([three_stage(True), three_stage(False)], intervals=6,
                      tuples=4000, k=800, z=1.1, f=0.8, gen_seed=3, window=3)
    assert_same_topology(port, ref)
    by_stage = port.rebalances_by_stage()
    assert sum(bool(v) for v in by_stage.values()) >= 2, by_stage
    assert any(r.buffered > 0 for r in port.reports)
    for rep in port.reports:
        n_src, n_counted, n_topk = rep.stage_tuples
        assert n_src == rep.tuples_in and 0 < n_counted < n_src == \
            rep.tuples_in and n_topk == n_counted
        assert rep.critical_path == sum(r.makespan + r.migration_stall
                                        for r in rep.stage_reports)
    assert port.last_emit_keys.size == 0      # MergeCounts is terminal
    assert port.total_state_keys() == ref.total_state_keys()


def test_two_stage_selfjoin_pipeline_matches_jax():
    def build(port):
        ks = keyed_stage if port else ref_keyed_stage
        extra = {"device": "cpu"} if port else {}
        s1 = ks((WindowedSelfJoin if port else RefSelfJoin)(
            probe_cost=1.0 / 64), n_tasks=7, theta_max=0.05, table_max=300,
            window=3, seed=0, **extra)
        s2 = ks((WordCount if port else RefWordCount)(), n_tasks=4,
                theta_max=0.05, table_max=200, window=3, seed=1, **extra)
        spec = StageSpec if port else RefStageSpec
        return (Topology if port else RefTopology)([
            spec("join", s1), spec("volume", s2, rekey=lambda k, v: k % 16)])

    port, ref = drive([build(True), build(False)], intervals=5, tuples=2000,
                      k=300, z=1.0, f=1.0, gen_seed=3, window=3)
    assert_same_topology(port, ref)
    assert any(r.migrated_bytes > 0 for r in port.reports)


def test_topology_validation():
    s = keyed_stage(WordCount(), n_tasks=2, theta_max=0.1, device="cpu")
    with pytest.raises(ValueError):
        Topology([])
    with pytest.raises(ValueError, match="duplicate"):
        Topology([StageSpec("a", s), StageSpec("a", s)])
    topo = Topology([StageSpec("a", s)])
    assert topo.n_stages == 1 and topo.names == ["a"] and topo["a"] is s
    with pytest.raises(KeyError):
        topo["missing"]


@pytest.mark.parametrize("algo,seed,z", [("pkg", 11, 1.3), ("potc", 0, 1.6),
                                         ("wchoices", 417, 2.0)])
def test_router_merge_topology_matches_jax_and_single_route(algo, seed, z):
    """The split stage under each router feeds a WordCount merge: identical
    to the JAX topology, and the merge stage's counts equal a single-stage
    WordCount's (one increment per tuple, however the key was split)."""
    port = router_merge_topology(PartialWordCount(), WordCount(), 8, 0.08,
                                 algorithm=algo, window=2, seed=seed,
                                 device="cpu")
    ref = ref_router_merge(RefPartialWordCount(), RefWordCount(), 8, 0.08,
                           algorithm=algo, window=2, seed=seed)
    oracle = keyed_stage(WordCount(), n_tasks=8, theta_max=0.08,
                         algorithm="mixed", window=2, seed=seed,
                         device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(3):
        keys = (rng.zipf(z, size=1500) % 250).astype(np.int64)
        port.process_interval(keys)
        ref.process_interval(keys)
        oracle.process_interval_arrays(keys)
    assert_same_topology(port, ref)
    assert port["merge"].emitted_sum == oracle.emitted_sum
    assert port["merge"].outputs == oracle.outputs
    split = port["split"]
    assert all(r.migrated_bytes == 0.0 and r.table_size == 0
               and r.buffered == 0 for r in split.reports)
    assert not split.controller.triggered_intervals()
    np.testing.assert_array_equal(split.controller.strategy.loads,
                                  ref["split"].controller.strategy.loads)


def _split_then_merge(merge_backend, substrate="numpy", stats_mode="exact",
                      seed=3):
    sketch = SketchConfig(capacity=64) if stats_mode == "sketch" else None
    split = keyed_stage(PartialWordCount(), 7, 0.05, algorithm="pkg",
                        hash_cls=Hash32, window=3, seed=seed,
                        substrate=substrate, device="cpu",
                        stats_mode=stats_mode, sketch=sketch)
    merge = keyed_stage(WordCount(), 5, 0.05, table_max=300, window=3,
                        hash_cls=Hash32, seed=seed + 1, substrate=substrate,
                        state_backend=merge_backend, device="cpu",
                        stats_mode=stats_mode, sketch=sketch)
    return Topology([StageSpec("split", split), StageSpec("merge", merge)])


def test_device_merge_stage_equals_columnar_and_jax():
    """The merge stage on the device ring (CPU) against the columnar one
    and the JAX package's columnar topology."""
    dev = _split_then_merge("device", substrate="kernels")
    col = _split_then_merge("columnar")
    ref = RefTopology([
        RefStageSpec("split", ref_keyed_stage(
            RefPartialWordCount(), 7, 0.05, algorithm="pkg",
            hash_cls=RefHash32, window=3, seed=3)),
        RefStageSpec("merge", ref_keyed_stage(
            RefWordCount(), 5, 0.05, table_max=300, window=3,
            hash_cls=RefHash32, seed=4, state_backend="columnar"))])
    assert dev["merge"].state_backend == "device"
    assert dev["split"].state_backend == "columnar"
    # the generator follows the split stage's (empty) table
    drive([dev, col, ref], intervals=5, tuples=3000, k=600, z=1.1, f=0.9,
          gen_seed=8, window=3, values=False)
    assert_same_topology(col, ref)
    for rd, rc in zip(dev.reports, col.reports):
        assert_same_stage_reports(rd.stage_reports[1:], rc.stage_reports[1:])
        # float32 stats on the kernels substrate: split loads match, the
        # integer fields exactly
        assert rd.stage_reports[0].table_size == 0
        np.testing.assert_array_equal(rd.stage_reports[0].task_loads,
                                      rc.stage_reports[0].task_loads)
    assert dev["merge"].outputs == col["merge"].outputs
    assert dev["merge"].controller.triggered_intervals()


def test_kernels_substrate_topology_matches_numpy():
    """Both stages on the ``"kernels"`` substrate (each kernel's plain
    version on the CPU): integer routing decisions coincide with the numpy
    pipeline; float32 stats make loads agree to 1e-5."""
    def build(substrate):
        s1 = keyed_stage(WordCount(), n_tasks=5, theta_max=0.05,
                         table_max=300, window=2, seed=3, hash_cls=Hash32,
                         substrate=substrate, device="cpu")
        s2 = keyed_stage(MergeCounts(), n_tasks=3, theta_max=0.05,
                         table_max=150, window=2, seed=4, hash_cls=Hash32,
                         substrate=substrate, device="cpu")
        return Topology([StageSpec("count", s1),
                         StageSpec("topk", s2, rekey=lambda k, v: k % 16)])

    np_topo, k_topo = drive([build("numpy"), build("kernels")], intervals=4,
                            tuples=1500, k=400, z=1.1, f=0.8, gen_seed=7,
                            window=2, values=False)
    for rn, rk in zip(np_topo.reports, k_topo.reports):
        assert (rn.buffered, rn.migrated_bytes, rn.stage_tuples) == \
            (rk.buffered, rk.migrated_bytes, rk.stage_tuples)
        for sn, sk in zip(rn.stage_reports, rk.stage_reports):
            assert sn.table_size == sk.table_size
            np.testing.assert_allclose(sk.task_loads, sn.task_loads,
                                       rtol=1e-5)
    assert any(r.table_size > 0 for r in np_topo["count"].reports)


# -- checkpoints -------------------------------------------------------------

def _stage(backend, stats_mode, algorithm="mixed", op=None, window=3):
    sketch = SketchConfig(capacity=64) if stats_mode == "sketch" else None
    return keyed_stage(op or WordCount(), 7, 0.0, table_max=300,
                       window=window, seed=2, hash_cls=Hash32,
                       state_backend=backend, device="cpu",
                       algorithm=algorithm, stats_mode=stats_mode,
                       sketch=sketch)


def trace(n=6, seed=5):
    """A fixed 6-interval trace: the generator fluctuates against a fixed
    7-task Hash32 assignment, so every stage in a test sees the same keys."""
    fixed = RefAssignment(RefHash32(7, seed=2))
    gen = RefGen(k=500, z=1.1, f=0.9, seed=seed, window=3)
    out = []
    for i in range(n):
        if i:
            gen.interval(fixed)
        out.append(gen.draw_tuples(1200).astype(np.int64))
    return out


def _emit_run(stage, keys_list):
    out = []
    for keys in keys_list:
        _, ek, ev = stage.process_interval_emits(keys)
        out.append((ek.copy(), ev.copy()))
    return out


CKPT_CASES = [("columnar", "exact"), ("device", "exact"),
              ("columnar", "sketch"), ("device", "sketch")]


@pytest.mark.parametrize("backend,stats_mode", CKPT_CASES)
def test_checkpointing_is_observationally_free(backend, stats_mode):
    plain, ckpted = _stage(backend, stats_mode), _stage(backend, stats_mode)
    for keys in trace():
        plain.process_interval_arrays(keys)
        ckpted.process_interval_arrays(keys)
        checkpoint_stage(ckpted)
    assert_same_stage_reports(ckpted.reports, plain.reports)
    assert ckpted.outputs == plain.outputs
    assert ckpted.controller.assignment.table == \
        plain.controller.assignment.table
    assert ckpted.controller.triggered_intervals()


@pytest.mark.parametrize("backend,stats_mode", CKPT_CASES)
def test_restore_rewinds_and_replays(backend, stats_mode):
    stage = _stage(backend, stats_mode)
    tr = trace()
    for keys in tr[:3]:
        stage.process_interval_arrays(keys)
    ckpt = checkpoint_stage(stage)
    first = _emit_run(stage, tr[3:])
    reports = list(stage.reports)
    outputs, table = dict(stage.outputs), stage.controller.assignment.table
    for _ in range(2):        # one checkpoint restores any number of times
        restore_stage(stage, ckpt)
        assert stage._interval == 3 and stage._route_cache is None
        again = _emit_run(stage, tr[3:])
        for (ek, ev), (fk, fv) in zip(again, first):
            np.testing.assert_array_equal(ek, fk)
            np.testing.assert_array_equal(ev, fv)
        assert_same_stage_reports(stage.reports, reports)
        assert stage.outputs == outputs
        assert stage.controller.assignment.table == table


@pytest.mark.parametrize("backend", ["columnar", "device"])
@pytest.mark.parametrize("algo", ROUTERS)
def test_restore_replays_router_loads(backend, algo):
    """A router split stage feeding a merge stage: restoring the topology
    rewinds the router's live loads, so the replay routes identically."""
    merge_backend = backend
    topo = router_merge_topology(PartialWordCount(), WordCount(), 5, 0.05,
                                 algorithm=algo, window=3, seed=7,
                                 hash_cls=Hash32, device="cpu")
    if merge_backend == "device":
        topo.specs[1] = StageSpec("merge", keyed_stage(
            WordCount(), 5, 0.05, window=3, seed=8, hash_cls=Hash32,
            state_backend="device", device="cpu"))
    tr = trace()
    for keys in tr[:2]:
        topo.process_interval(keys)
    ckpt = topo.checkpoint()
    loads = topo["split"].controller.strategy.loads.copy()
    for keys in tr[2:4]:
        topo.process_interval(keys)
    first = list(topo.reports)
    final_loads = topo["split"].controller.strategy.loads.copy()
    assert not np.array_equal(final_loads, loads)
    topo.restore(ckpt)
    np.testing.assert_array_equal(topo["split"].controller.strategy.loads,
                                  loads)
    assert len(topo.reports) == 2 and topo._interval == 2
    for keys in tr[2:4]:
        topo.process_interval(keys)
    for rg, rw in zip(topo.reports, first):
        assert (rg.throughput, rg.stage_tuples) == \
            (rw.throughput, rw.stage_tuples)
        assert_same_stage_reports(rg.stage_reports, rw.stage_reports)
    np.testing.assert_array_equal(topo["split"].controller.strategy.loads,
                                  final_loads)


@pytest.mark.parametrize("backend,stats_mode", CKPT_CASES)
def test_checkpoint_store_disk_round_trip(backend, stats_mode, tmp_path):
    stage = _stage(backend, stats_mode)
    store = CheckpointStore(tmp_path / "ckpts", keep=2)
    assert store.latest_interval() is None and store.load_latest() is None
    tr = trace()
    for keys in tr[:4]:
        stage.process_interval_arrays(keys)
        store.save(checkpoint_stage(stage))
    assert store.latest_interval() == 4
    names = sorted(os.listdir(tmp_path / "ckpts"))
    assert names == ["MANIFEST.json", "ckpt_00000003.pkl",
                     "ckpt_00000004.pkl"]
    fresh = _stage(backend, stats_mode)
    restore_stage(fresh, store.load_latest())
    a, b = _emit_run(stage, tr[4:]), _emit_run(fresh, tr[4:])
    for (ek, ev), (fk, fv) in zip(a, b):
        np.testing.assert_array_equal(ek, fk)
        np.testing.assert_array_equal(ev, fv)
    assert_same_stage_reports(fresh.reports, stage.reports)
    assert fresh.outputs == stage.outputs
    with pytest.raises(ValueError, match="keep"):
        CheckpointStore(tmp_path / "other", keep=0)


def test_restore_refuses_mismatches():
    col = _stage("columnar", "exact")
    col.process_interval_arrays(trace()[0])
    ckpt = checkpoint_stage(col)
    with pytest.raises(ValueError, match="state_backend"):
        restore_stage(_stage("device", "exact"), ckpt)
    with pytest.raises(ValueError, match="window"):
        restore_stage(_stage("columnar", "exact", window=2), ckpt)
    with pytest.raises(ValueError, match="stats_mode"):
        restore_stage(_stage("columnar", "sketch"), ckpt)
    two = Topology([StageSpec("a", _stage("columnar", "exact")),
                    StageSpec("b", _stage("columnar", "exact"))])
    two.process_interval(trace()[0])
    tckpt = two.checkpoint()
    one = Topology([StageSpec("a", _stage("columnar", "exact"))])
    with pytest.raises(ValueError, match="stages"):
        one.restore(tckpt)


def test_topology_checkpoint_restores_every_stage():
    topo = three_stage(True)
    gen = RefGen(k=800, z=1.1, f=0.8, seed=3, window=3)
    batches = []
    for i in range(5):
        if i:
            gen.interval(topo.specs[0].stage.controller.assignment)
        batches.append(gen.draw_tuples(3000).astype(np.int64))
        topo.process_interval(batches[-1], (batches[-1] * 7 + i) % 11)
        if i == 1:
            ckpt = topo.checkpoint()
    first = list(topo.reports)
    state = [(dict(s.stage.outputs), s.stage.total_state_keys())
             for s in topo.specs]
    topo.restore(ckpt)
    assert [len(s.stage.reports) for s in topo.specs] == [2, 2, 2]
    for i in range(2, 5):
        topo.process_interval(batches[i], (batches[i] * 7 + i) % 11)
    for rg, rw in zip(topo.reports, first):
        assert_same_stage_reports(rg.stage_reports, rw.stage_reports)
    assert [(dict(s.stage.outputs), s.stage.total_state_keys())
            for s in topo.specs] == state


@pytest.mark.parametrize("algorithm,op", [("mixed", "wordcount"),
                                          ("pkg", "partial")])
def test_checkpointed_replay_matches_jax(algorithm, op):
    """The same trace, checkpoint and replay in both packages (columnar):
    identical reports before and after the restore."""
    ops = {"wordcount": (WordCount, RefWordCount),
           "partial": (PartialWordCount, RefPartialWordCount)}[op]
    kw = dict(table_max=300, window=3, seed=2, algorithm=algorithm)
    port = keyed_stage(ops[0](), 7, 0.0, hash_cls=Hash32, device="cpu", **kw)
    ref = ref_keyed_stage(ops[1](), 7, 0.0, hash_cls=RefHash32, **kw)
    tr = trace()
    for keys in tr[:3]:
        port.process_interval_arrays(keys)
        ref.process_interval_arrays(keys)
    pc, rc = checkpoint_stage(port), ref_checkpoint_stage(ref)
    for keys in tr[3:5]:
        port.process_interval_arrays(keys)
        ref.process_interval_arrays(keys)
    restore_stage(port, pc)
    ref_restore_stage(ref, rc)
    for keys in tr[3:]:
        port.process_interval_arrays(keys)
        ref.process_interval_arrays(keys)
    assert_same_stage_reports(port.reports, ref.reports)
    assert port.outputs == ref.outputs
    assert port.emitted_sum == ref.emitted_sum
    assert port.controller.assignment.table == ref.controller.assignment.table
    assert [ev.interval for ev in port.controller.history] == \
        [ev.interval for ev in ref.controller.history]


# -- state carried across ----------------------------------------------------

def _snapshot(stage, hash_name="hash32"):
    """What the port needs of a JAX stage, as numpy arrays and ints, plus
    the router's live state when it runs one."""
    ck = stage.backend.checkpoint()
    a = stage.controller.assignment
    tk, td = a.table_arrays()
    ls = stage.last_stats
    out_keys = np.fromiter(stage.outputs.keys(), dtype=np.int64)
    snap = {
        "packs": [dict(keys=p.keys, vals=p.vals, sizes=p.sizes,
                       present=p.present, col_iv=p.col_iv)
                  for p in ck["packs"]],
        "col_iv": ck.get("col_iv", np.full(stage.window + 1, -1)),
        "table_keys": tk, "table_dests": td,
        "n_dest": a.n_dest, "hash_seed": a.hash_router.seed,
        "hash": hash_name,
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
    strat = stage.controller.strategy
    if strat.is_router:
        r = {"name": strat.name, "seed": strat.seed,
             "n_choices": strat.n_choices, "chunk": strat.chunk,
             "loads": np.asarray(strat.loads)}
        if strat.name == "potc":
            r.update(n_sources=strat.n_sources, src_loads=strat._src_loads,
                     pos=strat._pos)
        if strat.name == "wchoices":
            r.update(head=strat.head_keys,
                     head_threshold=strat.head_threshold,
                     head_capacity=strat.head_capacity)
        snap["router"] = r
    return snap


@pytest.mark.parametrize("algo,merge_backend", [
    ("pkg", "columnar"), ("pkg", "device"), ("potc", "columnar"),
    ("wchoices", "columnar")])
def test_load_reference_state_carries_router_and_merge(algo, merge_backend):
    """A JAX PKG split stage (ModHash) and a JAX Mixed merge stage (Hash32),
    caught after 2 intervals, continue identically in the port."""
    ref_split = ref_keyed_stage(RefPartialWordCount(), 5, 0.0, window=3,
                                seed=12, algorithm=algo, hash_cls=RefModHash)
    ref_merge = ref_keyed_stage(RefWordCount(), 4, 0.0, table_max=200,
                                window=3, seed=13, hash_cls=RefHash32)
    gen = RefGen(k=500, z=1.2, f=0.9, seed=9, window=3)
    for i in range(2):
        if i:
            gen.interval(ref_merge.controller.assignment)
        keys = gen.draw_tuples(1500).astype(np.int64)
        _, ek, ev = ref_split.process_interval_emits(keys)
        ref_merge.process_interval_emits(ek, ev)
    assert ref_merge.controller.assignment.table_size > 0
    port_split = keyed_stage(PartialWordCount(), 5, 0.0, window=3, seed=12,
                             algorithm=algo, hash_cls=ModHash, device="cpu")
    port_merge = keyed_stage(WordCount(), 4, 0.0, table_max=200, window=3,
                             seed=13, hash_cls=Hash32, device="cpu",
                             state_backend=merge_backend)
    load_reference_state(port_split, _snapshot(ref_split, "modhash"))
    load_reference_state(port_merge, _snapshot(ref_merge))
    np.testing.assert_array_equal(port_split.controller.strategy.loads,
                                  ref_split.controller.strategy.loads)
    n_split, n_merge = len(ref_split.reports), len(ref_merge.reports)
    for i in range(2):
        gen.interval(ref_merge.controller.assignment)
        keys = gen.draw_tuples(1500).astype(np.int64)
        _, ek, ev = ref_split.process_interval_emits(keys)
        _, pk, pv = port_split.process_interval_emits(keys)
        np.testing.assert_array_equal(pk, ek)
        np.testing.assert_array_equal(pv, ev)
        _, rk, rv = ref_merge.process_interval_emits(ek, ev)
        _, qk, qv = port_merge.process_interval_emits(pk, pv)
        np.testing.assert_array_equal(qk, rk)
        np.testing.assert_array_equal(qv, rv)
    assert_same_stage_reports(port_split.reports, ref_split.reports[n_split:])
    assert_same_stage_reports(port_merge.reports, ref_merge.reports[n_merge:])
    for port, ref in ((port_split, ref_split), (port_merge, ref_merge)):
        assert port.outputs == ref.outputs
        assert port.emitted_sum == ref.emitted_sum
        assert port.controller.assignment.table == \
            ref.controller.assignment.table
    np.testing.assert_array_equal(port_split.controller.strategy.loads,
                                  ref_split.controller.strategy.loads)


def test_load_reference_state_refuses_wrong_hash_or_router():
    ref = ref_keyed_stage(RefPartialWordCount(), 4, 0.0, window=3, seed=12,
                          algorithm="pkg", hash_cls=RefModHash)
    ref.process_interval_arrays(np.arange(60, dtype=np.int64) % 17)
    snap = _snapshot(ref, "modhash")
    with pytest.raises(ValueError, match="ModHash"):
        load_reference_state(keyed_stage(
            PartialWordCount(), 4, 0.0, window=3, seed=12, algorithm="pkg",
            hash_cls=Hash32, device="cpu"), snap)
    with pytest.raises(ValueError, match="router"):
        load_reference_state(keyed_stage(
            PartialWordCount(), 4, 0.0, window=3, seed=12,
            algorithm="potc", hash_cls=ModHash, device="cpu"), snap)
    with pytest.raises(ValueError, match="unknown hash"):
        load_reference_state(keyed_stage(
            PartialWordCount(), 4, 0.0, window=3, seed=12, algorithm="pkg",
            hash_cls=ModHash, device="cpu"), {**snap, "hash": "murmur"})
