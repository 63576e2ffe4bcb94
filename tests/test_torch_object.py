"""The port's object store, per-tuple reference loop and the public names a
name-by-name diff of the two packages found missing, against the JAX
package on the CPU.

* ``ObjectBackend`` (dict-of-KeyState stores, per-task segment dispatch)
  and the per-tuple reference loop (``vectorized=False``) give the JAX
  package's reports, outputs, emitted sums, emit streams and held keys for
  every built-in operator, and a custom operator without a
  ``columnar_spec`` resolves to the object store under ``auto`` in both.
* The list-of-tuples ``process_interval`` API; traffic that ends
  mid-pause on the object, columnar and device backends; a restore inside
  a pause window on the per-tuple loop (``restore_stage`` clears the loop's
  membership set).
* The object store on the ``"kernels"`` substrate (the routing kernel per
  tuple, ``key_stats`` for step 1; their plain versions on the CPU)
  against numpy: float32 stats, 1e-5 / 1e-6 relative.
* ``derate_worker``, ``metrics.theta_two_sided`` / ``migration_cost`` /
  ``migration_fraction``, ``Assignment.dest_one``,
  ``RebalanceResult.same_plan``, ``Algorithm``, ``WorkloadGen.stream``, and
  ``kernels.ops.fused_key_stats`` / ``mixed_route`` against the JAX
  package's ``ops`` in interpret mode.

Costs are dyadic (WordCount 1.0, MergeCounts 0.5, Filter 0.25, self-join
probe_cost 1/64), so comparisons are strict equality. The JAX stages avoid
ring width 6 (window 5), fleets of 6 or 9 tasks and hash seed 99: other
test files count the JAX device steps' traces under those signatures.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.kernels.ops as ref_ops
from repro.core import Assignment as RefAssignment
from repro.core import BalanceConfig as RefConfig
from repro.core import ModHash as RefModHash
from repro.core import RebalanceController as RefController
from repro.core.balancer import metrics as ref_metrics
from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.core.balancer.types import RebalanceResult as RefResult
from repro.streams import Filter as RefFilter
from repro.streams import KeyedStage as RefStage
from repro.streams import MergeCounts as RefMergeCounts
from repro.streams import Operator as RefOperator
from repro.streams import PartialWordCount as RefPartialWordCount
from repro.streams import WindowedSelfJoin as RefSelfJoin
from repro.streams import WordCount as RefWordCount
from repro.streams import WorkloadGen as RefGen
from repro_torch.core import (Assignment, BalanceConfig, Hash32, KeyStats,
                              ModHash, RebalanceController)
from repro_torch.core.balancer import metrics
from repro_torch.core.balancer.types import Algorithm, RebalanceResult
from repro_torch.kernels import fused_key_stats, mixed_route
from repro_torch.streams import (ChaosRunner, ColumnarStateStore, Filter,
                                 KeyedStage, KeyState, MergeCounts,
                                 ObjectBackend, ObjectPack, Operator,
                                 PartialWordCount, TaskKilled,
                                 TaskStateStore, WindowedSelfJoin, WordCount,
                                 WorkloadGen, checkpoint_stage,
                                 restore_stage)

REPORT_FIELDS = ("interval", "tuples", "makespan", "migration_stall",
                 "throughput", "skewness", "theta", "migrated_bytes",
                 "table_size", "buffered")


def _keep(k, v):
    return (k + np.asarray(v, dtype=np.int64)) % 3 != 0


#: (operator name) -> (port factory, JAX factory, payload maker)
OPERATORS = {
    "wordcount": (WordCount, RefWordCount, None),
    "selfjoin": (lambda: WindowedSelfJoin(probe_cost=1 / 64),
                 lambda: RefSelfJoin(probe_cost=1 / 64),
                 lambda keys, i: (keys % 97) * 0.25 + i),
    "partial": (PartialWordCount, RefPartialWordCount, None),
    "merge": (MergeCounts, RefMergeCounts,
              lambda keys, i: (keys * 7 + i) % 13),
    "filter": (lambda: Filter(_keep), lambda: RefFilter(_keep),
               lambda keys, i: (keys * 5 + i) % 11),
}


def make(port, op, backend="object", n_tasks=5, window=3, theta_max=0.05,
         table_max=300, seed=1, hash_cls=None, vectorized=True, **kwargs):
    if port:
        hc = hash_cls or ModHash
        controller = RebalanceController(
            Assignment(hc(n_tasks, seed=seed)),
            BalanceConfig(theta_max=theta_max, table_max=table_max,
                          window=window), algorithm="mixed")
        return KeyedStage(op, controller, window=window,
                          state_backend=backend, vectorized=vectorized,
                          device="cpu", **kwargs)
    hc = {None: RefModHash, ModHash: RefModHash, Hash32: RefHash32}[hash_cls]
    controller = RefController(
        RefAssignment(hc(n_tasks, seed=seed)),
        RefConfig(theta_max=theta_max, table_max=table_max, window=window),
        algorithm="mixed")
    return RefStage(op, controller, window=window, state_backend=backend,
                    vectorized=vectorized, **kwargs)


def trace(n_iv=6, n_tuples=700, k=500, seed=3, window=3, z=1.1, f=0.8):
    """Per-interval keys, drawn once from a generator that follows a
    pilot stage's live table (so rebalances happen under the trace)."""
    gen = RefGen(k=k, z=z, f=f, seed=seed, window=window)
    pilot = make(False, RefWordCount(), window=window)
    out = []
    for i in range(n_iv):
        gen.interval(pilot.controller.assignment, fluctuate=i > 0)
        keys = gen.draw_tuples(n_tuples).astype(np.int64)
        out.append(keys)
        pilot.process_interval_arrays(keys)
    return out


def assert_same_reports(got, want):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        for field in REPORT_FIELDS:
            assert getattr(rg, field) == getattr(rw, field), \
                (rw.interval, field)
        np.testing.assert_array_equal(rg.task_loads, rw.task_loads)


def assert_stages_identical(got, want):
    assert_same_reports(got.reports, want.reports)
    assert got.outputs == want.outputs
    assert got.emitted_sum == want.emitted_sum
    assert got.total_state_keys() == want.total_state_keys()
    assert got.controller.assignment.table == want.controller.assignment.table
    for key in list(want.outputs)[:20]:
        assert got.key_location(key) == want.key_location(key)


def drive(stages, keys_by_iv, payload, emits=False):
    """Feed identical intervals to every stage; returns each stage's emit
    streams when ``emits``."""
    streams = [[] for _ in stages]
    for i, keys in enumerate(keys_by_iv):
        vals = None if payload is None else payload(keys, i)
        for stage, out in zip(stages, streams):
            if emits:
                _, ek, ev = stage.process_interval_emits(keys, vals)
                out.append((ek, ev))
            else:
                stage.process_interval_arrays(keys, vals)
    return streams


# -- the object store and the per-tuple loop against the JAX package ---------

@pytest.mark.parametrize("vectorized", [True, False],
                         ids=["object_backend", "per_tuple"])
@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_object_store_matches_jax(name, vectorized):
    port_op, ref_op, payload = OPERATORS[name]
    keys_by_iv = trace()
    port = make(True, port_op(), vectorized=vectorized)
    ref = make(False, ref_op(), vectorized=vectorized)
    assert port.state_backend == ref.state_backend == "object"
    got, want = drive([port, ref], keys_by_iv, payload, emits=True)
    assert_stages_identical(port, ref)
    assert any(r.table_size for r in ref.reports)      # it rebalanced
    for (gk, gv), (wk, wv) in zip(got, want):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_per_tuple_loop_matches_port_backends(name):
    """The parity oracle inside the port: the per-tuple loop, the object
    backend and the columnar backend give one report stream."""
    port_op, _, payload = OPERATORS[name]
    keys_by_iv = trace(seed=4)
    stages = [make(True, port_op(), vectorized=False),
              make(True, port_op(), backend="object"),
              make(True, port_op(), backend="columnar")]
    drive(stages, keys_by_iv, payload)
    for other in stages[1:]:
        assert_stages_identical(other, stages[0])


def test_list_of_tuples_api_matches_jax():
    keys_by_iv = trace(n_iv=4, seed=5)
    port = make(True, WindowedSelfJoin(probe_cost=1 / 64), vectorized=False)
    ref = make(False, RefSelfJoin(probe_cost=1 / 64), vectorized=False)
    vec = make(True, WindowedSelfJoin(probe_cost=1 / 64))
    for i, keys in enumerate(keys_by_iv):
        tuples = [(int(k), float(k % 7) + i) for k in keys]
        port.process_interval(tuples)
        ref.process_interval(tuples)
        vec.process_interval(tuples)
    assert_stages_identical(port, ref)
    assert_stages_identical(vec, ref)
    # the object store keeps the payloads themselves
    key = next(iter(ref.outputs))
    task = ref.key_location(key)[0]
    got = port.stores[task].keys[key]
    want = ref.stores[task].keys[key]
    assert [(s.interval, s.payload, s.size) for s in got.iter_window()] == \
        [(s.interval, s.payload, s.size) for s in want.iter_window()]


class _PortSquares(Operator):
    """A per-tuple-only operator: keeps the last value per interval slice,
    emits value squared."""

    name = "squares"

    def process(self, store, interval, key, value):
        sl = store.state(key).slice_for(interval, init=lambda: [0],
                                        size=8.0)
        sl.payload[0] = value
        return [(key, float(value) * float(value))], 0.5


class _RefSquares(RefOperator):
    name = "squares"
    process = _PortSquares.process


def test_custom_operator_resolves_to_object_and_matches_jax():
    keys_by_iv = trace(n_iv=5, seed=6)
    port = make(True, _PortSquares())
    ref = make(False, _RefSquares())
    assert port.state_backend == ref.state_backend == "object"
    assert isinstance(port.backend, ObjectBackend)
    drive([port, ref], keys_by_iv, lambda keys, i: (keys % 5) * 0.5 + i)
    assert_stages_identical(port, ref)
    with pytest.raises(ValueError, match="columnar_spec"):
        make(True, _PortSquares(), backend="columnar")


@pytest.mark.parametrize("backend", ["columnar", "device"])
def test_array_backends_refuse_per_tuple_loop_as_jax_does(backend):
    with pytest.raises(ValueError) as got:
        make(True, WordCount(), backend=backend, hash_cls=Hash32,
             vectorized=False)
    with pytest.raises(ValueError) as want:
        make(False, RefWordCount(), backend=backend, hash_cls=Hash32,
             vectorized=False)
    assert str(got.value) == str(want.value)
    # auto falls through to the object store for the per-tuple loop
    assert make(True, WordCount(), backend="auto",
                vectorized=False).state_backend == "object"


# -- pause and replay edges ---------------------------------------------------

@pytest.mark.parametrize("backend", ["object", "columnar", "device"])
def test_traffic_ending_mid_pause_matches_jax_reference_loop(backend):
    """migration_batches == micro_batches: the pause window covers the whole
    interval, so every Delta-key tuple is still buffered when traffic ends
    and the end-of-interval flush replays it."""
    def build(port, vectorized, state_backend):
        return make(port, WordCount() if port else RefWordCount(),
                    backend=state_backend, hash_cls=Hash32, theta_max=0.01,
                    micro_batches=4, migration_batches=4,
                    vectorized=vectorized)

    keys_by_iv = trace(n_iv=6, n_tuples=400, k=300, seed=11)
    ref = build(False, False, "object")
    port_loop = build(True, False, "object")
    vec = build(True, True, backend)
    drive([ref, port_loop, vec], keys_by_iv, None)
    assert any(r.buffered > 0 for r in ref.reports)
    assert_stages_identical(port_loop, ref)
    assert_stages_identical(vec, ref)


class _CrashOnce:
    """Wraps an operator's ``process``: raises ``TaskKilled`` at the
    ``at``-th tuple of interval ``interval``, once."""

    def __init__(self, op, interval, at):
        self.op, self.interval, self.at, self.seen = op, interval, at, 0
        self.fired = False

    def __call__(self, store, interval, key, value):
        if interval == self.interval and not self.fired:
            self.seen += 1
            if self.seen == self.at:
                self.fired = True
                raise TaskKilled(0, interval, "mid")
        return type(self.op).process(self.op, store, interval, key, value)


def test_restore_inside_pause_window_on_per_tuple_loop():
    """A crash in the middle of a per-tuple interval whose pause window is
    open leaves the loop's membership set built; the runner then restores
    a checkpoint taken under another migration (or none). The restore must
    drop that set, or the replay pauses the wrong keys."""
    keys_by_iv = trace(n_iv=8, n_tuples=600, k=400, seed=12)
    oracle = make(False, RefWordCount(), vectorized=False, theta_max=0.01)
    drive([oracle], keys_by_iv, None)
    # the crash interval: its predecessor planned a migration, and the
    # last cadence checkpoint (every 3 intervals) carries another delta
    paused = [r.interval for r in oracle.reports if r.buffered > 0]
    crash_iv = next(iv for iv in paused if iv % 3 != 1)
    assert oracle.reports[crash_iv - 1].buffered > 0

    op = WordCount()
    stage = make(True, op, vectorized=False, theta_max=0.01)
    op.process = _CrashOnce(op, crash_iv, at=100)
    runner = ChaosRunner(stage, checkpoint_every=3)
    for keys in keys_by_iv:
        runner.process_interval(keys)
    assert [(e.interval, e.kind) for e in runner.events] == \
        [(crash_iv, "kill@mid")]
    assert_stages_identical(stage, oracle)


# -- the "kernels" substrate on the object store --------------------------------

def test_object_store_on_kernels_substrate_matches_numpy():
    """Routing through the routing kernel's wrapper per tuple and step-1
    stats through ``key_stats``'s (their plain versions on the CPU):
    routing is exact, stats are float32 (loads 1e-5, c(k) 1e-6 relative),
    as the JAX package holds its Pallas substrate."""
    keys_by_iv = trace(n_iv=5, n_tuples=800, k=600, seed=13)
    payload = OPERATORS["selfjoin"][2]
    ker = make(True, WindowedSelfJoin(probe_cost=1 / 64), hash_cls=Hash32,
               substrate="kernels")
    num = make(True, WindowedSelfJoin(probe_cost=1 / 64), hash_cls=Hash32)
    ref = make(False, RefSelfJoin(probe_cost=1 / 64), hash_cls=Hash32,
               vectorized=False)
    for i, keys in enumerate(keys_by_iv):
        vals = payload(keys, i)
        for st in (ker, num, ref):
            st.process_interval_arrays(keys, vals)
        np.testing.assert_array_equal(ker.last_stats.keys,
                                      num.last_stats.keys)
        np.testing.assert_array_equal(ker.last_stats.freq,
                                      num.last_stats.freq)
        np.testing.assert_allclose(ker.last_stats.cost, num.last_stats.cost,
                                   rtol=1e-6)
    assert_stages_identical(num, ref)
    assert ker.outputs == ref.outputs and ker.emitted_sum == ref.emitted_sum
    for rk, rr in zip(ker.reports, ref.reports):
        assert (rk.tuples, rk.table_size, rk.migrated_bytes, rk.buffered) == \
            (rr.tuples, rr.table_size, rr.migrated_bytes, rr.buffered)
        np.testing.assert_allclose(rk.task_loads, rr.task_loads, rtol=1e-5)


# -- store-level contracts ----------------------------------------------------

def test_task_state_store_and_pack_contract():
    store = TaskStateStore(window=2)
    pairs = store.update_many(1, np.array([3, 5, 9]), init=list, size=4.0)
    for ks, sl in pairs:
        sl.payload.append(1.5)
    store.state(5).slice_for(2, init=list, size=2.0).payload.append(2.5)
    keys, sizes = store.sizes_arrays()
    assert keys.tolist() == [3, 5, 9] and sizes.tolist() == [4.0, 6.0, 4.0]
    assert store.sizes() == {3: 4.0, 5: 6.0, 9: 4.0}
    pack = store.extract_batch(np.array([5, 9, 77]))
    assert isinstance(pack, ObjectPack) and pack.keys.tolist() == [5, 9]
    assert pack.nbytes == 10.0 and list(store.keys) == [3]
    snap = pack.clone()
    pack.states[0].slices[2].payload.append(9.0)       # live ref mutates
    assert snap.states[0].slices[2].payload == [2.5]
    other = TaskStateStore(window=2)
    other.install_batch(snap.take(np.array([True, False])))
    assert list(other.keys) == [5]
    with pytest.raises(RuntimeError, match="already present"):
        other.install_batch(snap.take(np.array([True, False])))
    # eviction drops keys whose window emptied
    keys, sizes = store.end_interval_collect(3)
    assert keys.tolist() == [] and store.keys == {}


def test_columnar_keys_view_materializes_snapshots_as_jax():
    keys_by_iv = trace(n_iv=3, seed=14)
    for port_op, ref_op in ((WordCount(), RefWordCount()),
                            (WindowedSelfJoin(probe_cost=1 / 64),
                             RefSelfJoin(probe_cost=1 / 64))):
        port = make(True, port_op, backend="columnar")
        ref = make(False, ref_op, backend="columnar")
        drive([port, ref], keys_by_iv, None)
        for ps, rs in zip(port.stores, ref.stores):
            assert dict(ps.sizes()) == dict(rs.sizes())
            assert ps.total_state_keys() == rs.total_state_keys()
            for key in list(rs.keys)[:10]:
                got, want = ps.keys[key], rs.keys[key]
                assert isinstance(got, KeyState)
                assert [(s.interval, s.payload, s.size)
                        for s in got.iter_window()] == \
                    [(s.interval, s.payload, s.size)
                     for s in want.iter_window()]
            with pytest.raises(KeyError):
                ps.keys[-5]
            with pytest.raises(NotImplementedError, match="object"):
                ps.state(0)
    assert isinstance(ColumnarStateStore(2, port_op.columnar_spec).keys,
                      type(port.stores[0].keys))


# -- derate_worker and the public names -----------------------------------------

def _stats(seed=0, k=300):
    rng = np.random.default_rng(seed)
    keys = np.arange(k, dtype=np.int64)
    freq = rng.zipf(1.3, size=k).astype(np.float64)
    cost = freq * rng.choice([0.5, 1.0, 2.0], size=k)
    mem = rng.integers(1, 64, size=k).astype(np.float64)
    return keys, cost, mem, freq


def test_derate_worker_matches_jax():
    keys, cost, mem, freq = _stats(1)
    port = RebalanceController(Assignment(ModHash(7, seed=2)),
                               BalanceConfig(theta_max=0.05, table_max=200))
    ref = RefController(RefAssignment(RefModHash(7, seed=2)),
                        RefConfig(theta_max=0.05, table_max=200))
    from repro.core.balancer import KeyStats as RefKeyStats
    got = port.derate_worker(3, 2.5, KeyStats(keys, cost, mem, freq))
    want = ref.derate_worker(3, 2.5, RefKeyStats(keys, cost, mem, freq))
    assert got.result is not None and want.result is not None
    assert port.assignment.table == ref.assignment.table
    np.testing.assert_array_equal(got.result.loads, want.result.loads)
    assert got.result.theta == want.result.theta
    # the derated worker sheds load
    assert got.result.loads[3] < metrics.loads(
        KeyStats(keys, cost, mem, freq),
        Assignment(ModHash(7, seed=2))).max()


def test_balancer_public_names_match_jax():
    keys, cost, mem, freq = _stats(2)
    stats = KeyStats(keys, cost, mem, freq)
    from repro.core.balancer import KeyStats as RefKeyStats
    rstats = RefKeyStats(keys, cost, mem, freq)
    old, rold = Assignment(ModHash(5, seed=3)), \
        RefAssignment(RefModHash(5, seed=3))
    table = {int(k): int(k) % 5 for k in keys[::7]}
    new, rnew = Assignment(ModHash(5, seed=3), table), \
        RefAssignment(RefModHash(5, seed=3), dict(table))
    loads = metrics.loads(stats, old)
    assert metrics.theta_two_sided(loads) == \
        ref_metrics.theta_two_sided(loads)
    assert metrics.theta_two_sided(np.zeros(3)) == 0.0
    assert metrics.migration_cost(stats, old, new) == \
        ref_metrics.migration_cost(rstats, rold, rnew)
    assert metrics.migration_fraction(stats, old, new) == \
        ref_metrics.migration_fraction(rstats, rold, rnew)
    assert metrics.migration_fraction(
        KeyStats(keys, cost, np.zeros_like(mem), freq), old, new) == 0.0
    for key in (0, 7, 8, 299, 12345):
        assert new.dest_one(key) == rnew.dest_one(key)
        assert isinstance(new.dest_one(key), int)
    from repro.core.balancer import mixed as ref_mixed
    from repro_torch.core.balancer import mixed
    cfg = BalanceConfig(theta_max=0.05, table_max=100)
    rcfg = RefConfig(theta_max=0.05, table_max=100)
    plan = mixed(stats, old, cfg)
    rplan = ref_mixed(rstats, rold, rcfg)
    assert plan.same_plan(plan) and rplan.same_plan(rplan)
    assert plan.same_plan(RebalanceResult(**{
        f: getattr(rplan, f) for f in ("moved_keys", "migration_cost",
                                       "loads", "table_size", "theta",
                                       "feasible_balance", "feasible_table")},
        assignment=Assignment(ModHash(5, seed=3),
                              dict(rplan.assignment.table))))
    for field, value in (("theta", plan.theta + 1.0),
                         ("table_size", plan.table_size + 1),
                         ("loads", plan.loads + 1.0)):
        assert not plan.same_plan(dataclasses.replace(plan,
                                                      **{field: value}))
    assert isinstance(rplan, RefResult)
    assert Algorithm.__args__[-1] is RebalanceResult


def test_workload_stream_matches_jax():
    port = WorkloadGen(k=200, z=1.0, f=0.7, seed=8, window=3)
    ref = RefGen(k=200, z=1.0, f=0.7, seed=8, window=3)
    a, ra = Assignment(ModHash(4, seed=1)), RefAssignment(RefModHash(4, seed=1))
    got = list(port.stream(a, 4))
    want = list(ref.stream(ra, 4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for f in ("keys", "cost", "mem", "freq"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


def test_ops_fused_key_stats_and_mixed_route_match_jax_interpret():
    import jax.numpy as jnp
    rng = np.random.default_rng(21)
    keys = rng.integers(-3, 40, size=203).astype(np.int32)
    costs = rng.uniform(0.5, 1.5, size=keys.size).astype(np.float32)
    for c in (costs, None):
        got = fused_key_stats(torch.from_numpy(keys),
                              None if c is None else torch.from_numpy(c), 37)
        want = ref_ops.fused_key_stats(
            jnp.asarray(keys), None if c is None else jnp.asarray(c), 37,
            interpret=True)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6)
    tk = np.full(24, -1, np.int32)
    td = np.zeros(24, np.int32)
    tk[:11] = rng.choice(40, size=11, replace=False)
    td[:11] = rng.integers(0, 7, size=11)
    rkeys = np.abs(keys)
    got = mixed_route(torch.from_numpy(rkeys), torch.from_numpy(tk),
                      torch.from_numpy(td), 7, seed=4)
    want = ref_ops.mixed_route(jnp.asarray(rkeys), jnp.asarray(tk),
                               jnp.asarray(td), 7, seed=4, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_checkpoint_clones_object_packs():
    """Object packs are checkpointed through ``clone``: later mutation of
    the live stores leaves the snapshot intact, and one snapshot restores
    twice."""
    keys_by_iv = trace(n_iv=6, seed=15)
    payload = OPERATORS["selfjoin"][2]
    stage = make(True, WindowedSelfJoin(probe_cost=1 / 64))
    drive([stage], keys_by_iv[:3], payload)
    ckpt = checkpoint_stage(stage)
    assert all(isinstance(p, ObjectPack) for p in ckpt.packs)
    before = {int(k): [list(s.payload) for s in st.iter_window()]
              for p in ckpt.packs for k, st in zip(p.keys, p.states)}
    for i, keys in enumerate(keys_by_iv[3:], start=3):
        stage.process_interval_arrays(keys, payload(keys, i))
    first = list(stage.reports)
    after = {int(k): [list(s.payload) for s in st.iter_window()]
             for p in ckpt.packs for k, st in zip(p.keys, p.states)}
    assert after == before
    for _ in range(2):
        restore_stage(stage, ckpt)
        for i, keys in enumerate(keys_by_iv[3:], start=3):
            stage.process_interval_arrays(keys, payload(keys, i))
        assert_same_reports(stage.reports, first)
