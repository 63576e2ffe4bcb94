"""The port's choice routers and their hashers against the JAX package's.

The same seeded numpy inputs go through both packages on the CPU:

* the base hashers (``splitmix64``, ``ModHash``, ``ExplicitHash``,
  ``ConsistentHash``) give bit-identical destinations, negative and
  near-``int64``-max keys included;
* the sequential PKG oracles (``pkg_route``, ``pkg_route_stats``) give
  identical loads, split keys and merge cost;
* each registered router (``pkg``, ``potc``, ``wchoices``) gives identical
  candidates, routes and loads over several batches, and W-Choices the
  same head set after ``on_stats``;
* the registry, capability flags, controller branches and refusals match,
  messages included;
* a router stage's reports, outputs and ``emitted_sum`` equal the JAX
  ``keyed_stage``'s.

The JAX stages here avoid ring width 6 (window 5), fleets of 6 or 9 tasks
and hash seed 99: other test files count the JAX device steps' traces under
those signatures.
"""

import numpy as np
import pytest
import torch

from repro.core import RebalanceController as RefController
from repro.core.balancer import Assignment as RefAssignment
from repro.core.balancer import BalanceConfig as RefConfig
from repro.core.balancer import ConsistentHash as RefConsistentHash
from repro.core.balancer import KeyStats as RefKeyStats
from repro.core.balancer import ModHash as RefModHash
from repro.core.balancer import pkg_route as ref_pkg_route
from repro.core.balancer import pkg_route_stats as ref_pkg_route_stats
from repro.core.balancer import resolve_strategy as ref_resolve_strategy
from repro.core.balancer import splitmix64 as ref_splitmix64
from repro.core.balancer import strategy_names as ref_strategy_names
from repro.core.balancer.hashing import ExplicitHash as RefExplicitHash
from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.streams import PartialWordCount as RefPartialWordCount
from repro.streams import WordCount as RefWordCount
from repro.streams import keyed_stage as ref_keyed_stage
from repro_torch.core import (Assignment, BalanceConfig, ConsistentHash,
                              Hash32, KeyStats, ModHash, RebalanceController)
from repro_torch.core.balancer import (ExplicitHash, PartialKeyGrouping,
                                       PowerOfBothChoices, WChoices,
                                       pkg_route, pkg_route_stats,
                                       resolve_strategy, splitmix64,
                                       strategy_names)
from repro_torch.streams import (DeviceBackend, KeyedStage, MergeCounts,
                                 PartialWordCount, WordCount, keyed_stage)

ROUTERS = ("pkg", "potc", "wchoices")
REPORT_FIELDS = ("interval", "tuples", "makespan", "migration_stall",
                 "throughput", "skewness", "theta", "migrated_bytes",
                 "table_size", "buffered")


def _keys(seed, n=3000):
    """Keys over the whole int64 range: negatives, zero, near-max."""
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, -1, -2, np.iinfo(np.int64).max,
                     np.iinfo(np.int64).max - 1, np.iinfo(np.int64).min,
                     2**31 - 1, 2**31, 2**32, -(2**31)], dtype=np.int64)
    wide = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                        size=n, dtype=np.int64)
    return np.concatenate([edge, wide, rng.integers(-50, 500, size=n)])


def _zipf_keys(seed, z, n, k):
    rng = np.random.default_rng(seed)
    return (rng.zipf(z, size=n) % k).astype(np.int64)


def _port_stats(stats):
    return KeyStats(keys=stats.keys, cost=stats.cost, mem=stats.mem,
                    freq=stats.freq)


# -- hashing ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 0x9E3779B97F4A7C15, 12345])
def test_splitmix64_matches_jax(seed):
    x = _keys(1).view(np.uint64)
    np.testing.assert_array_equal(splitmix64(x, seed),
                                  ref_splitmix64(x, seed))
    np.testing.assert_array_equal(splitmix64(x), ref_splitmix64(x))


@pytest.mark.parametrize("n_dest,seed", [(1, 0), (7, 3), (16, 2**40 + 7),
                                         (13, -5)])
def test_base_hashers_match_jax(n_dest, seed):
    keys = _keys(2)
    pairs = [(ModHash(n_dest, seed), RefModHash(n_dest, seed)),
             (ConsistentHash(n_dest, seed=seed),
              RefConsistentHash(n_dest, seed=seed)),
             (ConsistentHash(n_dest, vnodes=5, seed=seed),
              RefConsistentHash(n_dest, vnodes=5, seed=seed))]
    mapping = {0: n_dest - 1, -1: 0, int(keys[20]): n_dest // 2}
    pairs.append((ExplicitHash(mapping, n_dest, seed),
                  RefExplicitHash(mapping, n_dest, seed)))
    for port, ref in pairs:
        got = port(keys)
        np.testing.assert_array_equal(got, ref(keys))
        assert got.min() >= 0 and got.max() < n_dest
        np.testing.assert_array_equal(port.with_n_dest(n_dest + 3)(keys),
                                      ref.with_n_dest(n_dest + 3)(keys))
        assert port.with_n_dest(n_dest + 3).n_dest == n_dest + 3
    assert ExplicitHash(mapping, n_dest, seed)(np.array([0]))[0] == n_dest - 1


def test_consistent_hash_scale_out_remaps_few_keys():
    """Adding one destination moves only keys onto the new one, about
    K/(N+1) of them, as the JAX package's ring does."""
    keys = np.arange(20_000, dtype=np.int64)
    for n in (4, 10):
        before = ConsistentHash(n, seed=1)
        after = before.with_n_dest(n + 1)
        a, b = before(keys), after(keys)
        np.testing.assert_array_equal(b, RefConsistentHash(n + 1, seed=1)(keys))
        moved = a != b
        assert (b[moved] == n).all()
        assert 0 < moved.mean() < 2.0 / (n + 1)
        # a plain mod hash remaps most keys
        assert (ModHash(n, 1)(keys) != ModHash(n + 1, 1)(keys)).mean() > 0.5


# -- the sequential PKG oracles --------------------------------------------

@pytest.mark.parametrize("n_dest,seed", [(4, 0), (11, 7)])
def test_pkg_route_matches_jax(n_dest, seed):
    keys = _zipf_keys(3, 1.4, 2000, 300)
    w = np.random.default_rng(4).uniform(0.5, 2.0, size=keys.size)
    got, want = pkg_route(keys, w, n_dest, seed), \
        ref_pkg_route(keys, w, n_dest, seed)
    np.testing.assert_array_equal(got.loads, want.loads)
    assert got.split_keys == want.split_keys > 0
    assert got.merge_cost == want.merge_cost
    uniq, counts = np.unique(keys, return_counts=True)
    stats = RefKeyStats(keys=uniq, cost=counts * 1.5, mem=counts * 8.0,
                        freq=counts.astype(np.float64))
    got = pkg_route_stats(_port_stats(stats), n_dest, chunks=5, seed=seed)
    want = ref_pkg_route_stats(stats, n_dest, chunks=5, seed=seed)
    np.testing.assert_array_equal(got.loads, want.loads)
    assert (got.split_keys, got.merge_cost) == \
        (want.split_keys, want.merge_cost)


# -- the routers ------------------------------------------------------------

def _bound_pair(name, n_dest, seed, hash_cls=(Hash32, RefHash32), **kw):
    port = type(resolve_strategy(name))(**kw)
    ref = type(ref_resolve_strategy(name))(**kw)
    port.bind(Assignment(hash_cls[0](n_dest, seed=seed)))
    ref.bind(RefAssignment(hash_cls[1](n_dest, seed=seed)))
    return port, ref


@pytest.mark.parametrize("name,kw", [
    ("pkg", {}), ("pkg", {"n_choices": 3, "chunk": 97}),
    ("potc", {}), ("potc", {"n_sources": 3, "chunk": 64}),
    ("wchoices", {}), ("wchoices", {"head_threshold": 0.05,
                                    "head_capacity": 8, "chunk": 200}),
])
def test_router_routes_match_jax(name, kw):
    """Candidates, per-batch routes and loads over several batches, with
    W-Choices' head set refreshed between them."""
    n_dest = 7
    port, ref = _bound_pair(name, n_dest, seed=4,
                            hash_cls=(ModHash, RefModHash), **kw)
    uk = np.arange(-20, 400, dtype=np.int64)
    np.testing.assert_array_equal(port.candidates(uk), ref.candidates(uk))
    for b in range(4):
        keys = _zipf_keys(10 + b, 1.3, 1500 + 37 * b, 400)
        got, want = port.route(keys), ref.route(keys)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(port.loads, ref.loads)
        uniq, counts = np.unique(keys, return_counts=True)
        stats = RefKeyStats(keys=uniq, cost=counts.astype(np.float64),
                            mem=counts * 16.0,
                            freq=counts.astype(np.float64))
        port.on_stats(_port_stats(stats))
        ref.on_stats(stats)
        if name == "wchoices":
            np.testing.assert_array_equal(port.head_keys, ref.head_keys)
    assert port.loads.sum() == sum(1500 + 37 * b for b in range(4))
    if name == "wchoices":
        assert port.head_keys.size > 0


def test_potc_one_source_is_pkg():
    """The Power of Both Choices with one source routes as PKG, and a stage
    under it reports as a PKG stage does (the JAX package's strategy-matrix
    parity)."""
    pkg, _ = _bound_pair("pkg", 5, seed=2)
    potc, _ = _bound_pair("potc", 5, seed=2, n_sources=1)
    for b in range(3):
        keys = _zipf_keys(b, 1.2, 2000, 300)
        np.testing.assert_array_equal(pkg.route(keys), potc.route(keys))
    np.testing.assert_array_equal(pkg.loads, potc.loads)
    stages = [keyed_stage(PartialWordCount(), 5, 0.05, window=2, seed=2,
                          algorithm=algo, device="cpu")
              for algo in ("pkg", PowerOfBothChoices(n_sources=1))]
    for b in range(3):
        keys = _zipf_keys(40 + b, 1.2, 2000, 300)
        reps = [st.process_interval_arrays(keys) for st in stages]
        for field in REPORT_FIELDS:
            assert getattr(reps[0], field) == getattr(reps[1], field)
        np.testing.assert_array_equal(reps[0].task_loads, reps[1].task_loads)
    assert stages[0].outputs == stages[1].outputs


@pytest.mark.parametrize("name", ROUTERS)
def test_router_candidate_fn_and_validation(name):
    fixed = lambda uk: np.stack([uk % 3, (uk + 1) % 3], axis=1)  # noqa: E731
    port, ref = _bound_pair(name, 3, seed=0, candidate_fn=fixed)
    keys = _zipf_keys(7, 1.5, 700, 50)
    np.testing.assert_array_equal(port.route(keys), ref.route(keys))
    for bad in ({"n_choices": 0}, {"chunk": 0}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            type(resolve_strategy(name))(**bad)


# -- registry, controller ---------------------------------------------------

def test_registry_and_flags_match_jax():
    assert strategy_names() == ref_strategy_names()
    for name in strategy_names():
        port, ref = resolve_strategy(name), ref_resolve_strategy(name)
        for flag in ("name", "kind", "is_router", "plans_migration",
                     "needs_merge_stage"):
            assert getattr(port, flag) == getattr(ref, flag), (name, flag)
        assert resolve_strategy(name) is not port     # a fresh instance
    assert isinstance(resolve_strategy("pkg"), PartialKeyGrouping)
    assert isinstance(resolve_strategy("potc"), PowerOfBothChoices)
    assert isinstance(resolve_strategy("wchoices"), WChoices)
    router = resolve_strategy("pkg")
    assert resolve_strategy(router) is router


@pytest.mark.parametrize("name", ROUTERS)
def test_controller_under_router_never_triggers(name):
    n_dest = 5
    port = RebalanceController(Assignment(Hash32(n_dest, seed=3)),
                               BalanceConfig(theta_max=0.0),
                               algorithm=name)
    ref = RefController(RefAssignment(RefHash32(n_dest, seed=3)),
                        RefConfig(theta_max=0.0), algorithm=name)
    for i in range(3):
        keys = _zipf_keys(20 + i, 1.5, 1200, 100)
        port.strategy.route(keys)
        ref.strategy.route(keys)
        uniq, counts = np.unique(keys, return_counts=True)
        stats = RefKeyStats(keys=uniq, cost=counts.astype(np.float64),
                            mem=counts * 4.0, freq=counts.astype(np.float64))
        assert not port.should_trigger(_port_stats(stats))
        assert not ref.should_trigger(stats)
        ev_p, ev_r = port.on_interval(_port_stats(stats)), \
            ref.on_interval(stats)
        assert (ev_p.interval, ev_p.triggered, ev_p.theta_before) == \
            (ev_r.interval, ev_r.triggered, ev_r.theta_before)
        assert not ev_p.triggered and ev_p.result is None
    assert port.triggered_intervals() == [] == ref.triggered_intervals()
    assert port.assignment_version == 0 and port.assignment.table_size == 0
    with pytest.raises(ValueError) as got:
        port.rescale(n_dest + 1, _port_stats(stats))
    with pytest.raises(ValueError) as want:
        ref.rescale(n_dest + 1, stats)
    assert str(got.value) == str(want.value)
    assert "choice router" in str(got.value)


# -- refusals ---------------------------------------------------------------

def _messages_match(got, want):
    assert str(got.value).replace("repro_torch.", "repro.") == \
        str(want.value)


@pytest.mark.parametrize("name", ROUTERS)
def test_device_backend_refuses_routers(name):
    port_ctrl = RebalanceController(Assignment(Hash32(4, seed=1)),
                                    BalanceConfig(), algorithm=name)
    ref_ctrl = RefController(RefAssignment(RefHash32(4, seed=1)),
                             RefConfig(), algorithm=name)
    with pytest.raises(ValueError) as got:
        KeyedStage(PartialWordCount(), port_ctrl, state_backend="device",
                   device="cpu")
    with pytest.raises(ValueError) as want:
        from repro.streams import KeyedStage as RefStage
        RefStage(RefPartialWordCount(), ref_ctrl, state_backend="device")
    _messages_match(got, want)
    # auto never picks the device ring for a router, even on a card (the
    # classmethod needs no card); a table planner on the same operator does
    cuda = torch.device("cuda")
    assert not DeviceBackend.auto_eligible(PartialWordCount(), port_ctrl,
                                           True, cuda)
    mixed = RebalanceController(Assignment(Hash32(4, seed=1)),
                                BalanceConfig())
    assert DeviceBackend.auto_eligible(PartialWordCount(), mixed, True, cuda)
    assert not DeviceBackend.auto_eligible(PartialWordCount(), mixed, False,
                                           cuda)
    assert not DeviceBackend.auto_eligible(PartialWordCount(), mixed, True,
                                           torch.device("cpu"))
    stage = KeyedStage(PartialWordCount(), port_ctrl, device="cpu")
    assert stage.state_backend == "columnar"


@pytest.mark.parametrize("name", ROUTERS)
def test_router_refuses_non_split_safe_operator(name):
    for op in (WordCount(), PartialWordCount(), MergeCounts()):
        ctrl = RebalanceController(Assignment(ModHash(4, seed=1)),
                                   BalanceConfig(), algorithm=name)
        ref_ctrl = RefController(RefAssignment(RefModHash(4, seed=1)),
                                 RefConfig(), algorithm=name)
        ref_op = {"wordcount": RefWordCount, "partial_wordcount":
                  RefPartialWordCount}.get(op.name)
        if op.split_safe:
            KeyedStage(op, ctrl, device="cpu")
            continue
        with pytest.raises(ValueError) as got:
            KeyedStage(op, ctrl, device="cpu")
        from repro.streams import KeyedStage as RefStage
        with pytest.raises(ValueError) as want:
            RefStage(ref_op(), ref_ctrl)
        _messages_match(got, want)
    # the same check when the algorithm arrives through KeyedStage
    ctrl = RebalanceController(Assignment(ModHash(4, seed=1)),
                               BalanceConfig())
    with pytest.raises(ValueError, match="not split-safe"):
        KeyedStage(WordCount(), ctrl, device="cpu", algorithm=name)


@pytest.mark.parametrize("name", ROUTERS)
def test_scale_to_refuses_router_before_growing(name):
    stage = keyed_stage(PartialWordCount(), 4, 0.1, algorithm=name,
                        device="cpu")
    ref = ref_keyed_stage(RefPartialWordCount(), 4, 0.1, algorithm=name)
    keys = _zipf_keys(1, 1.3, 500, 80)
    stage.process_interval_arrays(keys)
    ref.process_interval_arrays(keys)
    held = stage.total_state_keys()
    with pytest.raises(ValueError) as got:
        stage.scale_to(7)
    with pytest.raises(ValueError) as want:
        ref.scale_to(7)
    assert str(got.value) == str(want.value)
    assert len(stage.stores) == 4 and stage.n_tasks == 4
    assert stage.total_state_keys() == held
    # a fresh router stage refuses before the "no interval yet" check
    with pytest.raises(ValueError, match="choice router"):
        keyed_stage(PartialWordCount(), 4, 0.1, algorithm=name,
                    device="cpu").scale_to(5)


# -- router stages against the JAX keyed_stage ------------------------------

@pytest.mark.parametrize("name,hash_pair", [
    ("pkg", "modhash"), ("potc", "modhash"), ("wchoices", "modhash"),
    ("pkg", "hash32")])
def test_router_stage_matches_jax(name, hash_pair):
    hashes = {"modhash": (ModHash, RefModHash),
              "hash32": (Hash32, RefHash32)}[hash_pair]
    kw = dict(table_max=200, window=3, seed=5, algorithm=name)
    port = keyed_stage(PartialWordCount(), 7, 0.05, hash_cls=hashes[0],
                       device="cpu", **kw)
    ref = ref_keyed_stage(RefPartialWordCount(), 7, 0.05,
                          hash_cls=hashes[1], **kw)
    for i in range(4):
        keys = _zipf_keys(30 + i, 1.2, 2500, 500)
        rp, ekp, evp = port.process_interval_emits(keys)
        rr, ekr, evr = ref.process_interval_emits(keys)
        for field in REPORT_FIELDS:
            assert getattr(rp, field) == getattr(rr, field), (i, field)
        np.testing.assert_array_equal(rp.task_loads, rr.task_loads)
        np.testing.assert_array_equal(ekp, ekr)
        np.testing.assert_array_equal(evp, evr)
        np.testing.assert_array_equal(port.controller.strategy.loads,
                                      ref.controller.strategy.loads)
    assert port.outputs == ref.outputs
    assert port.emitted_sum == ref.emitted_sum
    assert port.total_state_keys() == ref.total_state_keys()
    # the router split keys: some key sits on more than one task
    held = {}
    for t, store in enumerate(port.stores):
        for k in store.keys:
            held.setdefault(k, []).append(t)
    assert max(len(v) for v in held.values()) > 1
    assert [ev.theta_before for ev in port.controller.history] == \
        [ev.theta_before for ev in ref.controller.history]
