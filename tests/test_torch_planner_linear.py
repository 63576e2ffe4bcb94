"""The Mixed planner's linear passes over the key universe against the
formulas they replace: F(k) with the table scattered into the hash,
the table keys' indices, gamma over the keys of positive cost, the
grouping of ranks by task on an int16 copy, and the psi order on a torch
device (the CPU here; ``test_torch_cuda.py`` holds the card's). One Mixed
case at 10^5 keys with a full table is held to the JAX planner.
"""

import numpy as np
import pytest
import torch

from repro.core.balancer import Assignment as RefAssignment
from repro.core.balancer import BalanceConfig as RefConfig
from repro.core.balancer import mixed as ref_mixed
from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.streams import WorkloadGen as RefGen
from repro_torch import trace
from repro_torch.core import (Assignment, BalanceConfig, Hash32, KeyStats,
                              RebalanceController)
from repro_torch.core.balancer import llfd
from repro_torch.core.balancer.llfd import (IN_CANDIDATES, PlannerContext,
                                            Workspace, card_orders, psi_ranks)
from repro_torch.core.balancer.phased import table_key_indices


def _dest_formula(assignment, keys):
    """F(k) as the K keys searched in the sorted table."""
    keys = np.asarray(keys, dtype=np.int64)
    out = assignment.hash_router(keys)
    if assignment.table:
        tkeys = np.array(sorted(assignment.table), dtype=np.int64)
        tdest = np.array([assignment.table[k] for k in tkeys], np.int64)
        pos = np.clip(np.searchsorted(tkeys, keys), 0, len(tkeys) - 1)
        out = np.where(tkeys[pos] == keys, tdest[pos], out)
    return out.astype(np.int64)


def _gamma_formula(cost, mem, beta):
    mem = np.where(mem <= 0.0, 1.0, mem)
    return np.power(np.maximum(cost, 0.0), beta) / mem


def _universes():
    rng = np.random.default_rng(3)
    dense = np.arange(5000, dtype=np.int64)
    sparse = np.sort(rng.choice(1 << 40, 20000, replace=False))
    return {"ascending": dense,
            "sparse_ascending": sparse.astype(np.int64),
            "unsorted": rng.permutation(sparse).astype(np.int64),
            "repeated": rng.choice(dense, 8000),
            "descending": dense[::-1].copy(),
            "empty": np.zeros(0, np.int64),
            "single": np.array([17], np.int64),
            "single_absent": np.array([10**9], np.int64),
            "negative": np.arange(-3000, 3000, 7, dtype=np.int64)}


def _table(universe, rng, n_in, n_out, n_dest):
    """Table keys from the universe and keys absent from it."""
    inside = (rng.choice(np.unique(universe), min(n_in, np.unique(
        universe).size), replace=False) if universe.size else [])
    outside = rng.integers(2**41, 2**42, n_out)
    return {int(k): int(rng.integers(n_dest))
            for k in list(inside) + list(outside)}


@pytest.mark.parametrize("name", list(_universes()))
@pytest.mark.parametrize("n_in,n_out", [(0, 0), (0, 40), (1, 0), (300, 50)])
def test_dest_equals_the_search_of_the_table(name, n_in, n_out):
    keys = _universes()[name]
    rng = np.random.default_rng(n_in + n_out)
    a = Assignment(Hash32(15, seed=5), _table(keys, rng, n_in, n_out, 15))
    want = _dest_formula(a, keys)
    got = a.dest(keys)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    hashed = a.hash_router(keys)
    np.testing.assert_array_equal(a.dest(keys, hashed=hashed), want)
    np.testing.assert_array_equal(hashed, a.hash_router(keys))  # untouched


@pytest.mark.parametrize("name", list(_universes()))
def test_table_key_indices_equal_isin(name):
    keys = _universes()[name]
    rng = np.random.default_rng(7)
    a = Assignment(Hash32(7, seed=1), _table(keys, rng, 200, 30, 7))
    stats = KeyStats(keys=keys, cost=np.ones(keys.size),
                     mem=np.ones(keys.size))
    got = table_key_indices(stats, a)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, np.flatnonzero(np.isin(keys, list(a.table))))


@pytest.mark.parametrize("beta", [1.5, 1.0, 2.0, 0.5, 0.0, -1.0])
def test_gamma_equals_the_formula(beta):
    rng = np.random.default_rng(11)
    n = 4000
    cost = rng.choice([0.0, -0.0, -2.0, 1.0, 3.5, 1e-300, np.inf, np.nan],
                      n, p=[.4, .05, .05, .2, .2, .04, .03, .03])
    mem = rng.choice([0.0, -1.0, 8.0, 40.0, np.inf, np.nan], n,
                     p=[.2, .05, .4, .3, .03, .02])
    stats = KeyStats(keys=np.arange(n), cost=cost, mem=mem)
    with np.errstate(divide="ignore", invalid="ignore"):
        got = stats.gamma(beta)
        want = _gamma_formula(cost, mem, beta)
    np.testing.assert_array_equal(got, want)        # NaN where NaN
    if beta > 0:
        assert not np.signbit(got[got == 0.0]).any()   # never -0.0


def _grouping_formula(ws):
    dest_by_rank = ws.assign[ws.ctx.order]
    perm = np.argsort(dest_by_rank, kind="stable")
    starts = np.searchsorted(dest_by_rank[perm], np.arange(ws.n_dest + 1))
    return [perm[starts[d]:starts[d + 1]] for d in range(ws.n_dest)]


@pytest.mark.parametrize("n_dest", [1, 15, (1 << 15) - 1, 1 << 15, 40000])
def test_int16_grouping_equals_the_int64_sort(n_dest):
    rng = np.random.default_rng(n_dest)
    k = 50000
    cost = rng.integers(0, 5, k).astype(np.float64)     # heavy psi ties
    stats = KeyStats(keys=np.arange(k), cost=cost, mem=np.ones(k))
    ws = Workspace(stats, Assignment(Hash32(n_dest, seed=2)),
                   BalanceConfig())
    ws.assign[rng.choice(k, 3000, replace=False)] = IN_CANDIDATES
    ws.assign[:3] = n_dest - 1
    ws._ensure_members()
    want = _grouping_formula(ws)
    assert len(ws._members) == len(want) == n_dest
    for got_d, want_d in zip(ws._members, want):
        np.testing.assert_array_equal(got_d, want_d)
    assert sum(m.size for m in ws._members) == k - 3000


def _counted(fn):
    """``fn()`` under a trace record, and the record."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        previous = trace.begin()
        try:
            out = fn()
        finally:
            record = trace.end(previous)
    return out, record


def _assert_stable_order(got, psi):
    """``got`` = (order, rank): numpy's stable argsort of -psi and its
    inverse, both int64."""
    order, rank = got
    want = np.argsort(-psi, kind="stable")
    np.testing.assert_array_equal(order, want)
    np.testing.assert_array_equal(rank[want], np.arange(psi.size))
    assert order.dtype == rank.dtype == np.int64


def _psi(n, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(0, 4, n).astype(np.float64) * 0.5
    if kind == "zeros":
        psi = np.zeros(n)
        psi[rng.choice(n, n // 5, replace=False)] = rng.random(n // 5)
        return psi
    return rng.random(n) ** 3


@pytest.mark.parametrize("kind", ["ties", "zeros", "distinct"])
@pytest.mark.parametrize("side", [-1, 0, 1])
def test_psi_ranks_on_a_device_equal_the_stable_argsort(kind, side):
    n = llfd.CARD_ORDER_MIN_KEYS + side
    psi = _psi(n, n, kind)
    got, record = _counted(lambda: psi_ranks(psi, torch.device("cpu")))
    _assert_stable_order(got, psi)
    _assert_stable_order(psi_ranks(psi), psi)
    assert record.counts.get("plan_card_orders", 0) == (side >= 0)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_psi_takes_the_host_sort(bad):
    psi = _psi(llfd.CARD_ORDER_MIN_KEYS, 1, "ties")
    psi[[5, 700]] = bad
    got, record = _counted(lambda: psi_ranks(psi, torch.device("cpu")))
    _assert_stable_order(got, psi)
    assert "plan_card_orders" not in record.counts


def test_negative_zero_psi_ties_with_positive_zero_on_the_device():
    psi = np.zeros(llfd.CARD_ORDER_MIN_KEYS)
    psi[::3] = -0.0
    psi[::7] = 1.0
    _assert_stable_order(psi_ranks(psi, torch.device("cpu")), psi)


def test_psi_ranks_stay_on_the_host_without_a_device(monkeypatch):
    monkeypatch.setattr(torch, "sort", None)       # no torch sort is called
    psi = _psi(2 * llfd.CARD_ORDER_MIN_KEYS, 2, "ties")
    with card_orders(None):
        np.testing.assert_array_equal(
            PlannerContext(KeyStats(keys=np.arange(psi.size), cost=psi,
                                    mem=np.ones(psi.size)),
                           Assignment(Hash32(5, seed=1)),
                           BalanceConfig()).order,
            np.argsort(-psi, kind="stable"))


def test_card_orders_nests_and_restores():
    assert llfd._card.get() is None
    with card_orders(torch.device("cpu")):
        with card_orders(None):
            assert llfd._card.get() is None
        assert llfd._card.get() == torch.device("cpu")
    assert llfd._card.get() is None


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "torch_cpu"])
def test_mixed_at_1e5_keys_with_a_full_table_matches_jax(device):
    """A sorted universe of 10^5 keys, a table held at its cap of 150: the
    table's scatter into the hash, its keys' indices and (with a device)
    the psi order through torch, against the JAX planner's plans."""
    k, n_dest, table_max = 100_000, 15, 150
    gen = RefGen(k=k, z=0.85, f=1.0, seed=4, window=5)
    ref_a = RefAssignment(RefHash32(n_dest, seed=4))
    ref_cfg = RefConfig(theta_max=0.02, table_max=table_max, window=5)
    ctrl = RebalanceController(
        Assignment(Hash32(n_dest, seed=4)),
        BalanceConfig(theta_max=0.02, table_max=table_max, window=5))
    ctrl.plan_device = None if device is None else torch.device(device)
    full = 0
    for i in range(4):
        stats = gen.interval(ref_a, fluctuate=i > 0)
        assert np.all(np.diff(stats.keys) > 0)
        want = ref_mixed(stats, ref_a, ref_cfg)
        got = ctrl.on_interval(KeyStats(keys=stats.keys, cost=stats.cost,
                                        mem=stats.mem, freq=stats.freq),
                               force=True).result
        assert got.assignment.table == want.assignment.table
        np.testing.assert_array_equal(np.sort(got.moved_keys),
                                      np.sort(want.moved_keys))
        np.testing.assert_array_equal(got.loads, want.loads)
        assert got.theta == want.theta
        assert got.migration_cost == want.migration_cost
        full += want.table_size == table_max
        ref_a = want.assignment
    assert full >= 2
    assert llfd._card.get() is None
