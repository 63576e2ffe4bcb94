"""The port's kernel wrappers and plain versions against the JAX package.

Same inputs, made with numpy from a fixed seed, go through the JAX oracle
(``repro.kernels.ref``), the JAX Pallas kernel in interpret mode, and the
port's wrapper on CPU tensors (which takes the plain PyTorch version).
Routing is integer: bit-equal. freq is a count: equal. cost is a float32 sum
in another order: within 1e-6 relative, the reference's own stats tolerance.
The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.core.balancer.hashing import fmix32 as ref_np_fmix32
from repro.kernels import ref as jref
from repro.kernels.key_stats import key_stats as pallas_key_stats
from repro.kernels.routing_lookup import routing_lookup as pallas_routing
from repro_torch.core.balancer import Hash32, fmix32 as np_fmix32
from repro_torch.kernels import (RoutingTable, key_stats, ref, route_keys,
                                 route_plain, routing_lookup)
from repro_torch.kernels.key_stats import key_sums
from repro_torch.kernels.routing_lookup import MAX_TABLE


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _edge_keys():
    """int32 boundary ids plus keys whose fmix32 hash lands >= 2**31 — the
    mix/modulo must stay unsigned end-to-end or those wrap negative."""
    edge = np.array([0, 1, 2**31 - 2, 2**31 - 1], dtype=np.int64)
    probe = np.arange(4096, dtype=np.int64)
    high = probe[ref_np_fmix32(probe.astype(np.uint32), 5) >= 2**31]
    assert high.size > 0
    return np.concatenate([edge, high[:64]])


# -------------------------------------------------------------- hashing --
@pytest.mark.parametrize("seed", [0, 5, 0x9E3779B9, 2**32 - 1])
def test_fmix32_bit_equal_across_packages(seed):
    keys = np.concatenate([np.arange(20_000, dtype=np.int64), _edge_keys(),
                           np.array([-1, -2, -(2**31)], dtype=np.int64)])
    want = ref_np_fmix32(keys.astype(np.uint32), seed)
    np.testing.assert_array_equal(np_fmix32(keys.astype(np.uint32), seed),
                                  want)
    got = ref.fmix32(_t(keys.astype(np.int32)), seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    jgot = np.asarray(jref.fmix32(jnp.asarray(keys.astype(np.int32)), seed))
    np.testing.assert_array_equal(got, jgot.astype(np.int64))


@pytest.mark.parametrize("n_dest,seed", [(13, 5), (15, 0), (1, 3), (256, 7)])
def test_hash32_bit_equal_across_packages(n_dest, seed):
    keys = np.concatenate([np.arange(5000, dtype=np.int64), _edge_keys()])
    np.testing.assert_array_equal(Hash32(n_dest, seed)(keys),
                                  RefHash32(n_dest, seed)(keys))


# -------------------------------------------------------- routing_lookup --
def _table(rng, a, n_dest, universe=10_000):
    tkeys = np.full((a,), -1, np.int32)
    tdests = np.zeros((a,), np.int32)
    n_real = max(1, a // 2)
    tkeys[:n_real] = rng.choice(universe, size=n_real, replace=False)
    tdests[:n_real] = rng.integers(0, n_dest, size=n_real)
    perm = rng.permutation(a)               # empty slots anywhere
    return tkeys[perm], tdests[perm]


@pytest.mark.parametrize("n,a,n_dest", [
    (100, 16, 4), (2048, 128, 16), (5000, 1000, 256), (63, 1, 2),
    (1000, 4096, 15),
])
def test_routing_lookup_matches_jax(n, a, n_dest):
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 10_000, size=n).astype(np.int32)
    tkeys, tdests = _table(rng, a, n_dest)
    got = routing_lookup(_t(keys), _t(tkeys), _t(tdests), n_dest,
                         seed=7).numpy()
    oracle = np.asarray(jref.routing_lookup(
        jnp.asarray(keys), jnp.asarray(tkeys), jnp.asarray(tdests), n_dest,
        seed=7))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(
        ref.routing_lookup(_t(keys), _t(tkeys), _t(tdests), n_dest,
                           seed=7).numpy(), oracle)
    if a <= 1000:                           # interpret mode is slow at 4096
        pallas = np.asarray(pallas_routing(
            jnp.asarray(keys), jnp.asarray(tkeys), jnp.asarray(tdests),
            n_dest, seed=7, interpret=True))
        np.testing.assert_array_equal(got, pallas)


def test_routing_edge_keys_match_host_planner():
    keys = _edge_keys()
    empty_k = np.full(8, -1, np.int32)
    empty_d = np.zeros(8, np.int32)
    got = routing_lookup(_t(keys.astype(np.int32)), _t(empty_k), _t(empty_d),
                         13, seed=5).numpy()
    np.testing.assert_array_equal(got, RefHash32(13, seed=5)(keys))
    pallas = np.asarray(pallas_routing(
        jnp.asarray(keys.astype(np.int32)), jnp.asarray(empty_k),
        jnp.asarray(empty_d), 13, seed=5, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    # an override on the largest id still wins
    tk = empty_k.copy()
    tk[3] = 2**31 - 1
    td = empty_d.copy()
    td[3] = 11
    got = routing_lookup(_t(keys.astype(np.int32)), _t(tk), _t(td), 13,
                         seed=5).numpy()
    assert got[3] == 11
    np.testing.assert_array_equal(np.delete(got, 3),
                                  np.delete(RefHash32(13, seed=5)(keys), 3))


def test_routing_table_is_reusable_and_route_keys_counts_nothing_on_cpu():
    rng = np.random.default_rng(4)
    tkeys, tdests = _table(rng, 256, 9)
    table = RoutingTable(_t(tkeys), _t(tdests))
    before = route_keys.launches
    for n in (1, 17, 3000):
        keys = rng.integers(0, 10_000, size=n).astype(np.int32)
        np.testing.assert_array_equal(
            route_keys(_t(keys), table, 9, seed=1).numpy(),
            np.asarray(jref.routing_lookup(jnp.asarray(keys),
                                           jnp.asarray(tkeys),
                                           jnp.asarray(tdests), 9, seed=1)))
    assert route_keys.launches == before      # the plain version ran
    assert route_keys(_t(np.zeros(0, np.int32)), table, 9).numel() == 0


def test_routing_rejects_duplicate_table_keys():
    tk = _t(np.array([4, 7, -1, 4], np.int32))
    td = _t(np.array([1, 2, 0, 3], np.int32))
    with pytest.raises(ValueError, match="duplicate routing table key 4"):
        routing_lookup(_t(np.array([4], np.int32)), tk, td, 10)
    # several empty slots (-1) are no duplicates
    tk = _t(np.array([4, -1, -1, -1], np.int32))
    assert int(routing_lookup(_t(np.array([4], np.int32)), tk, td, 10)[0]) \
        == 1


def _negative_key_cases():
    """ROADMAP's probe (keys -1 and -2 against a table with empty slots),
    then seeded tables laid out as ``Assignment.table_arrays`` lays them
    out (entries first, then key -1 / dest 0), with negative keys mixed in."""
    yield (np.array([-1, -2, 5, 7], np.int32), np.array([5, -1, -1, -1],
                                                          np.int32),
           np.array([3, 0, 0, 0], np.int32), 13, 5)
    rng = np.random.default_rng(17)
    for a, n_real in ((8, 3), (64, 63), (32, 0)):
        tk = np.full(a, -1, np.int32)
        td = np.zeros(a, np.int32)
        tk[:n_real] = rng.choice(500, size=n_real, replace=False)
        td[:n_real] = rng.integers(1, 9, size=n_real)
        keys = np.concatenate([rng.integers(0, 500, 200),
                               [-1, -2, -3, -(2**31), -1]]).astype(np.int32)
        yield keys, tk, td, 9, 3


@pytest.mark.parametrize("case", range(4))
def test_negative_keys_route_as_the_reference(case):
    """Key -1 takes the first empty slot's dest (0), as the JAX package's
    ``ref.routing_lookup`` and its Pallas kernel give; keys below -1 route
    by their hash. The port's wrapper, its ``route_plain`` and its
    ``kernels/ref.routing_lookup`` all agree."""
    keys, tk, td, n_dest, seed = list(_negative_key_cases())[case]
    oracle = np.asarray(jref.routing_lookup(
        jnp.asarray(keys), jnp.asarray(tk), jnp.asarray(td), n_dest,
        seed=seed))
    pallas = np.asarray(pallas_routing(
        jnp.asarray(keys), jnp.asarray(tk), jnp.asarray(td), n_dest,
        seed=seed, interpret=True))
    np.testing.assert_array_equal(pallas, oracle)
    if case == 0:
        np.testing.assert_array_equal(oracle, [0, 8, 3, 6])
    table = RoutingTable(_t(tk), _t(td))
    for got in (routing_lookup(_t(keys), _t(tk), _t(td), n_dest, seed=seed),
                route_plain(_t(keys), table, n_dest, seed=seed),
                ref.routing_lookup(_t(keys), _t(tk), _t(td), n_dest,
                                   seed=seed)):
        np.testing.assert_array_equal(got.numpy(), oracle)


def _probe_emulation(keys, table, n_dest, seed):
    """The routing kernel's probe loop in plain torch over the host table:
    (dests, the probe at which each key was found or -1)."""
    buckets = table.buckets.cpu()
    nb = buckets.shape[0]
    home = (ref.fmix32(keys, table.salt) * table.n_home) >> 32
    out = (ref.fmix32(keys, seed) % n_dest).to(torch.int32)
    found = torch.full(keys.shape, -1, dtype=torch.int64)
    done = torch.zeros(keys.shape, dtype=torch.bool)
    for p in range(table.max_probe):
        e = buckets[(home + p).clamp(max=nb - 1)]
        for kc, dc in ((0, 1), (2, 3)):
            hit = ~done & (e[:, kc] == keys) & (e[:, dc] >= 0)
            out = torch.where(hit, e[:, dc], out)
            found = torch.where(hit, p, found)
            done |= hit
        done |= (e[:, 1] < 0) | (e[:, 3] < 0)
    return out, found


@pytest.mark.parametrize("a,n_real", [(1, 0), (128, 64), (4096, 3000),
                                      (16384, 16381), (32768, 24000)])
def test_routing_table_probe_matches_references(a, n_real):
    """The host-built hash table, probed as the kernel probes it, routes as
    ``route_plain``, the JAX ``ref.routing_lookup`` and Pallas interpret do:
    table keys, misses, keys -1, -2, INT32_MIN and 2**31 - 1, against empty
    slots with different dests (key -1 takes the first one's). Every table
    key is found within the recorded longest chain, which some key needs.
    Up to ``MAX_TABLE`` slots the table takes at most 192 KB; past it (the
    32,768-slot case) each distinct key gets 4 home buckets."""
    rng = np.random.default_rng(a + n_real)
    tk = np.full(a, -1, np.int32)
    tk[:n_real] = rng.choice(2**31 - 1, size=n_real, replace=False)
    td = rng.integers(0, 13, size=a).astype(np.int32)
    perm = rng.permutation(a)
    tk, td = tk[perm], td[perm]
    real = tk[tk >= 0]
    keys = np.concatenate([
        rng.choice(real, size=min(real.size, 400)) if real.size else [],
        rng.integers(-2**31, 2**31 - 1, size=300), _edge_keys(),
        [-1, -2, -(2**31), 2**31 - 1, -1]]).astype(np.int32)
    table = RoutingTable.build(tk, td)
    assert table.device == torch.device("cpu") and len(table) == a
    got, found = _probe_emulation(_t(keys), table, 13, 7)
    oracle = np.asarray(jref.routing_lookup(
        jnp.asarray(keys), jnp.asarray(tk), jnp.asarray(td), 13, seed=7))
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(
        route_plain(_t(keys), table, 13, seed=7).numpy(), oracle)
    pallas = np.asarray(pallas_routing(
        jnp.asarray(keys), jnp.asarray(tk), jnp.asarray(td), 13, seed=7,
        interpret=True))
    # Pallas takes the largest dest among equal table keys, so it parts from
    # the first-slot rule only on key -1 against empty slots of other dests
    other = keys != -1
    np.testing.assert_array_equal(got.numpy()[other], pallas[other])
    empty = td[tk == -1]
    if empty.size:
        assert (got.numpy()[~other] == empty[0]).all()
        assert (pallas[~other] == empty.max()).all()
    # the chain bound: every distinct table key is found, the longest needs
    # exactly max_probe buckets
    distinct = np.unique(tk)
    _, at = _probe_emulation(_t(distinct), table, 13, 7)
    assert (at >= 0).all()
    assert int(at.max()) + 1 == table.max_probe <= 16
    if a <= MAX_TABLE:
        assert table.buckets.shape[0] * 16 <= 192 * 1024
    else:
        assert table.n_home == 4 * distinct.size


def test_routing_table_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="duplicate routing table key 4"):
        RoutingTable.build(np.array([4, -1, 4]), np.array([1, 0, 2]))
    with pytest.raises(ValueError, match="dests must be >= 0"):
        RoutingTable.build(np.array([4, -1]), np.array([1, -1]))
    # no bound on the slots but the kernel's int32 bucket index: one past
    # MAX_TABLE builds, as the JAX package's kernel takes any table
    table = RoutingTable.build(np.full(16385, -1), np.zeros(16385))
    assert len(table) == 16385 and table.max_probe == 1
    # -1 and other negative keys may repeat: the first slot wins
    table = RoutingTable.build(np.array([-2, -1, -2, -1]),
                               np.array([3, 5, 4, 6]))
    np.testing.assert_array_equal(
        route_plain(_t(np.array([-2, -1], np.int32)), table, 7).numpy(),
        [3, 5])


def test_large_table_stage_matches_jax_pallas_stage():
    """A ``substrate="kernels"`` stage whose routing table holds 20,000
    entries (32,768 slots once the engine pads it to a power of two, past
    ``MAX_TABLE``) against the JAX stage on ``substrate="pallas"`` (interpret
    mode) holding the same table: routes, reports and counts bit for bit
    over two intervals. theta_max is high, so neither stage plans and the
    table stays as installed."""
    from repro.core import Assignment as RefAssignment
    from repro.core import BalanceConfig as RefConfig
    from repro.core import RebalanceController as RefController
    from repro.streams import KeyedStage as RefStage
    from repro.streams import WordCount as RefWordCount
    from repro_torch.core import Assignment, BalanceConfig, RebalanceController
    from repro_torch.streams import KeyedStage, WordCount

    rng = np.random.default_rng(13)
    tkeys = rng.choice(2**20, size=20_000, replace=False)
    table = dict(zip(tkeys.tolist(), rng.integers(0, 7, tkeys.size).tolist()))
    kw = dict(theta_max=100.0, table_max=30_000, window=2)
    ref = RefStage(RefWordCount(), RefController(
        RefAssignment(RefHash32(7, seed=4), dict(table)), RefConfig(**kw),
        algorithm="mixed"), window=2, vectorized=True,
        state_backend="columnar", substrate="pallas")
    port = KeyedStage(WordCount(), RebalanceController(
        Assignment(Hash32(7, seed=4), dict(table)), BalanceConfig(**kw),
        algorithm="mixed"), window=2, state_backend="device",
        substrate="kernels", device="cpu")
    for i in range(2):
        keys = np.concatenate([rng.choice(tkeys, 1500),
                               rng.integers(0, 2**20, 1500)]).astype(np.int64)
        np.testing.assert_array_equal(port._dest_batch(keys),
                                      ref._dest_batch(keys))
        port.process_interval_arrays(keys, None)
        ref.process_interval_arrays(keys, None)
    assert len(port._route_cache[1]) == 32_768 > MAX_TABLE
    for rp, rr in zip(port.reports, ref.reports):
        assert rp.table_size == rr.table_size == 20_000
        assert (rp.tuples, rp.makespan, rp.migrated_bytes) == \
            (rr.tuples, rr.makespan, rr.migrated_bytes)
        np.testing.assert_array_equal(rp.task_loads, rr.task_loads)
    assert port.outputs == ref.outputs


@pytest.mark.parametrize("bad", [torch.int64, torch.float32, torch.int16])
def test_routing_rejects_non_int32(bad):
    keys = torch.tensor([1, 2, 3], dtype=torch.int32)
    tk = torch.full((8,), -1, dtype=torch.int32)
    td = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32 keys"):
        routing_lookup(keys.to(bad), tk, td, 4)
    with pytest.raises(TypeError, match="int32 table_keys"):
        routing_lookup(keys, tk.to(bad), td, 4)
    with pytest.raises(TypeError, match="int32 table_dests"):
        routing_lookup(keys, tk, td.to(bad), 4)


def test_routing_rejects_bad_shapes_and_devices():
    keys = torch.tensor([1, 2, 3], dtype=torch.int32)
    tk = torch.full((8,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="one shape"):
        routing_lookup(keys, tk, torch.zeros(4, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="1-D"):
        routing_lookup(keys.reshape(3, 1), tk, torch.zeros_like(tk), 4)
    with pytest.raises(ValueError, match="n_dest"):
        routing_lookup(keys, tk, torch.zeros_like(tk), 0)
    table = RoutingTable(tk, torch.zeros_like(tk))
    with pytest.raises(ValueError, match="routing table on"):
        route_keys(keys.to("meta"), table, 4)


# ------------------------------------------------------------- key_stats --
@pytest.mark.parametrize("n,num_keys,block_n,block_k", [
    (64, 16, 32, 16),
    (1000, 257, 128, 128),
    (4096, 1024, 512, 512),
    (777, 33, 256, 64),
])
def test_key_stats_matches_jax(n, num_keys, block_n, block_k):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, num_keys, size=n).astype(np.int32)
    costs = rng.uniform(0.1, 3.0, size=n).astype(np.float32)
    freq, cost = key_stats(_t(keys), _t(costs, torch.float32), num_keys)
    jfreq, jcost = jref.key_stats(jnp.asarray(keys), jnp.asarray(costs),
                                  num_keys)
    np.testing.assert_array_equal(freq.numpy(), np.asarray(jfreq))
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-6)
    pfreq, pcost = pallas_key_stats(jnp.asarray(keys), jnp.asarray(costs),
                                    num_keys, block_n=block_n,
                                    block_k=block_k, interpret=True)
    np.testing.assert_array_equal(freq.numpy(), np.asarray(pfreq))
    np.testing.assert_allclose(cost.numpy(), np.asarray(pcost), rtol=1e-6)


def test_key_stats_ignores_padding_and_out_of_range_keys():
    keys = np.array([0, 1, -1, 1, -1, 4, 2**31 - 1, 3, 2**31 - 2],
                    dtype=np.int32)
    costs = np.arange(1, 10, dtype=np.float32)
    freq, cost = key_stats(_t(keys), _t(costs, torch.float32), 4)
    np.testing.assert_array_equal(freq.numpy(), [1, 2, 0, 1])
    np.testing.assert_array_equal(cost.numpy(), [1, 6, 0, 8])
    jfreq, jcost = jref.key_stats(jnp.asarray(keys), jnp.asarray(costs), 4)
    np.testing.assert_array_equal(freq.numpy(), np.asarray(jfreq))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(jcost))
    pfreq, _ = pallas_key_stats(jnp.asarray(keys), jnp.asarray(costs), 4,
                                block_n=8, block_k=8, interpret=True)
    np.testing.assert_array_equal(freq.numpy(), np.asarray(pfreq))


@pytest.mark.parametrize("cost_dtype", [torch.float64, torch.bfloat16])
def test_key_stats_accumulates_any_float_in_float32(cost_dtype):
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 100, size=500).astype(np.int32)
    costs = torch.from_numpy(rng.uniform(0.5, 2.0, size=500)).to(cost_dtype)
    freq, cost = key_stats(_t(keys), costs, 100)
    assert freq.dtype == cost.dtype == torch.float32
    jcosts = jnp.asarray(costs.to(torch.float32).numpy())
    _, jcost = jref.key_stats(jnp.asarray(keys), jcosts, 100)
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), rtol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_key_sums_matches_two_jax_calls(dtype):
    """The stats path's two-weight form: each output is the JAX oracle's
    c(k) for that weight (two plain calls on the CPU)."""
    rng = np.random.default_rng(6)
    keys = rng.integers(-2, 300, size=2000).astype(np.int32)
    w1 = rng.uniform(0.5, 2.0, size=2000).astype(dtype)
    w2 = rng.integers(1, 9, size=2000).astype(dtype)
    s1, s2 = key_sums(_t(keys), torch.from_numpy(w1), torch.from_numpy(w2),
                      297)
    for got, w in ((s1, w1), (s2, w2)):
        _, want = jref.key_stats(jnp.asarray(keys),
                                 jnp.asarray(w.astype(np.float32)), 297)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError, match="one shape"):
        key_sums(_t(keys), torch.from_numpy(w1), torch.ones(3), 297)


@pytest.mark.parametrize("bad", [torch.int64, torch.float32, torch.int16])
def test_key_stats_rejects_non_int32_keys(bad):
    with pytest.raises(TypeError, match="int32 keys"):
        key_stats(torch.tensor([0, 1, 2]).to(bad), torch.ones(3), 4)


def test_key_stats_rejects_integer_costs_and_bad_shapes():
    keys = torch.tensor([0, 1, 2], dtype=torch.int32)
    with pytest.raises(TypeError, match="float costs"):
        key_stats(keys, torch.ones(3, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="one shape"):
        key_stats(keys, torch.ones(4), 4)
