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
                                 routing_lookup)


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
