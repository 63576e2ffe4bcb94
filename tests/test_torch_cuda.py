"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests carry the ``cuda`` marker and skip where torch finds no CUDA
device (there is no CPU mode for a CUDA kernel); ``chip_smoke.py`` runs the
same comparisons at the main path's full shapes. On a machine with a card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (Assignment, BalanceConfig, Hash32,
                              RebalanceController)
from repro_torch.kernels import (RoutingTable, key_stats, key_stats_plain,
                                 route_keys, route_plain)
from repro_torch.streams import KeyedStage, MergeCounts, WordCount, WorkloadGen

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,a", [(1, 1), (1000, 128), (300_001, 4096),
                                 (70_000, 16384)])
def test_routing_kernel_matches_plain(cuda, n, a):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
    tk = np.full(a, -1, np.int32)
    tk[:a // 2] = rng.choice(np.unique(keys), size=a // 2, replace=False) \
        if n >= a else np.arange(a // 2)
    td = rng.integers(0, 15, size=a).astype(np.int32)
    table = RoutingTable.from_arrays(tk, td, cuda)
    kt = torch.from_numpy(keys).to(cuda)
    before = route_keys.launches
    got = route_keys(kt, table, 15, seed=3)
    torch.cuda.synchronize()
    assert route_keys.launches == before + 1
    torch.testing.assert_close(got, route_plain(kt, table, 15, seed=3),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,num_keys", [(1, 1), (5000, 33), (1_000_000,
                                                             1 << 20)])
def test_key_stats_kernel_matches_plain(cuda, n, num_keys):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-3, num_keys + 3, size=n)
                            .astype(np.int32)).to(cuda)
    costs = torch.from_numpy(rng.uniform(0.1, 3.0, size=n)).to(cuda)
    before = key_stats.launches
    freq, cost = key_stats(keys, costs, num_keys)
    torch.cuda.synchronize()
    assert key_stats.launches == before + 1
    pfreq, pcost = key_stats_plain(keys, costs, num_keys)
    torch.testing.assert_close(freq, pfreq, rtol=0, atol=0)
    torch.testing.assert_close(cost, pcost, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", [WordCount, MergeCounts])
def test_device_stage_on_cuda_matches_cpu(cuda, op):
    def stage(device):
        c = RebalanceController(Assignment(Hash32(7, seed=4)),
                                BalanceConfig(theta_max=0.02, window=3))
        return KeyedStage(op(), c, window=3, state_backend="device",
                          substrate="kernels", device=device)

    stages = [stage(cuda), stage("cpu")]
    gens = [WorkloadGen(k=3000, z=1.1, f=0.8, seed=5, window=3)
            for _ in stages]
    for i in range(4):
        for gen, st in zip(gens, stages):
            if i:
                gen.interval(st.controller.assignment)
            keys = gen.draw_tuples(5000).astype(np.int64)
            st.process_interval_arrays(keys, keys % 97)
    for rg, rc in zip(*(s.reports for s in stages)):
        assert (rg.theta, rg.table_size, rg.migrated_bytes) == \
            (rc.theta, rc.table_size, rc.migrated_bytes)
        np.testing.assert_array_equal(rg.task_loads, rc.task_loads)
    assert stages[0].outputs == stages[1].outputs
