"""The Mixed planner's psi order on the card against numpy's stable
argsort, and a plan over 10^6 keys made through a stage on the card
against the same plan made on the host.

These tests carry the ``cuda`` marker and skip where torch finds no CUDA
device. On a machine with a card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_card_order.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import (Assignment, BalanceConfig, Hash32, KeyStats,
                              RebalanceController)
from repro_torch.core.balancer import llfd, mixed
from repro_torch.core.balancer.llfd import psi_ranks
from repro_torch.streams import KeyedStage, WordCount

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the order under test runs there")
    return torch.device("cuda")


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
        psi[rng.choice(n, n // 2, replace=False)] = rng.integers(
            1, 50, n // 2) ** 1.5 / 24.0
        return psi
    return rng.random(n) ** 3


@pytest.mark.parametrize("kind", ["ties", "zeros", "distinct"])
@pytest.mark.parametrize("n", [llfd.CARD_ORDER_MIN_KEYS - 1,
                               llfd.CARD_ORDER_MIN_KEYS, 1_000_003])
def test_card_order_equals_the_stable_argsort(cuda, kind, n):
    psi = _psi(n, n, kind)
    got, record = _counted(lambda: psi_ranks(psi, cuda))
    _assert_stable_order(got, psi)
    assert record.counts.get("plan_card_orders", 0) == \
        (n >= llfd.CARD_ORDER_MIN_KEYS)


def test_card_order_ties_negative_and_positive_zero(cuda):
    psi = np.zeros(llfd.CARD_ORDER_MIN_KEYS)
    psi[::3] = -0.0
    psi[::7] = 1.0
    _assert_stable_order(psi_ranks(psi, cuda), psi)


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_non_finite_psi_takes_the_host_sort(cuda, bad):
    psi = _psi(2 * llfd.CARD_ORDER_MIN_KEYS, 3, "ties")
    psi[[1, 9000]] = bad
    got, record = _counted(lambda: psi_ranks(psi, cuda))
    _assert_stable_order(got, psi)
    assert "plan_card_orders" not in record.counts


def _drift_stats(rng, k=10**6, tuples=10**6, window=5):
    """A window of Zipf(0.85) intervals over ``k`` keys whose hot set moves
    each interval: ~0.8 k keys hold state, ~0.35 k were seen last."""
    p = 1.0 / np.arange(1, k + 1) ** 0.85
    p /= p.sum()
    counts = [np.bincount(rng.permutation(k)[rng.choice(k, tuples, p=p)],
                          minlength=k).astype(np.float64)
              for _ in range(window)]
    held = sum(counts)
    keys = np.flatnonzero(held > 0)
    return KeyStats(keys=keys, cost=counts[-1][keys],
                    mem=8.0 * held[keys] + 16.0)


def test_a_1e6_key_plan_through_a_cuda_stage_equals_the_host_plan(cuda):
    rng = np.random.default_rng(36)
    cfg = BalanceConfig(theta_max=0.02, table_max=3000, window=5)
    first = mixed(_drift_stats(rng), Assignment(Hash32(15, seed=3)), cfg)
    stats = _drift_stats(rng)
    assert stats.num_keys >= llfd.CARD_ORDER_MIN_KEYS
    controller = RebalanceController(first.assignment.copy(), cfg)
    stage = KeyedStage(WordCount(), controller, window=5,
                       state_backend="device", substrate="kernels",
                       device=cuda)
    assert controller.plan_device == cuda
    controller.executor = None           # the plan is under test, not the move
    ev, record = _counted(lambda: controller.on_interval(stats, force=True))
    want = mixed(stats, first.assignment, cfg)
    assert record.counts == {"plan_card_orders": 1}
    assert ev.result.same_plan(want)
    assert ev.result.migration_cost == want.migration_cost
    assert stage.controller is controller and first.table_size
