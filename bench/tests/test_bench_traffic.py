"""The traffic: a function of the seed and the mix file alone."""

import json

import numpy as np
import pytest

from bench import harness, reference, traffic
from conftest import ROOT, SMALL, keyed_stage

MIXES = sorted(p.stem for p in (ROOT / "bench" / "traffic").glob("*.json"))


def _mix(name):
    return {**json.loads((ROOT / "bench" / "traffic" / f"{name}.json")
                         .read_text()), **SMALL["traffic"]}


def _traffic(mix, seed, keys=3000, tasks=15):
    return traffic.Traffic(mix, keys, tasks, 0, 20000, seed)


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_tuples(mix):
    a = _traffic(_mix(mix), 2**31 + 5)
    b = _traffic(_mix(mix), 2**31 + 5)
    assert len(a.cycle) == SMALL["traffic"]["cycle_intervals"]
    for i in range(12):
        x, y = a.interval(i), b.interval(i)
        assert x.dtype == np.int64 and x.size == 20000
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.checks(3), b.checks(3)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_order_the_same_counts(mix):
    a = _traffic(_mix(mix), 1)
    b = _traffic(_mix(mix), -(2**40))
    for x, y in zip(a.cycle, b.cycle):
        assert not np.array_equal(x, y)
        np.testing.assert_array_equal(np.bincount(x, minlength=3000),
                                      np.bincount(y, minlength=3000))


@pytest.mark.parametrize("mix", MIXES)
def test_the_checks_after_the_window_count_by_the_seed(mix):
    """The intervals judged after the window differ in their counts from
    seed to seed, so each seed is judged on counts of its own."""
    a = _traffic(_mix(mix), 1).checks(3)
    b = _traffic(_mix(mix), 2**33 + 1).checks(3)
    for x, y in zip(a, b):
        assert x.size == y.size == 20000
        assert not np.array_equal(np.bincount(x, minlength=3000),
                                  np.bincount(y, minlength=3000))


@pytest.mark.parametrize("n,order", [
    (1, [0]), (2, [0, 1]), (4, [0, 1, 2, 3, 2, 1]),
    (5, [0, 1, 2, 3, 4, 3, 2, 1])])
def test_the_cycle_is_handed_forth_and_back(n, order):
    """Each hand-off moves one step along the trajectory, also where the
    cycle turns: no jump from its last interval back to its first."""
    assert traffic.forth_and_back(n) == order
    t = traffic.Traffic({"z": 1.0, "fluctuation": 0.5, "cycle_intervals": n},
                        300, 5, 0, 1000, 3)
    for i in range(3 * len(order)):
        assert t.interval(i) is t.cycle[order[i % len(order)]]


def test_traffic_ignores_the_programs_routing():
    """Running and rebalancing a stage between two draws changes nothing:
    the generator reads no assignment of the program."""
    cell = harness.load_cell("wc-k1m.drift")
    cfg = {**cell.config, **SMALL["config"]}
    mix = {**cell.traffic, **SMALL["traffic"]}
    n = cfg["tuples_per_interval"]
    first = traffic.Traffic(mix, cfg["keys"], cfg["tasks"], 0, n, 9)
    stage = keyed_stage().make_stage(cfg, "cpu")
    for keys in first.cycle:
        stage.process_interval_arrays(keys)
    assert stage.controller.assignment.table
    again = traffic.Traffic(mix, cfg["keys"], cfg["tasks"], 0, n, 9)
    for x, y in zip(first.cycle + first.checks(2),
                    again.cycle + again.checks(2)):
        np.testing.assert_array_equal(x, y)


def _fluctuate_loop(freq, placement, n_tasks, f, max_swaps, rng):
    """The procedure one swap at a time, as the paper states it."""
    old = np.maximum(np.bincount(placement, weights=freq,
                                 minlength=n_tasks), 1e-12).tolist()
    cur = list(old)
    fl, dest = freq.tolist(), placement.tolist()
    swaps = 0
    for i, j in rng.integers(0, freq.size, size=(max_swaps, 2)).tolist():
        di, dj = dest[i], dest[j]
        if di == dj:
            continue
        fl[i], fl[j] = fl[j], fl[i]
        swaps += 1
        cur[di] += fl[i] - fl[j]
        cur[dj] -= fl[i] - fl[j]
        if (abs(cur[di] - old[di]) >= f * old[di]
                or abs(cur[dj] - old[dj]) >= f * old[dj]):
            break
    freq[:] = fl
    return swaps


@pytest.mark.parametrize("k,tasks,z,f,cap", [
    (50_000, 15, 0.85, 1.0, 20_000), (400, 10, 1.0, 1.5, 200_000),
    (3000, 15, 0.8, 0.5, 200_000), (5000, 7, 1.2, 0.3, 20_000)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fluctuation_equals_one_swap_at_a_time(k, tasks, z, f, cap, seed):
    placement = reference.hash_dest(np.arange(k), tasks)
    r1, r2 = traffic.rng_for(seed), traffic.rng_for(seed)
    f1 = traffic.zipf_frequencies(k, z, r1)
    f2 = traffic.zipf_frequencies(k, z, r2)
    assert (traffic.fluctuate(f1, placement, tasks, f, cap, r1)
            == _fluctuate_loop(f2, placement, tasks, f, cap, r2))
    np.testing.assert_array_equal(f1, f2)


def test_zipf_frequencies_are_the_same_sizes_permuted():
    p = traffic.zipf_frequencies(1000, 0.85, traffic.rng_for(3))
    ranks = np.arange(1, 1001, dtype=np.float64) ** -0.85
    np.testing.assert_allclose(np.sort(p), np.sort(ranks / ranks.sum()))


def test_unknown_mix_key_is_refused():
    with pytest.raises(ValueError, match="unknown traffic keys"):
        traffic.mix_params({"zz": 1})
