"""The port's sharded stream backend against the JAX package's stages, on
the CPU over spawned gloo ranks.

Each test spawns S ranks (``torch.multiprocessing``, a ``FileStore`` under
``tmp_path``, a timeout on the group and on the join) for S = 1, 2, 3 and 4
(3 is a block size that does not divide the domain). Every rank runs the
port's ``state_backend="sharded"`` stage (``tests/torch_sharded_worker.py``)
in add mode (WordCount) and max mode (WindowedSelfJoin, ``probe_cost=1/64``
so every cost is an exact dyadic) through rebalances, window > 1 eviction,
an empty interval, the domain growing with live state, a ``scale_to``, and a
checkpoint with a restore and replay. Every rank's reports, task loads,
emit streams, outputs, emitted sum, ``key_location`` and routing table must
equal the JAX package's ``state_backend="sharded"`` stage (one shard, its
own path here) and its object-store stage exactly: the shard count is
invisible. The ranks also refuse keys outside the dense domain, an
``n_shards`` other than the group's size and a device the group's backend
cannot exchange.

The JAX stages avoid window 5, hash seed 99 and fleets of 6 or 9 tasks
(other test files count the JAX device steps' traces under those).
"""

import pickle

import numpy as np
import pytest
import torch

from repro.core import Assignment as RefAssignment
from repro.core import BalanceConfig as RefConfig
from repro.core import RebalanceController as RefController
from repro.core.balancer.hashing import Hash32 as RefHash32
from repro.streams import KeyedStage as RefStage
from repro.streams import WindowedSelfJoin as RefSelfJoin
from repro.streams import WordCount as RefWordCount
from repro_torch.core import (Assignment, BalanceConfig, Hash32, ModHash,
                              RebalanceController)
from repro_torch.streams import KeyedStage, WordCount
from repro_torch.streams.backends import backend_names, resolve_backend

import torch_sharded_worker as worker

def _intervals(seed: int, k: int, n: int, with_values: bool) -> list:
    """Zipf keys whose hot set moves every two intervals, one empty
    interval, and a key past the first domain in interval 5 (the domain
    grows with live state)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(8):
        if i % 2 == 0:
            perm = rng.permutation(k)
        size = 0 if i == 3 else n
        keys = perm[(rng.zipf(1.3, size) - 1) % k].astype(np.int64)
        if i == 5:
            keys[:50] = rng.integers(k, 3 * k, 50)
        vals = (rng.integers(-1000, 1000, size).astype(np.int64)
                if with_values else None)
        out.append((keys, vals))
    return out


SCENARIOS = [
    {"name": "wordcount", "op": "wordcount", "n_tasks": 5, "window": 3,
     "theta": 0.05, "table_max": 300, "seed": 1,
     "intervals": _intervals(3, 3000, 6000, False),
     "scale_at": (5, 7), "checkpoint_after": 6},
    {"name": "selfjoin", "op": "selfjoin", "n_tasks": 4, "window": 2,
     "theta": 0.05, "table_max": 300, "seed": 2,
     "intervals": _intervals(4, 2000, 4000, True),
     "scale_at": (4, 3), "checkpoint_after": 5},
]

REF_OPERATORS = {"wordcount": RefWordCount,
                 "selfjoin": lambda: RefSelfJoin(probe_cost=1 / 64)}


def _ref_run(sc: dict, backend: str) -> dict:
    controller = RefController(
        RefAssignment(RefHash32(sc["n_tasks"], seed=sc["seed"])),
        RefConfig(theta_max=sc["theta"], table_max=sc["table_max"],
                  window=sc["window"]),
        algorithm="mixed")
    kw = {"n_shards": 1} if backend == "sharded" else {}
    stage = RefStage(REF_OPERATORS[sc["op"]](), controller,
                     window=sc["window"], vectorized=True,
                     state_backend=backend, **kw)
    max_key = max(int(k.max()) for k, _ in sc["intervals"] if k.size)
    out = {"intervals": []}
    for i, (keys, vals) in enumerate(sc["intervals"]):
        if i == sc["scale_at"][0]:
            stage.scale_to(sc["scale_at"][1])
        out["intervals"].append(worker.interval_record(stage, keys, vals))
    out["final"] = worker.final_record(stage, max_key)
    return out


_REFERENCE = {}


def _reference(backend: str) -> dict:
    """The JAX stages' records, computed once per worker process."""
    if backend not in _REFERENCE:
        _REFERENCE[backend] = {sc["name"]: _ref_run(sc, backend)
                               for sc in SCENARIOS}
    return _REFERENCE[backend]


def _spawn(world: int, tmp_path) -> list:
    plan = tmp_path / "plan.pkl"
    plan.write_bytes(pickle.dumps(SCENARIOS))
    worker.spawn_ranks(worker.run_rank, world,
                       (world, str(tmp_path / "store"), str(plan),
                        str(tmp_path)))
    return [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def _assert_runs_equal(got: dict, want: dict) -> None:
    # the run rebalanced: keys migrated and the table is not empty
    assert any(iv[0][7] > 0 for iv in want["intervals"]) and want["final"][
        "table"]
    assert len(got["intervals"]) == len(want["intervals"])
    for i, (g, w) in enumerate(zip(got["intervals"], want["intervals"])):
        assert g == w, f"interval {i}"
    assert got["final"] == want["final"]


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_sharded_ranks_match_jax_stages(world, tmp_path):
    ranks = _spawn(world, tmp_path)
    ref = {b: _reference(b) for b in ("sharded", "object")}
    for rank, res in enumerate(ranks):
        assert res["world_size"] == world
        for sc in SCENARIOS:
            got = res[sc["name"]]
            for backend, want in ref.items():
                _assert_runs_equal(got, want[sc["name"]])
            # the restore rewinds to the checkpoint and the replay repeats
            # the intervals after it exactly
            assert got["replay"] == got["intervals"][sc["checkpoint_after"]:]
            assert got["final_replayed"] == got["final"]
        refused = res["refusals"]
        assert f"n_shards={world + 1}" in refused["n_shards"]
        assert f"size {world}" in refused["n_shards"]
        assert "'gloo'" in refused["device"] and "meta" in refused["device"]
        assert "device_domain_max=4096" in refused["key_past_domain_max"]
        assert "non-negative" in refused["negative_key"]


def _controller(router):
    return RebalanceController(Assignment(router),
                               BalanceConfig(theta_max=0.05, window=2))


def test_sharded_refuses_without_a_process_group():
    with pytest.raises(ValueError, match=r"n_shards=2, group size: none"):
        KeyedStage(WordCount(), _controller(Hash32(4, seed=3)), window=2,
                   state_backend="sharded", n_shards=2, device="cpu")


def test_sharded_keeps_the_device_backends_requirements():
    with pytest.raises(ValueError, match="'sharded' requires a Hash32"):
        KeyedStage(WordCount(), _controller(ModHash(4)), window=2,
                   state_backend="sharded", device="cpu")
    assert "sharded" in backend_names()
    cls = resolve_backend("sharded", WordCount(),
                          _controller(Hash32(4, seed=3)), True,
                          torch.device("cpu"))
    assert cls.name == "sharded"
    assert not cls.auto_eligible(WordCount(), _controller(Hash32(4, seed=3)),
                                 True, torch.device("cuda"))
