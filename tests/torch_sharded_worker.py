"""One rank of the spawned gloo groups of ``tests/test_torch_sharded.py``
and ``tests/test_torch_sharding.py``.

Imports neither JAX nor the JAX package: every rank runs the port's
``state_backend="sharded"`` stages on the plan that the test wrote (the
interval inputs, rebalances come from the controller, a ``scale_to``, a
checkpoint and a restore-and-replay), records what each stage shows, and
writes it to ``rank<r>.pkl``; the test holds every rank's record against
the JAX package's stages. :func:`run_mesh_rank` lays a smoke model's
parameters out on a device mesh.
"""

from __future__ import annotations

import datetime
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import (Assignment, BalanceConfig, Hash32,
                              RebalanceController)
from repro_torch.streams import (KeyedStage, WindowedSelfJoin, WordCount,
                                 checkpoint_stage, restore_stage)

REPORT_FIELDS = ("interval", "tuples", "makespan", "migration_stall",
                 "throughput", "skewness", "theta", "migrated_bytes",
                 "table_size", "buffered")

OPERATORS = {"wordcount": WordCount,
             "selfjoin": lambda: WindowedSelfJoin(probe_cost=1 / 64)}


def spawn_ranks(fn, world: int, args: tuple, timeout_s: int = 120) -> None:
    """``fn(rank, *args)`` in ``world`` spawned processes; raises if one
    fails, and kills them all if they are not done in ``timeout_s``."""
    ctx = mp.start_processes(fn, args=args, nprocs=world, join=False,
                             start_method="spawn")
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=timeout_s)
    try:
        while not ctx.join(timeout=1):
            if datetime.datetime.now() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def make_stage(sc: dict, **kw) -> KeyedStage:
    controller = RebalanceController(
        Assignment(Hash32(sc["n_tasks"], seed=sc["seed"])),
        BalanceConfig(theta_max=sc["theta"], table_max=sc["table_max"],
                      window=sc["window"]),
        algorithm="mixed")
    kw = {"state_backend": "sharded", "substrate": "kernels",
          "device": "cpu", **kw}
    return KeyedStage(OPERATORS[sc["op"]](), controller,
                      window=sc["window"], **kw)


def interval_record(stage, keys, vals) -> tuple:
    report, ekeys, evals = stage.process_interval_emits(keys, vals)
    return (tuple(getattr(report, f) for f in REPORT_FIELDS),
            np.asarray(report.task_loads).tolist(),
            np.asarray(ekeys).tolist(), np.asarray(evals).tolist())


def final_record(stage, max_key: int) -> dict:
    return {"outputs": dict(stage.outputs),
            "emitted_sum": stage.emitted_sum,
            "table": dict(stage.controller.assignment.table),
            "state_keys": stage.total_state_keys(),
            "key_location": [stage.key_location(k)
                             for k in range(max_key + 1)]}


def run_scenario(sc: dict) -> dict:
    """Every interval, a ``scale_to`` after ``scale_at[0]`` intervals, a
    checkpoint after ``checkpoint_after``; then the restore and the replay
    of the intervals after the checkpoint."""
    stage = make_stage(sc)
    max_key = max(int(k.max()) for k, _ in sc["intervals"] if k.size)
    out = {"intervals": [], "replay": []}
    ckpt = None
    for i, (keys, vals) in enumerate(sc["intervals"]):
        if i == sc["scale_at"][0]:
            stage.scale_to(sc["scale_at"][1])
        out["intervals"].append(interval_record(stage, keys, vals))
        if i + 1 == sc["checkpoint_after"]:
            ckpt = checkpoint_stage(stage)
    out["final"] = final_record(stage, max_key)
    restore_stage(stage, ckpt)
    for keys, vals in sc["intervals"][sc["checkpoint_after"]:]:
        out["replay"].append(interval_record(stage, keys, vals))
    out["final_replayed"] = final_record(stage, max_key)
    return out


def refusals(sc: dict, world: int) -> dict:
    """The messages of the stages this rank must refuse."""
    got = {}
    cases = {"n_shards": lambda: make_stage(sc, n_shards=world + 1),
             "device": lambda: make_stage(sc, device="meta")}
    for name, build in cases.items():
        try:
            build()
        except ValueError as e:
            got[name] = str(e)
    for name, keys in (("key_past_domain_max", [3, 5000]),
                       ("negative_key", [3, -2])):
        stage = make_stage(sc, device_domain_max=4096)
        try:
            stage.process_interval_arrays(np.array(keys, np.int64))
        except ValueError as e:
            got[name] = str(e)
    return got


def run_rank(rank: int, world: int, store: str, plan: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        scenarios = pickle.loads(Path(plan).read_bytes())
        res = {sc["name"]: run_scenario(sc) for sc in scenarios}
        res["refusals"] = refusals(scenarios[0], world)
        res["world_size"] = dist.get_world_size()
        Path(out, f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()


def _placements(placements) -> list:
    return [("S", p.dim) if p.is_shard() else ("R",) for p in placements]


def run_mesh_rank(rank: int, world: int, store: str, arch: str,
                  out: str) -> None:
    """One of 4 ranks: ``arch``'s smoke params laid out by
    ``param_shardings`` on a (2, 2) ("data", "model") mesh, the optimizer
    state's layout, ``constrain`` under the mesh, and a batch split over a
    ("pod", "data") mesh; writes what this rank holds."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import data_axes, make_mesh, model_axes
    from repro_torch.models import schema
    from repro_torch.models.transformer import model_schema
    from repro_torch.sharding import ctx
    from repro_torch.sharding.rules import batch_sharding, param_shardings
    from repro_torch.train import opt_shardings

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        cfg = smoke_config(arch)
        sch = model_schema(cfg)
        params = schema.init(sch, torch.Generator().manual_seed(5), "cpu")
        shard = param_shardings(sch, mesh)
        leaves = []
        for (path, p), s in zip(schema.tree_paths(params),
                                schema.tree_leaves(shard)):
            d = s.distribute(p)
            leaves.append({"path": path, "shape": tuple(p.shape),
                           "spec": s.spec,
                           "local": tuple(d.to_local().shape),
                           "round_trip": torch.equal(d.full_tensor(), p)})
        opt = opt_shardings(shard, mesh)
        x = DTensor.from_local(torch.arange(8.0).reshape(4, 2), mesh,
                               [Replicate(), Replicate()])
        with ctx.use_mesh(mesh):
            y = ctx.constrain(x, "dp", "sp")
        pod = make_mesh((2, 2), ("pod", "data"), device_type="cpu")
        batch = torch.arange(24.0).reshape(8, 3)
        local_batch = batch_sharding(pod, 8).distribute(batch).to_local()
        res = {"leaves": leaves,
               "opt_mirrors": all(opt[k] is shard
                                  for k in ("m", "v", "master")),
               "opt_step": (opt["step"].spec,
                            _placements(opt["step"].placements)),
               "constrain": (_placements(y.placements),
                             y.to_local().tolist()),
               "axes": (data_axes(pod), model_axes(mesh)),
               "batch_local": local_batch.tolist()}
        Path(out, f"mesh{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()
