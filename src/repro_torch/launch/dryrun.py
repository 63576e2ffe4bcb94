"""The dry run of one (arch x shape x mesh) cell — what the JAX package's
``launch/dryrun.py`` reports, without XLA.

XLA lowering has no torch counterpart. :func:`lower_cell` builds the
cell's step (the train step, or the serve step of a prefill or decode cell)
from :mod:`.specs`' tensors on the ``meta`` device, which allocates nothing
and computes nothing, and counts its FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` (matrix products, batched
products and attention; elementwise work is not counted). Like the JAX
package it runs two probes, at 2 and 3 superblocks (and as many encoder
layers), and extrapolates linearly to the full depth: total(n) = c2 +
(n - 2) x (c3 - c2). The port's layers are a Python loop, which the
counter sees whole, so the extrapolation is exact; it keeps the probes
small where a full-depth trace would walk every layer.

The bytes per device are arithmetic on the specs: each parameter,
optimizer-state (train), cache (serve) and batch leaf's local shard under
the named mesh's shardings (``sharding.rules``), which needs no process
group and no device. ``replicated_fallbacks`` lists the logical axes whose
size the mesh does not divide (``rules.replication_report``).

**Collectives and peak memory** (the JAX package's ``collective_bytes`` and
``compiled.memory_analysis``): :func:`trace_mesh` runs the same step again,
as DTensors on ``meta`` tensors laid out on the named production mesh,
(16, 16) or (2, 16, 16), built on a ``"fake"`` process group of 256 or 512
ranks in a subprocess of its own (so no process group is left in the
caller; the subprocess is rank 0, and every rank's shards have the same
shapes). A dispatch mode (:class:`_Trace`) sees every op on the local
shards, DTensor's own redistributions included:

* ``collective_bytes``: each collective's result bytes summed per op
  family under the JAX names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``), per device;
* ``memory``: per device, ``argument_bytes`` (the local shards of the
  step's inputs: parameters, optimizer state or cache, batch,
  placements), ``output_bytes`` (the local shards of what the step
  returns; the parameters, state and cache it updates in place count
  here too, as aliased outputs do in XLA's figure), ``peak_bytes`` (the
  most local storage alive at once, the arguments included),
  ``temp_bytes`` (``peak_bytes - argument_bytes``) and ``peak_by_phase``
  (the peak within the forward and backward, ``step``, and within the
  optimizer's update, ``update``).

Both are extrapolated from the 2- and 3-superblock probes as the FLOPs
are, each phase's peak on its own (the peak may pass from one phase to
the other as depth grows): the collectives, the argument and output bytes
and the ``step`` phase's peak (saved activations and gradients, a
superblock's more at each depth) exactly. The ``update`` phase's peak
holds its largest leaf's transient, which may pass from one leaf to
another (a stacked superblock leaf outgrowing the embedding), so it is
exact only where the largest leaf is the same at the probes and at full
depth. A train cell traces its step at the JAX dry run's microbatch count
(:data:`TRAIN_MICROBATCHES`), so its gradient sync is counted as often as
the step makes it. The ``REPRO_PERF_*`` flags (:mod:`repro_torch.flags`)
in the environment reach the subprocess, so a report shows their layout.
Where the trace fails, the report holds ``"error"`` and no figures.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Reports land in ``experiments/dryrun_torch/``, which
:mod:`.roofline` reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
import types
import weakref
from pathlib import Path
from typing import Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import flags
from ..configs import ARCHS, get_config
from ..models import cache_schema, model_schema
from ..models import schema as schema_mod
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..sharding import rules
from . import specs as specs_mod
from .roofline import RESULTS_DIR, model_flops

#: the named meshes: the production mesh of one pod and of two
#: (``launch.mesh.make_production_mesh``)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


#: microbatches of a train cell's step, as the JAX dry run counts them
TRAIN_MICROBATCHES = {"train_4k": 8}

#: collective ops by name (the ``_c10d_functional`` ops and DTensor's
#: all-to-all), to the JAX package's op-family names
COLLECTIVE_FAMILIES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
#: ops of the collective namespaces that move no data between ranks
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "recv_any_source_",
                    "barrier", "monitored_barrier_")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd", "c10d", "_dtensor")


def named_mesh(name: str):
    """The named mesh's axis names and sizes, which is all the sharding
    rules read (``models.schema.mesh_axes``)."""
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)))


def _local_bytes(schema, pspecs, mesh, dtype=None) -> int:
    """Bytes of one device's shards of the leaves of ``schema`` laid out by
    ``pspecs`` (in ``dtype``, or each leaf's own)."""
    total = 0
    for s, spec in zip(schema_mod.tree_leaves(schema),
                       schema_mod.tree_leaves(pspecs)):
        n = 1
        for size, entry in zip(s.shape, spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            n *= size // math.prod(int(mesh.shape[a]) for a in axes)
        total += n * (dtype or s.dtype).itemsize
    return total


def bytes_per_device(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     fsdp: bool = True) -> dict:
    """Per-device bytes of the parameters, the optimizer state (train
    cells: float32 moments and master, and the step), the cache (serve
    cells) and the batch, under the mesh's shardings."""
    sch = model_schema(cfg)
    pspecs = rules.param_pspecs(sch, mesh, fsdp)
    out = {"params": _local_bytes(sch, pspecs, mesh)}
    if shape.kind == "train":
        out["opt_state"] = 3 * _local_bytes(sch, pspecs, mesh,
                                            torch.float32) + 4
    else:
        csch = cache_schema(cfg, shape.global_batch,
                            specs_mod.cache_max_seq(cfg, shape))
        out["cache"] = _local_bytes(
            csch, rules.cache_pspecs(csch, mesh, shape.global_batch), mesh)
    bspec = rules.batch_pspec(mesh, shape.global_batch)[0]
    split = math.prod(int(mesh.shape[a]) for a in
                      ((bspec,) if isinstance(bspec, str) else bspec or ()))
    out["batch"] = sum(t.nbytes // split for t in
                       specs_mod.batch_specs(cfg, shape).values())
    out["total"] = sum(out.values())
    return out


def step_flops(cfg: ModelConfig, shape: ShapeConfig,
               remat: bool = True) -> float:
    """FLOPs of one step of the cell on the ``meta`` device, one
    microbatch, the loss in one chunk (as the JAX package's probes)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..train.optimizer import OptConfig, opt_init
    from ..train.train_step import make_serve_step, make_train_step
    meta = lambda t: t.meta()
    params = schema_mod.tree_map(meta, specs_mod.param_specs(cfg)[0])
    batch = {k: v.meta() for k, v in
             specs_mod.batch_specs(cfg, shape).items()}
    placements = None
    if cfg.moe_experts:
        placements = torch.empty((cfg.n_layers, cfg.moe_experts),
                                 dtype=torch.int32, device="meta")
    counter = FlopCounterMode(display=False)
    if shape.kind == "train":
        step = make_train_step(cfg, OptConfig(), microbatches=1,
                               remat=remat, loss_chunks=1)
        state = opt_init(params)
        with counter:
            step(params, state, batch, placements)
    else:
        cache = schema_mod.tree_map(
            meta, specs_mod.decode_cache_specs(cfg, shape)[0])
        index = shape.seq_len - 1 if shape.kind == "decode" else 0
        with counter:
            make_serve_step(cfg)(params, cache, batch, index, placements)
    return float(counter.get_total_flops())


class _Trace(TorchDispatchMode):
    """Collective bytes and live local storage over a traced step.

    An op on DTensors is handed back (``NotImplemented``) for DTensor to
    desugar into ops on the local shards, which come through here again,
    its redistributions' collectives included (``CommDebugMode``'s
    device). Every plain tensor an op returns has its storage counted live
    until the storage is freed (a weakref finalizer)."""

    def __init__(self):
        super().__init__()
        self.collectives: dict = {}
        self.live: dict = {}
        self.current = 0
        self.peaks: dict = {}

    def track(self, t: torch.Tensor) -> None:
        if type(t) is not torch.Tensor:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.current += st.nbytes()
        phase = _phase()
        self.peaks[phase] = max(self.peaks.get(phase, 0), self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        packet = getattr(func, "_overloadpacket", None)
        if (packet is not None and func.namespace in _COLLECTIVE_NAMESPACES
                and packet.__name__ not in _NOT_COLLECTIVES):
            name = COLLECTIVE_FAMILIES.get(packet.__name__,
                                           packet.__name__)
            self.collectives[name] = self.collectives.get(name, 0) + sum(
                t.numel() * t.element_size() for t in outs)
        for t in outs:
            self.track(t)
        return out


def _phase() -> str:
    """The step's phase on the calling stack: "update" inside the
    optimizer's ``opt_update``, else "step" (the forward and backward)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "opt_update":
            return "update"
        f = f.f_back
    return "step"


def _local_storages(tree) -> int:
    """Bytes of the distinct local storages of a tree's tensors (DTensors
    by their local shards)."""
    seen, total = set(), 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t.to_local() if hasattr(t, "to_local") else t
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def _meta_dtensors(schema, shardings):
    """A ``meta`` DTensor per leaf of ``schema`` laid out by ``shardings``
    (nothing allocated, nothing communicated)."""
    from torch.distributed.tensor import distribute_tensor
    return schema_mod.tree_unflatten(schema, [
        distribute_tensor(torch.empty(s.shape, dtype=s.dtype, device="meta"),
                          sh.mesh, list(sh.placements), src_data_rank=None)
        for s, sh in zip(schema_mod.tree_leaves(schema),
                         schema_mod.tree_leaves(shardings))])


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               fsdp: bool = True, remat: bool = True,
               microbatches: int = 1) -> dict:
    """The cell's step on ``mesh`` (a ``DeviceMesh``) as DTensors on
    ``meta`` tensors: its collective bytes per family and its memory per
    device (see the module docstring)."""
    from ..sharding import ctx
    from ..train.optimizer import OptConfig, opt_init
    from ..train.train_step import make_serve_step, make_train_step
    sch = model_schema(cfg)
    params = _meta_dtensors(sch, rules.param_shardings(sch, mesh, fsdp))
    bshard = specs_mod.batch_shardings(cfg, shape, mesh)
    bsch = {k: schema_mod.ParamSpec(v.shape, (None,) * len(v.shape),
                                    dtype=v.dtype)
            for k, v in specs_mod.batch_specs(cfg, shape).items()}
    batch = _meta_dtensors(bsch, bshard)
    placements = None
    if cfg.moe_experts:
        placements = torch.empty((cfg.n_layers, cfg.moe_experts),
                                 dtype=torch.int32, device="meta")
    if shape.kind == "train":
        state = opt_init(params)
        args = (params, state, batch, placements)
        step = make_train_step(cfg, OptConfig(), microbatches=microbatches,
                               remat=remat)
    else:
        csch = cache_schema(cfg, shape.global_batch,
                            specs_mod.cache_max_seq(cfg, shape))
        cache = _meta_dtensors(csch, rules.cache_shardings(
            csch, mesh, shape.global_batch))
        index = shape.seq_len - 1 if shape.kind == "decode" else 0
        args = (params, cache, batch, index, placements)
        step = make_serve_step(cfg)
    trace = _Trace()
    for t in torch.utils._pytree.tree_leaves(args):
        if isinstance(t, torch.Tensor):
            trace.track(t.to_local() if hasattr(t, "to_local") else t)
    argument = trace.current
    trace.peaks.clear()
    with ctx.use_mesh(mesh), trace:
        out = step(*args)
    return {"collective_bytes": dict(trace.collectives),
            "memory": {"argument_bytes": argument,
                       "output_bytes": _local_storages(out),
                       "peak_by_phase": dict(trace.peaks)}}


def _memory(m: dict) -> dict:
    """The report's memory from :func:`trace_step`'s (its phases' peaks
    extrapolated one by one): ``peak_bytes`` the largest phase peak,
    ``temp_bytes`` what it holds beyond the arguments."""
    peak = max(m["peak_by_phase"].values())
    return {"argument_bytes": m["argument_bytes"],
            "output_bytes": m["output_bytes"], "temp_bytes":
            peak - m["argument_bytes"], "peak_bytes": peak,
            "peak_by_phase": m["peak_by_phase"]}


def _extrapolate(c2, c3, n_groups: int):
    """total(n) = c2 + (n - 2) x (c3 - c2), per key of nested dicts."""
    if isinstance(c2, dict) or isinstance(c3, dict):
        return {k: _extrapolate(c2.get(k, 0), c3.get(k, 0), n_groups)
                for k in sorted(set(c2) | set(c3))}
    return c2 + (n_groups - 2) * (c3 - c2)


def _trace_probes(job: dict) -> dict:
    """The subprocess's work: the fake process group, the mesh, and
    :func:`trace_step` at each probe depth."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .mesh import make_mesh
    shape, axes = (MESHES[job["mesh"]] if isinstance(job["mesh"], str)
                   else job["mesh"])
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = make_mesh(shape, axes, device_type="cpu")
        return {g: trace_step(_probe(job["cfg"], g), job["shape"], mesh,
                              job["fsdp"], job["remat"],
                              job["microbatches"])
                for g in job["groups"]}
    finally:
        dist.destroy_process_group()


def trace_mesh(cfg: ModelConfig, shape: ShapeConfig, mesh="single",
               fsdp: bool = True, remat: bool = True,
               microbatches: int = 1, groups=(2, 3),
               timeout: float = 1800) -> dict:
    """:func:`trace_step` at each superblock count of ``groups`` on the
    named mesh (or a (shape, axis names) pair), in a subprocess; {groups:
    report}. Raises ``RuntimeError`` with the subprocess's error when it
    fails."""
    job = dict(cfg=cfg, shape=shape, mesh=mesh, fsdp=fsdp, remat=remat,
               microbatches=microbatches, groups=tuple(groups))
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    with tempfile.TemporaryDirectory() as tmp:
        job_path, out_path = Path(tmp, "job.pkl"), Path(tmp, "out.pkl")
        job_path.write_bytes(pickle.dumps(job))
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--trace-job", str(job_path), str(out_path)],
            env=env, capture_output=True, text=True, timeout=timeout)
        if run.returncode != 0 or not out_path.exists():
            raise RuntimeError(f"mesh trace failed (exit {run.returncode}):"
                               f" {run.stderr[-3000:]}")
        return pickle.loads(out_path.read_bytes())


def _probe(cfg: ModelConfig, groups: int) -> ModelConfig:
    # the encoder scales 1:1 with the decoder groups (whisper: 32 / 32)
    return dataclasses.replace(
        cfg, n_layers=groups * cfg.pattern_period,
        encoder_layers=groups if cfg.encoder_layers else 0)


def lower_cell(arch: str, shape: Union[str, ShapeConfig],
               mesh: str = "single", *, cfg: Optional[ModelConfig] = None,
               fsdp: bool = True, remat: bool = True,
               microbatches: Optional[int] = None,
               extra_tag: str = "") -> dict:
    """The dry-run report of one cell: ``arch``'s full config (or ``cfg``),
    ``shape`` a name of ``SHAPES`` (or a ``ShapeConfig``), ``mesh`` a name
    of :data:`MESHES`. A train cell's FLOP probes count one microbatch of
    the whole batch (a microbatch count changes neither the FLOPs nor the
    bytes held per device); its mesh trace runs ``microbatches`` (default
    :data:`TRAIN_MICROBATCHES`), as the JAX dry run compiles them."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ok, why = specs_mod.cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mesh,
                "skipped": True, "reason": why}
    view = named_mesh(mesh)
    t0 = time.perf_counter()
    n_groups = cfg.n_layers // cfg.pattern_period
    c2, c3 = (step_flops(_probe(cfg, g), shape, remat) for g in (2, 3))
    flops = c2 + (n_groups - 2) * (c3 - c2)
    mf = model_flops(cfg, shape)
    sch = model_schema(cfg)
    mb = (microbatches or TRAIN_MICROBATCHES.get(shape.name, 1)
          if shape.kind == "train" else 1)
    report = {
        "arch": arch, "shape": shape.name, "mesh": mesh,
        "devices": math.prod(MESHES[mesh][0]), "skipped": False,
        "flops": flops, "flops_per_group": c3 - c2,
        "probe_flops": {"2": c2, "3": c3},
        "model_flops": mf, "model_over_counted": mf / flops if flops else 0,
        "bytes_per_device": bytes_per_device(cfg, shape, view, fsdp),
        "params": schema_mod.count_params(sch),
        "replicated_fallbacks": rules.replication_report(sch, view, fsdp),
        "microbatches": mb if shape.kind == "train" else None,
        "perf_flags": sorted(n for n in flags.NAMES if flags.enabled(n)),
        "tag": extra_tag,
    }
    try:
        probes = trace_mesh(cfg, shape, mesh, fsdp, remat, mb)
    except Exception as e:  # noqa: BLE001 - the report says so
        report["error"] = f"{type(e).__name__}: {e}"
    else:
        full = _extrapolate(probes[2], probes[3], n_groups)
        report["collective_bytes"] = full["collective_bytes"]
        report["memory"] = _memory(full["memory"])
        report["probe_collectives"] = {str(g): probes[g]["collective_bytes"]
                                       for g in probes}
        report["probe_memory"] = {str(g): _memory(probes[g]["memory"])
                                  for g in probes}
    report["lower_s"] = time.perf_counter() - t0
    return report


def cell_list():
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            ok, _ = specs_mod.cell_applicable(cfg, SHAPES[shape_name])
            if ok:
                cells.append((arch, shape_name))
    return cells


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--trace-job"]:
        # the subprocess of trace_mesh: a job in, its result out
        job = pickle.loads(Path(argv[1]).read_bytes())
        Path(argv[2]).write_bytes(pickle.dumps(_trace_probes(job)))
        return
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = cell_list()
    elif args.arch and args.shape:
        cells = [(args.arch.replace("-", "_"), args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    for arch, shape_name in cells:
        for mesh in meshes:
            tag = f"{args.tag}_" if args.tag else ""
            out = RESULTS_DIR / f"{tag}{arch}__{shape_name}__{mesh}.json"
            if out.exists() and not args.force:
                print(f"[skip-cached] {out.name}")
                continue
            print(f"[dryrun] {arch} x {shape_name} x {mesh} ...", flush=True)
            try:
                rep = lower_cell(arch, shape_name, mesh,
                                 fsdp=not args.no_fsdp,
                                 remat=not args.no_remat,
                                 microbatches=args.microbatches,
                                 extra_tag=args.tag)
            except Exception as e:  # noqa: BLE001 - report and continue
                rep = {"arch": arch, "shape": shape_name, "mesh": mesh,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            out.write_text(json.dumps(rep, indent=1))
            print("  -> " + (rep["error"][:120] if "error" in rep else
                             "skipped: " + rep["reason"] if rep.get("skipped")
                             else f"flops={rep['flops']:.3e} bytes/dev="
                             f"{rep['bytes_per_device']['total']:.3e}"),
                  flush=True)


if __name__ == "__main__":
    main()
