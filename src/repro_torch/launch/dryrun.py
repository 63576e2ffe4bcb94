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

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Reports land in ``experiments/dryrun_torch/``, which
:mod:`.roofline` reads. Not ported (see the package docstring):
``collective_bytes`` and ``compiled.memory_analysis``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import types
from typing import Optional, Union

import torch

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


def _probe(cfg: ModelConfig, groups: int) -> ModelConfig:
    # the encoder scales 1:1 with the decoder groups (whisper: 32 / 32)
    return dataclasses.replace(
        cfg, n_layers=groups * cfg.pattern_period,
        encoder_layers=groups if cfg.encoder_layers else 0)


def lower_cell(arch: str, shape: Union[str, ShapeConfig],
               mesh: str = "single", *, cfg: Optional[ModelConfig] = None,
               fsdp: bool = True,
               remat: bool = True, extra_tag: str = "") -> dict:
    """The dry-run report of one cell: ``arch``'s full config (or ``cfg``),
    ``shape`` a name of ``SHAPES`` (or a ``ShapeConfig``), ``mesh`` a name
    of :data:`MESHES`. A train cell's probes count one microbatch of the
    whole batch: a microbatch count changes neither the FLOPs the counter
    sees nor the bytes held per device (the JAX package's count feeds
    ``compiled.memory_analysis``, which is not ported)."""
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
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh,
        "devices": math.prod(MESHES[mesh][0]), "skipped": False,
        "lower_s": time.perf_counter() - t0,
        "flops": flops, "flops_per_group": c3 - c2,
        "probe_flops": {"2": c2, "3": c3},
        "model_flops": mf, "model_over_counted": mf / flops if flops else 0,
        "bytes_per_device": bytes_per_device(cfg, shape, view, fsdp),
        "params": schema_mod.count_params(sch),
        "replicated_fallbacks": rules.replication_report(sch, view, fsdp),
        "tag": extra_tag,
    }


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
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
