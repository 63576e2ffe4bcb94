"""One rank of the spawned gloo mesh of ``tests/test_torch_mesh.py``.

Imports neither JAX nor the JAX package. Each rank joins a 4-rank (2, 2)
("data", "model") ``DeviceMesh`` and runs, for every case the test names,
the port's unsharded step and the same step on DTensors under the mesh
(``sharding.ctx.use_mesh``), from the same float32 weights and inputs:

* serve: the cache-free step, then a prefill through the cache and decode
  steps; the logits and the caches (full tensors), and every MoE layer's
  routing (each (token, slot) entry's row in the dispatch buffer and the
  loads);
* train: the loss and every gradient of ``lm_loss``, then one train step
  of 2 microbatches: its loss, the updated float32 masters, and the
  placements of every parameter and optimizer-state leaf before and after.

With the ``REPRO_PERF_*`` flags (``tests/test_torch_perf_flags.py``),
each rank sets them in its own environment for the case:

* flags_serve: the serve steps with the serve launcher's flags (and
  ``ATTN_SHARD``) against the unsharded port with the same flags and the
  mesh's dispatch-group count (``moe.fixed_groups``); the token count of
  every routing, and, for one decode step with and without
  ``DECODE_WS``, the size of every all-gather over "data";
* flags_train: the train step with ``MOE_GROUPED``, ``ATTN_SHARD`` and
  ``DEFER_GRAD_SYNC`` (then also ``BF16_ACCUM``) against the unsharded
  port the same way, and ``CommDebugMode``'s collective counts of the step
  at 1 and 2 microbatches with and without ``DEFER_GRAD_SYNC``.

Every rank writes what it saw to ``mesh_rank<r>.pkl``; the test asserts
each case's row.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SERVE = {"batch": 2, "prompt": 8, "decode": 3}
TRAIN = {"batch": 4, "seq": 8, "microbatches": 2, "lr": 1e-3}


def _placements(t) -> list:
    return [str(p) for p in t.placements]


def _routing_recorder(moe_mod, log: list):
    orig = moe_mod._route

    def route(*args, **kw):
        r = orig(*args, **kw)
        log.append((r["src"].clone(), r["count"].clone()))
        return r
    return orig, route


def _f32(tree):
    from repro_torch.models.schema import tree_map
    return tree_map(lambda a: a.to(torch.float32), tree)


def np_params(sch, seed: int, wide=torch.float32) -> dict:
    """Weights from numpy, by the parity tests' rule
    (``tests/torch_model_ref.py``): normal x 1/sqrt(the input dim), or the
    spec's scale; ones and zeros where the spec says. float32, and
    ``wide`` where the schema says bfloat16."""
    from repro_torch.models.schema import tree_map
    rng = np.random.default_rng(seed)

    def make(spec):
        if spec.init in ("zeros", "ones"):
            a = np.full(spec.shape, spec.init == "ones", np.float32)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) > 1 else spec.shape[0]
            scale = spec.scale if spec.scale is not None else fan_in ** -0.5
            a = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
        a = torch.from_numpy(a)
        return a.to(wide) if spec.dtype == torch.bfloat16 else a
    return tree_map(make, sch)


def _inputs(cfg, batch: int, seq: int, seed: int) -> dict:
    from repro_torch.launch.serve import frontend_inputs
    g = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=g)}
    front = frontend_inputs(cfg, batch, "cpu", g)
    return {**out, **{k: v.to(torch.float32) for k, v in front.items()}}


def _serve_run(cfg, params, cache, batch, placements, decode_tokens):
    """The cache-free step's logits, then prefill and decode logits and the
    cache after them; the caller installs the mesh or not."""
    from repro_torch.train.train_step import make_serve_step
    from repro_torch.sharding.local import is_dtensor
    full = lambda t: t.full_tensor() if is_dtensor(t) else t
    step = make_serve_step(cfg)
    free, _ = step(params, None, batch, 0, placements)
    logits, cache = step(params, cache, batch, 0, placements)
    outs = [full(logits)]
    idx = batch["tokens"].shape[1] + (cfg.prefix_len if "pixel_embeds"
                                      in batch else 0)
    step_batch = {k: v for k, v in batch.items()
                  if k not in ("tokens", "pixel_embeds")}
    for tok in decode_tokens:
        logits, cache = step(params, cache, {"tokens": tok, **step_batch},
                             idx, placements)
        outs.append(full(logits))
        idx += 1
    from repro_torch.models.schema import tree_map
    return (full(free), torch.cat(outs, 1), tree_map(full, cache))


def serve_case(arch: str, mesh, seed: int) -> dict:
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_cache, model_schema, schema
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.schema import tree_leaves, tree_map
    from repro_torch.models.skewshield import placements_array
    from repro_torch.launch.serve import moe_placers
    from repro_torch.models.transformer import cache_schema
    from repro_torch.sharding import ctx, rules
    from repro_torch.models.transformer import encode
    from repro_torch.train.train_step import make_serve_step

    cfg = smoke_config(arch)
    sch = model_schema(cfg)
    params = np_params(sch, seed)
    b, t = SERVE["batch"], SERVE["prompt"]
    batch = _inputs(cfg, b, t, seed + 1)
    frames = None
    if "frames" in batch:
        frames = batch
        with torch.inference_mode():
            batch = {"tokens": batch["tokens"],
                     "encoder_out": encode(params, cfg, batch["frames"])}
    g = torch.Generator().manual_seed(seed + 2)
    decode = [torch.randint(0, cfg.vocab, (b, 1), generator=g)
              for _ in range(SERVE["decode"])]
    placements = None
    if cfg.moe_experts:
        placers = moe_placers(cfg)
        perm = torch.randperm(cfg.moe_experts, generator=g)
        placements = placements_array(placers, "cpu")[:, perm]
    prefix = cfg.prefix_len if "pixel_embeds" in batch else 0
    max_seq = prefix + t + SERVE["decode"]

    log: list = []
    orig, route = _routing_recorder(moe_mod, log)
    moe_mod._route = route
    try:
        want = _serve_run(cfg, params, _f32(init_cache(cfg, b, max_seq,
                                                       "cpu")),
                          batch, placements, decode)
        n_plain = len(log)
        csch = cache_schema(cfg, b, max_seq)
        pshard = rules.param_shardings(sch, mesh, fsdp=True)
        cshard = rules.cache_shardings(csch, mesh, b)
        dparams = schema.distribute(params, pshard)
        dcache = schema.distribute(_f32(init_cache(cfg, b, max_seq, "cpu")),
                             cshard)
        with ctx.use_mesh(mesh):
            got = _serve_run(cfg, dparams, dcache, batch, placements, decode)
        encoded = None
        if frames is not None:
            # the encoder itself on DTensors: the step from the frames
            step = make_serve_step(cfg)
            want_f = step(params, None, frames, 0, placements)[0]
            with ctx.use_mesh(mesh):
                got_f = step(dparams, None, frames, 0,
                             placements)[0].full_tensor()
            encoded = (want_f.numpy(), got_f.numpy())
    finally:
        moe_mod._route = orig
    plain_routes, mesh_routes = log[:n_plain], log[n_plain:]
    return {
        "free": (want[0].numpy(), got[0].numpy()),
        "logits": (want[1].numpy(), got[1].numpy()),
        "cache": [(w.numpy(), g_.numpy()) for w, g_ in
                  zip(tree_leaves(want[2]), tree_leaves(got[2]))],
        "from_frames": encoded,
        "routes": len(plain_routes),
        "routing_equal": len(plain_routes) == len(mesh_routes) and all(
            torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
            for a, c in zip(plain_routes, mesh_routes)),
        "param_placements": [
            (_placements(d), list(s.placements))
            for d, s in zip(tree_leaves(dparams), tree_leaves(pshard))],
    }


def train_case(arch: str, mesh, seed: int) -> dict:
    from repro_torch.configs import smoke_config
    from repro_torch.models import model_schema, schema
    from repro_torch.sharding.local import layout_batch
    from repro_torch.models.schema import tree_leaves
    from repro_torch.sharding import ctx, rules
    from repro_torch.train import (OptConfig, make_train_step, opt_init,
                                   opt_shardings)

    cfg = smoke_config(arch)
    if cfg.n_layers // cfg.pattern_period > 1:
        cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
    sch = model_schema(cfg)
    params = np_params(sch, seed, torch.float64)
    b, t = TRAIN["batch"], TRAIN["seq"]
    batch = _inputs(cfg, b, t + 1, seed + 1)
    batch = {"tokens": batch["tokens"][:, :-1],
             "labels": batch["tokens"][:, 1:]}
    placements = None
    if cfg.moe_experts:
        g = torch.Generator().manual_seed(seed + 2)
        placements = torch.stack([torch.randperm(cfg.moe_experts,
                                                 generator=g)
                                  for _ in range(cfg.n_layers)])
    pshard = rules.param_shardings(sch, mesh, fsdp=True)
    dparams = schema.distribute(params, pshard)
    want_loss, want_grads = _grads(cfg, params, batch, placements)
    with ctx.use_mesh(mesh):
        got_loss, got_grads = _grads(cfg, dparams,
                                     layout_batch(batch, mesh), placements)

    ocfg = OptConfig(lr=TRAIN["lr"], warmup_steps=0, total_steps=10)
    step = make_train_step(cfg, ocfg, microbatches=TRAIN["microbatches"])
    wparams, wstate, wm = step(params, opt_init(params), batch, placements)
    dstate = opt_init(dparams)
    before = [_placements(x) for x in
              tree_leaves(dparams) + tree_leaves(dstate)]
    oshard = opt_shardings(pshard, mesh)
    layout_ok = all(
        list(x.placements) == list(s.placements)
        for k in ("m", "v", "master")
        for x, s in zip(tree_leaves(dstate[k]), tree_leaves(oshard[k])))
    with ctx.use_mesh(mesh):
        gparams, gstate, gm = step(dparams, dstate, batch, placements)
    after = [_placements(x) for x in
             tree_leaves(gparams) + tree_leaves(gstate)]
    return {
        "loss": (float(want_loss), float(got_loss)),
        "grads": [(w.numpy(), g_.full_tensor().numpy())
                  for w, g_ in zip(want_grads, got_grads)],
        "step_loss": (float(wm["loss"]), float(gm["loss"])),
        "grad_norm": (float(wm["grad_norm"]), float(gm["grad_norm"])),
        "masters": [(w.numpy(), g_.full_tensor().numpy()) for w, g_ in zip(
            tree_leaves(wstate["master"]), tree_leaves(gstate["master"]))],
        "lr": TRAIN["lr"],
        "placements": (before, after),
        "opt_layout_ok": layout_ok,
        "step": (int(wstate["step"]), int(gstate["step"].full_tensor())),
    }


def _grads(cfg, params, batch, placements):
    """``lm_loss`` and its gradient for every leaf of ``params``."""
    from repro_torch.models import lm_loss
    from repro_torch.models.schema import tree_leaves, tree_unflatten
    live = [leaf.detach().requires_grad_() for leaf in tree_leaves(params)]
    loss = lm_loss(tree_unflatten(params, live), cfg, batch,
                   placements=placements)
    return loss.detach(), torch.autograd.grad(loss, live, allow_unused=True,
                                              materialize_grads=True)


def launcher_case(arch: str, mesh, seed: int, out: str) -> dict:
    """``serve_local`` and the ``Trainer`` with and without the mesh, from
    their own bfloat16 weights (seed ``seed``): the prefill logits and the
    greedy tokens; the first train step's loss (2 microbatches); then 2
    mesh steps with a SkewShield rebalance after each and a checkpoint
    after each, which a second mesh trainer resumes from to repeat the
    third step."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import serve_local
    from repro_torch.train import OptConfig, Trainer, TrainerConfig

    cfg = smoke_config(arch)
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        logits, greedy = serve_local(
            cfg, batch=2, prompt=8, tokens=2, device="cpu",
            generator=torch.Generator().manual_seed(seed), mesh=m)
        runs[name] = (logits.float().numpy(), greedy)

    def data_fn(step):
        g = torch.Generator().manual_seed(seed + step)
        toks = torch.randint(0, cfg.vocab, (4, 9), generator=g)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def trainer(m, ckpt):
        return Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=0,
                                      total_steps=10),
                       TrainerConfig(checkpoint_every=1, rebalance_every=1,
                                     microbatches=2, theta_max=0.0),
                       str(Path(out, ckpt)), data_fn, seed=seed,
                       device="cpu", mesh=m)
    plain = trainer(None, f"ckpt_plain_{dist.get_rank()}").run(1)
    first = trainer(mesh, "ckpt_mesh")
    losses = [h["loss"] for h in first.run(2)]
    dist.barrier()
    again = trainer(mesh, "ckpt_mesh")
    resumed = again.try_resume()
    return {"serve": runs, "plain_loss": plain[0]["loss"],
            "losses": losses + [first.run(1)[-1]["loss"]],
            "resumed": resumed, "resumed_step": again.step,
            "repeat": again.run(1)[-1]["loss"]}


def bytes_case(arch: str, mesh, seed: int) -> dict:
    """The dry run's bytes per device on this mesh's axis sizes against the
    local shards the shardings give the real mesh: the parameters laid out
    by ``param_shardings``, a train cell's optimizer state by
    ``opt_shardings``, and a decode cell's cache by ``cache_shardings``."""
    import types

    from repro_torch.configs import smoke_config
    from repro_torch.launch.dryrun import bytes_per_device
    from repro_torch.launch.specs import cache_max_seq
    from repro_torch.models import init_cache, model_schema, schema
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import cache_schema
    from repro_torch.sharding import rules
    from repro_torch.train import opt_init

    cfg = smoke_config(arch)
    view = types.SimpleNamespace(axis_names=tuple(mesh.mesh_dim_names),
                                 shape=dict(zip(mesh.mesh_dim_names,
                                                mesh.shape)))
    local = lambda tree: sum(t.to_local().nbytes
                             for t in schema.tree_leaves(tree))
    sch = model_schema(cfg)
    params = schema.distribute(
        schema.init(sch, torch.Generator().manual_seed(seed), "cpu"),
        rules.param_shardings(sch, mesh))
    train = ShapeConfig("t", 16, 4, "train")
    decode = ShapeConfig("d", 16, 4, "decode")
    max_seq = cache_max_seq(cfg, decode)
    cache = schema.distribute(init_cache(cfg, 4, max_seq, "cpu"),
                              rules.cache_shardings(
                                  cache_schema(cfg, 4, max_seq), mesh, 4))
    state = opt_init(params)
    return {"dry_train": bytes_per_device(cfg, train, view),
            "dry_decode": bytes_per_device(cfg, decode, view),
            "params": local(params),
            "opt_state": sum(local(state[k]) for k in ("m", "v", "master"))
            + state["step"].to_local().nbytes,
            "cache": local(cache)}


SERVE_FLAGS = ("MOE_GROUPED", "DECODE_WS", "ATTN_SHARD")
TRAIN_FLAGS = ("MOE_GROUPED", "ATTN_SHARD", "DEFER_GRAD_SYNC")


@contextlib.contextmanager
def perf_env(names):
    """This process's ``REPRO_PERF_*`` variables set to exactly ``names``
    within the block, restored after it."""
    from repro_torch import flags
    saved = {n: os.environ.pop(f"REPRO_PERF_{n}", None) for n in flags.NAMES}
    for n in names:
        os.environ[f"REPRO_PERF_{n}"] = "1"
    try:
        yield
    finally:
        for n, v in saved.items():
            os.environ.pop(f"REPRO_PERF_{n}", None)
            if v is not None:
                os.environ[f"REPRO_PERF_{n}"] = v


def _dp(mesh) -> int:
    return math.prod(int(mesh.size(i)) for i, a in
                     enumerate(mesh.mesh_dim_names) if a in ("pod", "data"))


def _token_recorder(moe_mod, log: list):
    orig = moe_mod._route

    def route(router, cfg, xf, *args, **kw):
        log.append(int(xf.shape[0]))
        return orig(router, cfg, xf, *args, **kw)
    return orig, route


class _Gathers:
    """Every all-gather issued within the block: the mesh axis it ran over,
    its output size, whether the layer stack (``decoder_apply``) issued
    it, and whether it gathered a weight (``Local.param``)."""

    def __init__(self, mesh):
        import traceback

        from torch.utils._python_dispatch import TorchDispatchMode
        axes = {mesh.get_group(a).group_name: a
                for a in mesh.mesh_dim_names}
        rows = self.rows = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                if func._overloadpacket.__name__ == \
                        "all_gather_into_tensor":
                    stack = [(f.filename.rsplit("/", 1)[-1], f.name)
                             for f in traceback.extract_stack()]
                    rows.append((axes.get(args[2]), out.numel(),
                                 ("transformer.py", "decoder_apply")
                                 in stack,
                                 ("local.py", "param") in stack))
                return out
        self.mode = Mode()


def flags_serve_case(arch: str, mesh, seed: int) -> dict:
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_cache, model_schema, schema
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.schema import tree_leaves
    from repro_torch.models.skewshield import placements_array
    from repro_torch.launch.serve import moe_placers
    from repro_torch.models.transformer import cache_schema, encode
    from repro_torch.sharding import ctx, rules
    from repro_torch.train.train_step import make_serve_step

    cfg = smoke_config(arch)
    sch = model_schema(cfg)
    params = np_params(sch, seed)
    b, t = SERVE["batch"], SERVE["prompt"]
    batch = _inputs(cfg, b, t, seed + 1)
    if "frames" in batch:
        with torch.inference_mode():
            batch = {"tokens": batch["tokens"],
                     "encoder_out": encode(params, cfg, batch["frames"])}
    g = torch.Generator().manual_seed(seed + 2)
    decode = [torch.randint(0, cfg.vocab, (b, 1), generator=g)
              for _ in range(SERVE["decode"])]
    placements = None
    if cfg.moe_experts:
        perm = torch.randperm(cfg.moe_experts, generator=g)
        placements = placements_array(moe_placers(cfg), "cpu")[:, perm]
    prefix = cfg.prefix_len if "pixel_embeds" in batch else 0
    max_seq = prefix + t + SERVE["decode"]
    csch = cache_schema(cfg, b, max_seq)
    pshard = rules.param_shardings(sch, mesh, fsdp=True)
    dparams = schema.distribute(params, pshard)

    def dcache():
        return schema.distribute(_f32(init_cache(cfg, b, max_seq, "cpu")),
                                 rules.cache_shardings(csch, mesh, b))

    log: list = []
    orig, route = _token_recorder(moe_mod, log)
    moe_mod._route = route
    try:
        with perf_env(SERVE_FLAGS):
            with moe_mod.fixed_groups(_dp(mesh)):
                want = _serve_run(cfg, params,
                                  _f32(init_cache(cfg, b, max_seq, "cpu")),
                                  batch, placements, decode)
            del log[:]
            with ctx.use_mesh(mesh):
                got = _serve_run(cfg, dparams, dcache(), batch, placements,
                                 decode)
        tokens = list(log)
        # one decode step's all-gathers, with and without DECODE_WS
        step = make_serve_step(cfg)
        gathers = {}
        for name, on in (("ws", SERVE_FLAGS),
                         ("no_ws", ("MOE_GROUPED", "ATTN_SHARD"))):
            with perf_env(on), ctx.use_mesh(mesh):
                cache = dcache()
                _, cache = step(dparams, cache, batch, 0, placements)
                rec = _Gathers(mesh)
                step_batch = {k: v for k, v in batch.items()
                              if k == "encoder_out"}
                with rec.mode:
                    step(dparams, cache, {"tokens": decode[0],
                                          **step_batch}, prefix + t,
                         placements)
            gathers[name] = rec.rows
    finally:
        moe_mod._route = orig
    return {
        "free": (want[0].numpy(), got[0].numpy()),
        "logits": (want[1].numpy(), got[1].numpy()),
        "cache": [(w.numpy(), g_.numpy()) for w, g_ in
                  zip(tree_leaves(want[2]), tree_leaves(got[2]))],
        "route_tokens": tokens, "n_tokens": b * t, "dp": _dp(mesh),
        "gathers": gathers,
    }


def flags_train_case(arch: str, mesh, seed: int) -> dict:
    from repro_torch.configs import smoke_config
    from repro_torch.models import model_schema, schema
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.schema import tree_leaves
    from repro_torch.sharding import ctx, rules
    from repro_torch.train import OptConfig, make_train_step, opt_init
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = smoke_config(arch)
    if cfg.n_layers // cfg.pattern_period > 1:
        cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
    sch = model_schema(cfg)
    params = np_params(sch, seed, torch.float64)
    b, t = TRAIN["batch"], TRAIN["seq"]
    toks = _inputs(cfg, b, t + 1, seed + 1)["tokens"]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    placements = None
    if cfg.moe_experts:
        g = torch.Generator().manual_seed(seed + 2)
        placements = torch.stack([torch.randperm(cfg.moe_experts,
                                                 generator=g)
                                  for _ in range(cfg.n_layers)])
    pshard = rules.param_shardings(sch, mesh, fsdp=True)
    ocfg = OptConfig(lr=TRAIN["lr"], warmup_steps=0, total_steps=10)
    rows = {}
    log: list = []
    orig, route = _token_recorder(moe_mod, log)
    moe_mod._route = route
    try:
        for name, on in (("flags", TRAIN_FLAGS),
                         ("bf16_accum", TRAIN_FLAGS + ("BF16_ACCUM",))):
            with perf_env(on):
                step = make_train_step(cfg, ocfg,
                                       microbatches=TRAIN["microbatches"])
                with moe_mod.fixed_groups(_dp(mesh)):
                    _, wstate, wm = step(
                        {k: v for k, v in schema.tree_map(
                            lambda a: a.clone(), params).items()},
                        opt_init(params), batch, placements)
                del log[:]
                dparams = schema.distribute(params, pshard)
                with ctx.use_mesh(mesh):
                    _, gstate, gm = step(dparams, opt_init(dparams), batch,
                                         placements)
            rows[name] = {
                "step_loss": (float(wm["loss"]), float(gm["loss"])),
                "grad_norm": (float(wm["grad_norm"]),
                              float(gm["grad_norm"])),
                "masters": [(w.numpy(), g_.full_tensor().numpy())
                            for w, g_ in zip(
                                tree_leaves(wstate["master"]),
                                tree_leaves(gstate["master"]))],
                "route_tokens": list(log)}
    finally:
        moe_mod._route = orig
    counts = {}
    for defer in (True, False):
        for mb in (1, 2):
            on = TRAIN_FLAGS if defer else ("MOE_GROUPED", "ATTN_SHARD")
            with perf_env(on):
                step = make_train_step(cfg, ocfg, microbatches=mb)
                dparams = schema.distribute(params, pshard)
                comm = CommDebugMode()
                with ctx.use_mesh(mesh), comm:
                    step(dparams, opt_init(dparams), batch, placements)
            counts[(defer, mb)] = {str(k): v for k, v in
                                   comm.get_comm_counts().items()}
    return {**rows, "lr": TRAIN["lr"], "counts": counts,
            "n_tokens": b * t // TRAIN["microbatches"], "dp": _dp(mesh)}


def run_rank(rank: int, world: int, store: str, cases: list,
             out: str, shape=(2, 2)) -> None:
    """One of ``world`` ranks: every (kind, arch, seed) case of ``cases``
    on the ``shape`` ("data", "model") mesh; writes
    ``mesh_rank<rank>.pkl``."""
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        res = {}
        for kind, arch, seed in cases:
            t0 = time.perf_counter()
            try:
                if kind == "launchers":
                    res[(kind, arch)] = launcher_case(arch, mesh, seed, out)
                elif kind == "bytes":
                    res[(kind, arch)] = bytes_case(arch, mesh, seed)
                elif kind == "flags_serve":
                    res[(kind, arch)] = flags_serve_case(arch, mesh, seed)
                elif kind == "flags_train":
                    res[(kind, arch)] = flags_train_case(arch, mesh, seed)
                else:
                    fn = serve_case if kind == "serve" else train_case
                    res[(kind, arch)] = fn(arch, mesh, seed)
                res[(kind, arch)]["seconds"] = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 - the test reports it
                import traceback
                res[(kind, arch)] = {"error": traceback.format_exc()}
        Path(out, f"mesh_rank{rank}.pkl").write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()


def spawn(world: int, store: str, cases: list, out: str,
          timeout_s: int = 150, shape=(2, 2)) -> None:
    from torch_sharded_worker import spawn_ranks
    spawn_ranks(run_rank, world, (world, store, cases, out, shape),
                timeout_s)
