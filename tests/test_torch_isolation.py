"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and not the spawned ranks' code (``tests/torch_*_worker.py``)
imports JAX or the JAX package, the package imports and
runs with both blocked (the stream stage, a ``ChaosRunner`` interval with
a kill and an ``AutoscaleLoop`` step on the device ring, a smoke serve
step, an MoE smoke serve path, the serving engine, a keyed data pipeline
interval, an MoE train step and one smoke forward of each of jamba,
xlstm, whisper and internvl2, a smoke dry run and its roofline, and on a
one-rank gloo group a sharded stage interval and the mesh worker's serve
and train cases on a (1, 1) mesh, with a backward on another thread),
and its entry
points refuse to run without a CUDA device unless the caller asks for the
CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_mesh_worker.py",
     ROOT / "tests" / "torch_sharded_worker.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax_or_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now fails
import numpy as np
import repro_torch
from repro_torch import (Assignment, BalanceConfig, Hash32, KeyedStage,
                         RebalanceController, WordCount)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)

def stage(**kw):
    c = RebalanceController(Assignment(Hash32(4, seed=2)),
                            BalanceConfig(theta_max=0.0, window=2))
    return KeyedStage(WordCount(), c, window=2, state_backend="device",
                      substrate="kernels", **kw)

try:
    stage()
except RuntimeError as e:
    assert "device='cpu'" in str(e)
else:
    raise AssertionError("KeyedStage without device= ran with no CUDA")
s = stage(device="cpu")
r = s.process_interval_arrays(np.arange(200, dtype=np.int64) % 37)
assert r.tuples == 200 and s.total_state_keys() == 37

import repro_torch.core.autoscale
import repro_torch.streams.faults
from repro_torch.core import AutoscaleConfig, AutoscaleLoop
from repro_torch.streams import ChaosRunner, FaultPlan, KillTask
runner = ChaosRunner(stage(device="cpu"),
                     FaultPlan([KillTask(interval=1, site="mid")]))
r = runner.process_interval(np.arange(200, dtype=np.int64) % 37)
assert r.tuples == 200 and runner.stage.total_state_keys() == 37
assert [(e.interval, e.kind) for e in runner.events] == [(1, "kill@mid")]
loop = AutoscaleLoop(stage(device="cpu"), AutoscaleConfig(target_load=50.0))
assert loop.step(np.arange(200, dtype=np.int64) % 37).tuples == 200

import torch
import repro_torch.models
from repro_torch.configs import smoke_config
from repro_torch.launch.serve import init_request, serve_local
from repro_torch.train.train_step import make_serve_step
cfg = smoke_config("gemma3_12b")
try:
    serve_local(cfg)
except RuntimeError as e:
    assert "device='cpu'" in str(e)
else:
    raise AssertionError("serve_local without device= ran with no CUDA")
params, tokens = init_request(cfg, 2, 40, "cpu",
                              torch.Generator().manual_seed(0))
logits, cache = make_serve_step(cfg, use_flash=True)(
    params, None, {"tokens": tokens}, 0)
assert logits.shape == (2, 1, cfg.vocab_padded) and cache is None
assert bool(torch.isfinite(logits.float()).all())

from repro_torch.serve import ServeEngine
moe_cfg = smoke_config("granite_moe_3b_a800m")
first, greedy = serve_local(moe_cfg, 2, 12, 2, device="cpu",
                            generator=torch.Generator().manual_seed(0))
assert greedy.shape == (2, 2) and bool(torch.isfinite(first.float()).all())
eng = ServeEngine(n_replicas=4)
assert eng.run_interval([(1, 64, 8), (2, 32, 4)]).requests == 2

import tempfile
import repro_torch.data
import repro_torch.train
from repro_torch.data import KeyedDataPipeline, zipf_sources
from repro_torch.models import schema as schema_mod
from repro_torch.models.transformer import model_schema
from repro_torch.train import (OptConfig, Trainer, TrainerConfig,
                               make_train_step, opt_init)
pipe = KeyedDataPipeline(zipf_sources(16), n_workers=2, seq_len=16,
                         vocab=moe_cfg.vocab)
pipe.run_interval(64)
batch = pipe.worker_batch(0, 2)
assert batch["tokens"].shape == (2, 16)
batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
params = schema_mod.init(model_schema(moe_cfg),
                         torch.Generator().manual_seed(0), "cpu")
state = opt_init(params)
params, state, metrics = make_train_step(
    moe_cfg, OptConfig(), microbatches=2, collect_moe=True)(
    params, state, batch)
assert bool(torch.isfinite(metrics["loss"])) and int(state["step"]) == 1
assert metrics["expert_load"].shape == (moe_cfg.n_layers, 1,
                                        moe_cfg.moe_experts)
with tempfile.TemporaryDirectory() as d:
    try:
        Trainer(moe_cfg, OptConfig(), TrainerConfig(), d, None)
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("Trainer without device= ran with no CUDA")
from repro_torch.launch.serve import frontend_inputs
from repro_torch.models import forward
for arch in ("jamba_1_5_large_398b", "xlstm_125m", "whisper_large_v3",
             "internvl2_1b"):
    acfg = smoke_config(arch)
    gen = torch.Generator().manual_seed(1)
    params, tokens = init_request(acfg, 2, 8, "cpu", gen)
    front = frontend_inputs(acfg, 2, "cpu", gen)
    with torch.inference_mode():
        hidden, _ = forward(params, acfg, {"tokens": tokens, **front})
    assert hidden.shape == (2, 8 + (acfg.prefix_len if front.get(
        "pixel_embeds") is not None else 0), acfg.d_model), arch
    assert bool(torch.isfinite(hidden.float()).all()), arch
import torch.distributed as dist
import repro_torch.launch.mesh
import repro_torch.sharding.ctx
import repro_torch.sharding.rules
with tempfile.TemporaryDirectory() as d:
    dist.init_process_group("gloo", store=dist.FileStore(d + "/store", 1),
                            rank=0, world_size=1)
    try:
        c = RebalanceController(Assignment(Hash32(4, seed=2)),
                                BalanceConfig(theta_max=0.0, window=2))
        s = KeyedStage(WordCount(), c, window=2, state_backend="sharded",
                       substrate="kernels", device="cpu")
        r = s.process_interval_arrays(np.arange(200, dtype=np.int64) % 37)
        assert r.tuples == 200 and s.total_state_keys() == 37
        assert s.backend.fleet.n_shards == 1
        sys.path.insert(0, "tests")
        import torch_mesh_worker
        from repro_torch.launch.mesh import make_mesh
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        row = torch_mesh_worker.serve_case("granite_moe_3b_a800m", mesh, 1)
        want, got = row["free"]
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
        assert row["routing_equal"] and row["routes"] > 0
        row = torch_mesh_worker.train_case("granite_8b", mesh, 2)
        assert row["placements"][0] == row["placements"][1]
        np.testing.assert_allclose(row["loss"][1], row["loss"][0], rtol=1e-5)
        # a CUDA backward runs on the autograd engine's device threads: the
        # recomputes there (remat, the loss chunks) must see the mesh
        import threading
        from repro_torch.models import lm_loss
        from repro_torch.sharding import ctx, rules
        gcfg = smoke_config("granite_8b")
        sch = model_schema(gcfg)
        live = schema_mod.distribute(
            schema_mod.init(sch, torch.Generator().manual_seed(3), "cpu"),
            rules.param_shardings(sch, mesh))
        live = schema_mod.tree_map(lambda t: t.detach().requires_grad_(),
                                   live)
        toks = torch.randint(0, gcfg.vocab, (2, 9),
                             generator=torch.Generator().manual_seed(4))
        done = []
        with ctx.use_mesh(mesh):
            loss = lm_loss(live, gcfg, {"tokens": toks[:, :-1],
                                        "labels": toks[:, 1:]})
            worker = threading.Thread(target=lambda: done.append(
                torch.autograd.grad(loss, schema_mod.tree_leaves(live))))
            worker.start()
            worker.join(timeout=120)
        assert done and len(done[0]) == len(schema_mod.tree_leaves(live))
    finally:
        dist.destroy_process_group()
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.models.config import ShapeConfig
rep = dryrun.lower_cell("granite_moe_3b_a800m",
                        ShapeConfig("t", 8, 2, "train"),
                        cfg=smoke_config("granite_moe_3b_a800m"))
assert rep["flops"] > 0 and rep["bytes_per_device"]["total"] > 0
assert len(dryrun.cell_list()) > 0
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
