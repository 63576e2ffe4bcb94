"""The port's checkpoints, trainer and training launcher
(``repro_torch.train.checkpoint``, ``train.trainer``, ``launch.train``)
against the JAX package on the CPU, at smoke size.

The trainer is held against the JAX ``Trainer`` in float32 up to its first
expert move. The JAX ``Trainer`` runs its own loop, placers, watchdog and
SkewShield hook; only its step function is the float32 reference step of
``test_torch_train_step`` (its jitted ``make_train_step`` cannot take
float32 weights, see ``test_torch_train``), set on the instance. After the
first move the two part by design: the port maps the physical loads back
to logical experts (ROADMAP C10), and it keeps the placements in its
checkpoint (C12). Each has a test here that fails without the port's fix,
beside one that reads the JAX package's behaviour. Tolerances: the loss
rtol 1e-5 at every step; the grad norm rtol 1e-4 at the first step and 1e-2
after it (Adam's first step moves a weight by about lr x sign(g), so
weights whose gradients are within rounding of 0 step apart, and the JAX
package's init, std 1/2 here, ROADMAP C6, makes the next gradient
sensitive to them: measured 0.54%); placements equal; after the move the
moments within 1e-2 x each leaf's largest and the master within lr
(measured 0.5% and 0.57 lr; a wrong permutation would be off by the
leaf's scale); the port against itself (resume): bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import opt_init as jax_opt_init
from repro.train.trainer import Trainer as JaxTrainer
from repro.train.trainer import TrainerConfig as JaxTrainerConfig
from repro_torch.configs import smoke_config
from repro_torch.convert import (load_reference_opt_state,
                                 load_reference_params)
from repro_torch.launch import train as launch_train
from repro_torch.models.schema import tree_paths
from repro_torch.train import (CheckpointManager, OptConfig, Trainer,
                               TrainerConfig)
from repro_torch.train import checkpoint as ckpt_mod
from test_torch_train import _jax_lm_loss_f32
from test_torch_train_step import _jax_f32_train_step

ROOT = Path(__file__).resolve().parents[1]
MOE = "granite_moe_3b_a800m"


def _data_fn(cfg, batch=4, seq=16, seed=0):
    """Batch ``step``: random tokens from a numpy seed of (seed, step)."""
    def data_fn(step):
        rng = np.random.default_rng((seed, step))
        toks = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return data_fn


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.standard_normal(
                (3, 4)).astype(np.float32)).to(torch.bfloat16),
                       "b": torch.from_numpy(rng.standard_normal(
                           5).astype(np.float32))},
            "step": torch.tensor(seed, dtype=torch.int32),
            "table": torch.from_numpy(rng.integers(-1, 9, (2, 3)))}


def _equal(a, b):
    pa, pb = tree_paths(a), tree_paths(b)
    return [k for k, _ in pa] == [k for k, _ in pb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(pa, pb))


# -------------------------------------------------------------- checkpoint --
def test_checkpoint_round_trip(tmp_path):
    """Two saves, the newest restored bit for bit (bfloat16, float32, int32
    and int64 leaves), the manifest's fields and ``latest``."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, _state(1))
    path = mgr.save(20, _state(2), meta={"arch": "x"})
    assert path == tmp_path / "step_00000020"
    assert (tmp_path / "latest").read_text() == "step_00000020"
    step, got, manifest = mgr.restore(_state(0))
    assert step == 20 and _equal(got, _state(2))
    assert mgr.restore(_state(0), step=10)[0] == 10
    assert _equal(mgr.restore(_state(0), step=10)[1], _state(1))
    assert manifest["step"] == 20 and manifest["arch"] == "x"
    assert manifest["structure"] == ckpt_mod._structure_hash(_state(0))
    compression = "zstd" if ckpt_mod.zstandard is not None else None
    assert manifest["compression"] == compression
    assert (path / ckpt_mod._PAYLOAD[compression]).exists()
    assert manifest["bytes_raw"] > 0


def test_checkpoint_keep_collects_garbage(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, _state(step))
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000002", "step_00000003"]
    assert mgr.latest_step() == 3


def test_checkpoint_ignores_a_stray_tmp_dir(tmp_path):
    """A ``.tmp_`` directory left by a save that died is never ``latest``,
    never restored and never counted by ``keep``."""
    mgr = CheckpointManager(str(tmp_path), keep=1)
    assert mgr.latest_step() is None
    stray = tmp_path / ".tmp_dead"
    stray.mkdir()
    (stray / "manifest.json").write_text(json.dumps({"step": 99}))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(0))
    mgr.save(5, _state(5))
    assert mgr.latest_step() == 5
    assert _equal(mgr.restore(_state(0))[1], _state(5))
    assert stray.exists() and (tmp_path / "step_00000005").exists()


def test_checkpoint_refuses_another_structure(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    other = _state(0)
    other["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore(other)
    reshaped = _state(0)
    reshaped["params"]["b"] = torch.zeros(6)
    with pytest.raises(ValueError, match=r"\['params'\]\['b'\]"):
        mgr.restore(reshaped)


_NO_ZSTD = r"""
import importlib.abc, json, sys
from pathlib import Path

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "zstandard" or name.startswith("zstandard."):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import torch
from repro_torch.train import CheckpointManager
from repro_torch.train import checkpoint as ckpt_mod
assert ckpt_mod.zstandard is None
d = Path(sys.argv[1])
mgr = CheckpointManager(str(d / "plain"))
state = {"w": torch.arange(6, dtype=torch.float32).to(torch.bfloat16),
         "n": torch.tensor(3, dtype=torch.int32)}
mgr.save(7, state)
manifest = json.loads((d / "plain" / "step_00000007" /
                       "manifest.json").read_text())
assert manifest["compression"] is None, manifest
assert (d / "plain" / "step_00000007" / "state.pt").exists()
step, got, _ = mgr.restore({"w": torch.zeros(6, dtype=torch.bfloat16),
                            "n": torch.tensor(0, dtype=torch.int32)})
assert step == 7 and torch.equal(got["w"], state["w"]) and int(got["n"]) == 3
if (d / "zstd").exists():
    try:
        CheckpointManager(str(d / "zstd")).restore({"a": torch.zeros(4)})
    except ImportError as e:
        assert "zstandard" in str(e)
        print("refused")
print("ok")
"""


def test_checkpoint_without_zstandard(tmp_path):
    """With ``zstandard`` blocked (in a subprocess): a save writes
    ``state.pt`` uncompressed, records ``compression: null`` and restores;
    a compressed checkpoint (written here, when ``zstandard`` imports) is
    refused with an ``ImportError`` naming the package."""
    if ckpt_mod.zstandard is not None:
        CheckpointManager(str(tmp_path / "zstd")).save(
            1, {"a": torch.ones(4)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _NO_ZSTD, str(tmp_path)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split()
    assert lines[-1] == "ok"
    assert ("refused" in lines) == (ckpt_mod.zstandard is not None)


# ----------------------------------------------------------------- trainer --
@pytest.fixture(scope="module")
def jax_f32_step():
    """The float32 reference train step for the MoE smoke config, jitted
    once, in the JAX ``Trainer``'s step-function signature."""
    jcfg = jax_smoke_config(MOE)
    vg = jax.jit(jax.value_and_grad(
        lambda q, mb, place: _jax_lm_loss_f32(q, jcfg, mb, placements=place,
                                              collect_moe=True),
        has_aux=True))

    def make(ocfg):
        def step(params, state, batch, placements):
            return _jax_f32_train_step(vg, params, state, batch, placements,
                                       1, ocfg, True)
        return step

    return make


def _f32_trainers(tmp_path, jax_f32_step, tcfg_kw, ocfg_kw):
    """A JAX and a port trainer on the MoE smoke config with the same
    float32 weights (the JAX trainer's, cast) and fresh AdamW state."""
    cfg, jcfg = smoke_config(MOE), jax_smoke_config(MOE)
    jtr = JaxTrainer(jcfg, JaxOptConfig(**ocfg_kw),
                     JaxTrainerConfig(**tcfg_kw), str(tmp_path / "jax"),
                     lambda s: jax.tree.map(jnp.asarray,
                                            _data_fn(cfg)(s)))
    jtr.params = jax.tree.map(lambda a: a.astype(jnp.float32), jtr.params)
    jtr.opt_state = jax_opt_init(jtr.params)
    jtr.step_fn = jax_f32_step(JaxOptConfig(**ocfg_kw))
    tr = Trainer(cfg, OptConfig(**ocfg_kw), TrainerConfig(**tcfg_kw),
                 str(tmp_path / "port"), _data_fn(cfg), device="cpu")
    tr.params = load_reference_params(jax.tree.map(np.asarray, jtr.params),
                                      "cpu")
    tr.opt_state = load_reference_opt_state(
        jax.tree.map(np.asarray, jtr.opt_state), "cpu")
    return jtr, tr


def test_trainer_matches_jax_until_the_first_move(tmp_path, jax_f32_step):
    """Step by step until the JAX trainer's placers first move an expert
    (``rebalance_every=1``): loss, grad norm, every layer's placement and,
    after the move, the permuted weights and moments."""
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    tcfg = dict(total_steps=10, checkpoint_every=100, rebalance_every=1,
                skewshield=True, theta_max=0.1)
    jtr, tr = _f32_trainers(tmp_path, jax_f32_step, tcfg, kw)
    assert [p.s for p in tr.placers] == [p.s for p in jtr.placers]
    for step in range(1, 6):
        jh, th = jtr.run(1)[-1], tr.run(1)[-1]
        assert th["step"] == jh["step"] == step
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
        np.testing.assert_allclose(th["grad_norm"], jh["grad_norm"],
                                   rtol=1e-4 if step == 1 else 1e-2)
        for a, b in zip(tr.placers, jtr.placers):
            np.testing.assert_array_equal(a.placement, b.placement)
        if _moved(jtr):
            break
    else:
        pytest.fail("no expert moved in 5 steps")
    for key in ("m", "v", "master"):
        jt = jtr.opt_state[key]["groups"]["sub0"]["moe"]
        pt = tr.opt_state[key]["groups"]["sub0"]["moe"]
        for name in ("w_gate", "w_up", "w_down"):
            want = np.asarray(jt[name])
            atol = kw["lr"] if key == "master" else \
                1e-2 * float(np.abs(want).max())
            np.testing.assert_allclose(pt[name].numpy(), want, rtol=0,
                                       atol=atol, err_msg=f"{key} {name}")


class _Spy:
    """Stands in for a placer's ``update``: records the loads."""

    def __init__(self, placer):
        self.placer, self.seen = placer, []
        self.update = placer.update

    def __call__(self, loads):
        self.seen.append(np.asarray(loads).copy())
        return self.update(loads)


def test_trainer_hands_the_placer_logical_loads(tmp_path):
    """C10: under a placement other than the identity, a load vector by
    physical slot reaches ``placer.update`` as ``physical[placement]``, the
    loads by logical expert; the JAX trainer hands over the physical order
    (its fault, read here, not repaired)."""
    cfg, jcfg = smoke_config(MOE), jax_smoke_config(MOE)
    e = cfg.moe_experts
    tcfg = dict(total_steps=1, skewshield=True)
    tr = Trainer(cfg, OptConfig(), TrainerConfig(**tcfg), str(tmp_path),
                 _data_fn(cfg), device="cpu")
    jtr = JaxTrainer(jcfg, JaxOptConfig(), JaxTrainerConfig(**tcfg),
                     str(tmp_path / "jax"), None)
    rng = np.random.default_rng(3)
    placement = rng.permutation(e).astype(np.int32)
    physical = rng.permutation(np.arange(1, e + 1) * 100.0)
    loads = np.tile(physical, (cfg.n_layers, 1, 1))
    for trainer in (tr, jtr):
        for placer in trainer.placers:
            placer.placement = placement.copy()
            placer.update = _Spy(placer)
    tr._rebalance_experts(loads)
    jtr._rebalance_experts(loads)
    assert not np.array_equal(physical[placement], physical)
    for placer in tr.placers:
        np.testing.assert_array_equal(placer.update.seen[0],
                                      physical[placement])
    for placer in jtr.placers:
        np.testing.assert_array_equal(placer.update.seen[0], physical)


def _moved(trainer):
    return any((p.placement != np.arange(p.e)).any()
               for p in trainer.placers)


def test_resume_restores_placements(tmp_path):
    """C12: four steps straight, against two steps, a save, a fresh
    trainer's ``try_resume`` and two more steps, with experts moved before
    the save: the same losses, placements, routing tables, weights and
    optimizer state, bit for bit."""
    cfg = smoke_config(MOE)
    tcfg = TrainerConfig(total_steps=4, checkpoint_every=2,
                         rebalance_every=1, skewshield=True)
    ocfg = OptConfig(lr=5e-3, warmup_steps=2, total_steps=4)
    straight = Trainer(cfg, ocfg, tcfg, str(tmp_path / "a"), _data_fn(cfg),
                       device="cpu")
    hist = straight.run(4)
    first = Trainer(cfg, ocfg, tcfg, str(tmp_path / "b"), _data_fn(cfg),
                    device="cpu")
    first.run(2)
    assert _moved(first)
    resumed = Trainer(cfg, ocfg, tcfg, str(tmp_path / "b"), _data_fn(cfg),
                      device="cpu")
    assert resumed.try_resume() and resumed.step == 2
    for a, b in zip(resumed.placers, first.placers):
        np.testing.assert_array_equal(a.placement, b.placement)
        assert a.controller.assignment.table == \
            b.controller.assignment.table
    rest = resumed.run(2)
    assert [h["loss"] for h in rest] == [h["loss"] for h in hist[2:]]
    assert _equal(resumed.params, straight.params)
    assert _equal(resumed.opt_state, straight.opt_state)
    for a, b in zip(resumed.placers, straight.placers):
        np.testing.assert_array_equal(a.placement, b.placement)


def test_reference_resume_drops_placements(tmp_path):
    """The JAX trainer's side of C12, read and not repaired: after a move
    and a save, ``try_resume`` restores the permuted weights but every
    placer starts at the identity, so the next step's loss differs from the
    uninterrupted run's."""
    pytest.importorskip("zstandard")
    cfg, jcfg = smoke_config(MOE), jax_smoke_config(MOE)
    tcfg = JaxTrainerConfig(total_steps=3, checkpoint_every=2,
                            rebalance_every=1, skewshield=True)
    ocfg = JaxOptConfig(lr=5e-3, warmup_steps=2, total_steps=3)
    data = lambda s: jax.tree.map(jnp.asarray, _data_fn(cfg)(s))
    straight = JaxTrainer(jcfg, ocfg, tcfg, str(tmp_path / "a"), data)
    hist = straight.run(3)
    assert _moved(straight)
    first = JaxTrainer(jcfg, ocfg, tcfg, str(tmp_path / "b"), data)
    first.step_fn = straight.step_fn
    first.run(2)
    assert _moved(first)
    resumed = JaxTrainer(jcfg, ocfg, tcfg, str(tmp_path / "b"), data)
    resumed.step_fn = straight.step_fn
    assert resumed.try_resume() and resumed.step == 2
    assert not _moved(resumed)
    assert resumed.run(1)[-1]["loss"] != hist[2]["loss"]


# ---------------------------------------------------------------- launcher --
@pytest.mark.parametrize("arch", ["granite-8b", "granite-moe-3b-a800m"])
def test_launch_train_runs_on_the_cpu(arch, tmp_path, capsys):
    launch_train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                       "--batch", "2", "--seq", "32",
                       "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    name = arch.replace("-", "_")
    assert out.startswith(f"{name}: step 3 loss ")
    first, last = (float(x) for x in out.split("loss ")[1].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


def test_trainer_checkpoint_holds_placements(tmp_path):
    """``save`` writes the params, the optimizer state and, for an MoE
    model, each layer's placement and routing-table rows; a dense model's
    checkpoint has no SkewShield entry."""
    cfg = smoke_config(MOE)
    tr = Trainer(cfg, OptConfig(), TrainerConfig(skewshield=True),
                 str(tmp_path / "moe"), _data_fn(cfg), device="cpu")
    tr.placers[1].placement = np.roll(np.arange(cfg.moe_experts),
                                      1).astype(np.int32)
    tr.save()
    state = tr._state()
    assert state["skewshield"]["placement"].shape == (cfg.n_layers,
                                                      cfg.moe_experts)
    assert state["skewshield"]["table"].shape == (cfg.n_layers,
                                                  cfg.moe_experts, 2)
    _, got, _ = tr.ckpt.restore(state)
    assert torch.equal(got["skewshield"]["placement"][1],
                       torch.from_numpy(tr.placers[1].placement))
    dense = smoke_config("granite_8b")
    dt = Trainer(dense, OptConfig(), TrainerConfig(skewshield=True),
                 str(tmp_path / "dense"), _data_fn(dense), device="cpu")
    assert dt.placers == [] and set(dt._state()) == {"params", "opt"}
