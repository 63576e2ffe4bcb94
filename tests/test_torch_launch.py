"""The port's launch tooling (``repro_torch.launch.specs``, ``.roofline``,
``.dryrun``) against the JAX package's, on the CPU.

* ``specs``: for every arch x shape cell, ``cell_applicable``, the batch
  specs, ``cache_max_seq``, the parameter specs and the decode cache specs
  (shapes and dtypes, leaf by leaf) equal the JAX package's; the batch
  shardings' specs are its batch spec on dim 0.
* ``roofline``: ``active_params``, ``model_flops`` and
  ``ssm_inner_residual_flops`` equal the JAX functions for every cell.
* ``dryrun``: ``cell_list`` equals the JAX package's (recomputed here from
  its ``ARCHS``, ``SHAPES`` and ``cell_applicable``: importing its
  ``launch/dryrun.py`` sets ``XLA_FLAGS`` for 512 host devices in this
  process); ``lower_cell`` on smoke configs: the 2- and 3-group probes
  extrapolate exactly to a direct count at the full depth, the report
  carries the FLOP ratio to ``model_flops`` and the bytes per device, and
  ``roofline.analyze`` reads it. The bytes per device are held against a
  real mesh's shards in ``tests/test_torch_mesh.py``.
* collectives and memory (``dryrun.trace_mesh``, a fake process group in
  a subprocess): a small config's weight all-gathers on a fake (2, 2)
  mesh equal a hand count from the schema's shardings; the collective
  and memory figures extrapolate exactly across the probes; the report
  carries them under the JAX family names, the roofline charges them at
  the H100's NVLink rate, and a failed trace reads as an error, not as
  zeros; the launchers' ``--mode lower`` on granite-moe-3b-a800m's full
  config with and without their flags.
"""

import json
import math
import types
from pathlib import Path

import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_roofline
from repro.launch import specs as jax_specs
from repro.models.config import SHAPES as JAX_SHAPES
from repro.sharding import rules as jax_rules
from repro_torch import flags as launcher_flags
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model_schema
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.schema import tree_leaves
from repro_torch.sharding import rules

CELLS = [(a, s) for a in ARCHS for s in SHAPES]
MESH = types.SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 16, "model": 16})


def _same(got, want):
    """A tree of TensorSpecs against a tree of ShapeDtypeStructs."""
    import jax
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name


@pytest.mark.parametrize("arch,shape", CELLS)
def test_specs_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    cell, jcell = SHAPES[shape], JAX_SHAPES[shape]
    assert specs.cell_applicable(cfg, cell) == \
        jax_specs.cell_applicable(jcfg, jcell)
    assert specs.cache_max_seq(cfg, cell) == \
        jax_specs.cache_max_seq(jcfg, jcell)
    got, want = specs.batch_specs(cfg, cell), jax_specs.batch_specs(jcfg,
                                                                    jcell)
    assert sorted(got) == sorted(want)
    _same({k: got[k] for k in sorted(got)}, [want[k] for k in sorted(want)])
    bspec = jax_rules.batch_pspec(MESH, cell.global_batch)
    for name, sh in specs.batch_shardings(cfg, cell, MESH).items():
        assert sh.spec == (bspec[0],) + (None,) * (len(got[name].shape) - 1)
    if cell.kind == "decode":
        _same(specs.decode_cache_specs(cfg, cell)[0],
              jax_specs.decode_cache_specs(jcfg, jcell)[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    _same(specs.param_specs(get_config(arch))[0],
          jax_specs.param_specs(jax_get_config(arch))[0])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_flop_model_matches_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    cell, jcell = SHAPES[shape], JAX_SHAPES[shape]
    assert roofline.active_params(cfg) == jax_roofline.active_params(jcfg)
    assert roofline.model_flops(cfg, cell) == \
        jax_roofline.model_flops(jcfg, jcell)
    for devices in (1, 256, 512):
        assert roofline.ssm_inner_residual_flops(cfg, cell, devices) == \
            jax_roofline.ssm_inner_residual_flops(jcfg, jcell, devices)


def test_cell_list_matches_jax():
    want = [(a, s) for a in JAX_ARCHS for s in JAX_SHAPES
            if jax_specs.cell_applicable(jax_get_config(a),
                                         JAX_SHAPES[s])[0]]
    assert dryrun.cell_list() == want
    assert ARCHS == list(JAX_ARCHS) and list(SHAPES) == list(JAX_SHAPES)


SMALL = {"train": ShapeConfig("train_small", 16, 4, "train"),
         "prefill": ShapeConfig("prefill_small", 16, 4, "prefill"),
         "decode": ShapeConfig("decode_small", 16, 4, "decode")}


@pytest.mark.parametrize("arch,kind", [
    ("granite_8b", "train"), ("granite_8b", "decode"),
    ("granite_moe_3b_a800m", "prefill"), ("whisper_large_v3", "train"),
    ("internvl2_1b", "prefill"), ("xlstm_125m", "decode"),
    ("jamba_1_5_large_398b", "decode")])
def test_lower_cell_extrapolates_the_probes_exactly(arch, kind, tmp_path):
    """The report's FLOPs (2-group probe + (n - 2) x the 3-minus-2 group
    difference) equal a direct count of the smoke config at its full
    depth (jamba's smoke config is one superblock: the probes extrapolate
    back to it), and ``roofline`` reads the report."""
    cfg, shape = smoke_config(arch), SMALL[kind]
    rep = dryrun.lower_cell(arch, shape, "single", cfg=cfg)
    assert rep["flops"] == dryrun.step_flops(cfg, shape) > 0
    assert rep["flops_per_group"] == \
        rep["probe_flops"]["3"] - rep["probe_flops"]["2"] > 0
    assert rep["model_flops"] == roofline.model_flops(cfg, shape)
    assert rep["model_over_counted"] == rep["model_flops"] / rep["flops"]
    assert rep["devices"] == 256
    assert rep["bytes_per_device"]["total"] == sum(
        v for k, v in rep["bytes_per_device"].items() if k != "total")
    assert ("opt_state" in rep["bytes_per_device"]) == (kind == "train")
    assert ("cache" in rep["bytes_per_device"]) == (kind != "train")
    (tmp_path / f"{arch}__{shape.name}__single.json").write_text(
        json.dumps(rep))
    got = roofline.load_all(results_dir=tmp_path)
    assert list(got) == [f"{arch}__{shape.name}__single"]


def test_roofline_bounds_use_the_h100():
    """The bounds divide by the H100's dense bf16 rate, HBM bandwidth and
    NVLink rate each way (not the TPU v5e's), the link bytes count an
    all-reduce twice, the peak comes from the report's memory, and a
    skipped cell reads as a skip."""
    rep = {"arch": "granite_8b", "shape": "prefill_32k", "mesh": "single",
           "devices": 256, "flops": 2.56e17, "skipped": False,
           "bytes_per_device": {"total": 3.35e9},
           "collective_bytes": {"all-reduce": 450e6, "all-gather": 450e6},
           "memory": {"peak_bytes": 8e10},
           "replicated_fallbacks": {}}
    r = roofline.analyze(rep)
    assert r.compute_s == pytest.approx(1e15 / 989e12)
    assert r.memory_s == pytest.approx(1e-3)
    assert r.collective_s == pytest.approx(3e-3)
    assert roofline.LINK_BW == 450e9
    assert r.peak_hbm_gb == pytest.approx(80.0)
    assert r.dominant == "compute" and r.bound_frac == 1.0
    assert "H100" in r.card and "700 W" in r.card
    assert roofline.analyze({"skipped": True}) is None
    assert dryrun.lower_cell("granite_8b", "long_500k")["skipped"]


# ------------------------------------------------ collectives and memory --
FAKE_2x2 = ((2, 2), ("data", "model"))
JAX_FAMILIES = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute"}


def test_dry_run_weight_all_gathers_match_the_hand_count():
    """gemma3's smoke config on a fake (2, 2) mesh, a prefill step: every
    layer weight that "data" splits is all-gathered there once, split on
    "model" as the schema splits it (its heads and MLP columns divide the
    axis), and no activation is gathered. So the all-gather bytes one
    superblock adds (the 3-group probe less the 2-group one) are the sum
    over one superblock's layer weights split on "data" of their bytes,
    over 2 where "model" splits them too."""
    cfg, shape = smoke_config("gemma3_12b"), SMALL["prefill"]
    probes = dryrun.trace_mesh(cfg, shape, FAKE_2x2)
    delta = (probes[3]["collective_bytes"]["all-gather"]
             - probes[2]["collective_bytes"]["all-gather"])
    view = types.SimpleNamespace(axis_names=FAKE_2x2[1],
                                 shape=dict(zip(FAKE_2x2[1], FAKE_2x2[0])))
    sch = model_schema(cfg)
    n_groups = cfg.n_layers // cfg.pattern_period
    want = 0
    for s, spec in zip(tree_leaves(sch["groups"]), tree_leaves(
            rules.param_pspecs(sch["groups"], view))):
        if "data" in spec:
            size = math.prod(s.shape) // n_groups * s.dtype.itemsize
            want += size // (2 if "model" in spec else 1)
    assert want > 0 and delta == want


@pytest.mark.parametrize("arch,kind,microbatches", [
    ("granite_moe_3b_a800m", "train", 2), ("gemma3_12b", "train", 2),
    ("qwen2_7b", "train", 2), ("whisper_large_v3", "train", 1),
    ("jamba_1_5_large_398b", "train", 1), ("gemma3_12b", "decode", 1),
    ("dbrx_132b", "decode", 1), ("internvl2_1b", "prefill", 1)])
def test_dry_run_collectives_and_memory_extrapolate_exactly(
        arch, kind, microbatches):
    """At 4 superblocks each collective family's bytes, the argument and
    output bytes and the forward-and-backward phase's peak equal the 2-
    and 3-superblock probes' extrapolation, so a full depth's are exact;
    the peak holds the arguments. The optimizer phase's peak (a train
    cell's ``update``) adds its largest leaf's transient, which may pass
    from one leaf to another as depth grows, so it is extrapolated but
    not held exact here (the module docstring)."""
    cfg = smoke_config(arch)
    probes = dryrun.trace_mesh(cfg, SMALL[kind], FAKE_2x2,
                               microbatches=microbatches, groups=(2, 3, 4))
    want = dryrun._extrapolate(probes[2], probes[3], 4)
    assert want["collective_bytes"] == probes[4]["collective_bytes"]
    for key in ("argument_bytes", "output_bytes"):
        assert want["memory"][key] == probes[4]["memory"][key]
    assert want["memory"]["peak_by_phase"]["step"] == \
        probes[4]["memory"]["peak_by_phase"]["step"]
    assert set(probes[4]["memory"]["peak_by_phase"]) == (
        {"step", "update"} if kind == "train" else {"step"})
    for p in probes.values():
        assert set(p["collective_bytes"]) <= JAX_FAMILIES
        assert p["collective_bytes"]["all-gather"] > 0
        mem = dryrun._memory(p["memory"])
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert mem["peak_bytes"] == max(mem["peak_by_phase"].values())
        assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
        assert mem["output_bytes"] > 0


def test_lower_cell_reports_collectives_and_memory():
    """The report's collective bytes (JAX family names) and memory per
    device on the named production mesh, and the roofline's collective
    term at the H100's NVLink rate."""
    cfg = smoke_config("granite_moe_3b_a800m")
    rep = dryrun.lower_cell("granite_moe_3b_a800m", SMALL["train"],
                            "single", cfg=cfg, microbatches=2)
    assert "error" not in rep, rep.get("error")
    assert rep["microbatches"] == 2
    assert set(rep["collective_bytes"]) <= JAX_FAMILIES
    # the smoke widths do not divide 16: the gradients are all-reduced
    assert rep["collective_bytes"]["all-reduce"] > 0
    mem = rep["memory"]
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "peak_bytes"} <= set(mem)
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    # the roofline reads the cell's shape by name: the smoke cell as
    # train_4k (the terms read the report's own figures)
    r = roofline.analyze({**rep, "shape": "train_4k"})
    assert r.collective_s == pytest.approx(roofline.link_bytes(
        rep["collective_bytes"]) / 450e9) and r.collective_s > 0
    assert r.peak_hbm_gb == mem["peak_bytes"] / 1e9
    assert "collective s" in roofline.table(results_dir=Path("/nonexistent"))


def test_a_failed_trace_reads_as_an_error_not_zeros(monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("mesh trace failed (exit 1): boom")
    monkeypatch.setattr(dryrun, "trace_mesh", fail)
    rep = dryrun.lower_cell("granite_8b", SMALL["decode"], "single",
                            cfg=smoke_config("granite_8b"))
    assert "boom" in rep["error"]
    assert "collective_bytes" not in rep and "memory" not in rep
    assert roofline.analyze(rep) is None


@pytest.mark.parametrize("launcher,shape", [("train", "train_4k"),
                                            ("serve", "decode_32k")])
def test_launchers_dry_run_granite_moe_with_and_without_flags(
        launcher, shape, capsys):
    """granite-moe-3b-a800m's full config on the single production mesh,
    ``--mode lower`` with the launcher's flags and with
    ``--no-perf-flags``: both reports hold collective bytes per family and
    memory, the flags they ran under, and no error (``PERF.md`` records the
    figures; no direction is asserted)."""
    module = launch_train if launcher == "train" else launch_serve
    reps = []
    for extra in ([], ["--no-perf-flags"]):
        module.main(["--arch", "granite-moe-3b-a800m", "--mode", "lower",
                     "--shape", shape] + extra)
        reps.append(json.loads(capsys.readouterr().out))
    on, off = reps
    assert on["perf_flags"] == sorted(
        launcher_flags.launcher_defaults(launcher, "granite_moe_3b_a800m"))
    assert off["perf_flags"] == []
    for rep in reps:
        assert "error" not in rep, rep.get("error")
        assert set(rep["collective_bytes"]) <= JAX_FAMILIES
        assert rep["memory"]["peak_bytes"] > rep["memory"]["argument_bytes"]
        assert rep["microbatches"] == (8 if launcher == "train" else None)
