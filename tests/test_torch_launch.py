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
"""

import json
import types

import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_roofline
from repro.launch import specs as jax_specs
from repro.models.config import SHAPES as JAX_SHAPES
from repro.sharding import rules as jax_rules
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.models.config import SHAPES, ShapeConfig
from repro_torch.models.schema import tree_leaves

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
    """The bounds divide by the H100's dense bf16 rate and HBM bandwidth
    (not the TPU v5e's), and a skipped cell reads as a skip."""
    rep = {"arch": "granite_8b", "shape": "prefill_32k", "mesh": "single",
           "devices": 256, "flops": 2.56e17, "skipped": False,
           "bytes_per_device": {"total": 3.35e9},
           "replicated_fallbacks": {}}
    r = roofline.analyze(rep)
    assert r.compute_s == pytest.approx(1e15 / 989e12)
    assert r.memory_s == pytest.approx(1e-3)
    assert r.dominant == "compute" and r.bound_frac == 1.0
    assert "H100" in r.card and "700 W" in r.card
    assert roofline.analyze({"skipped": True}) is None
    assert dryrun.lower_cell("granite_8b", "long_500k")["skipped"]
