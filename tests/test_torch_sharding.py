"""The port's sharding rules against the JAX package's, and its layouts on
a 4-rank gloo mesh.

* ``partition_specs``/``param_pspecs`` (FSDP on and off), ``cache_pspecs``
  (batch 1 and 16), ``batch_pspec``, ``dp_degree`` and
  ``replication_report`` equal the JAX functions' for all ten configs on
  (16, 16), (2, 16, 16) and (4, 2) meshes. Both read only a mesh's
  ``shape`` and ``axis_names``, so a namespace stands in for the mesh;
  qwen2's 28 heads on 16-way axes fall back to replication in both.
* ``ctx._resolve`` against JAX's, the used-axes dedup of ``constrain``,
  and the mesh context; ``sharding.local``'s layouts are the identity on
  plain tensors, which is what keeps the model's one body per layer op
  for op the unsharded code without a mesh.
* One spawned 4-rank gloo group (``tests/torch_sharded_worker.py``): a
  smoke model's parameters distributed by ``param_shardings`` on a (2, 2)
  mesh hold the local shapes their specs give and round-trip through
  ``full_tensor()``; ``opt_shardings`` mirrors them; ``constrain``
  redistributes a DTensor; a batch split over ("pod", "data") lands on
  each rank in JAX's major-to-minor order.
"""

import math
import pickle
import types

import pytest

from repro.configs import get_config as jax_get_config
from repro.models import schema as jax_schema
from repro.models import transformer as jax_transformer
from repro.sharding import ctx as jax_ctx
from repro.sharding import rules as jax_rules
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import (data_axes, make_production_mesh,
                                     model_axes)
from repro_torch.models import schema, transformer
from repro_torch.sharding import ctx, rules

import torch_sharded_worker as worker

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}


def _mesh(name):
    shape = MESHES[name]
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _specs(tree):
    """A JAX tree of ``PartitionSpec`` as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_jax(arch, mesh_name):
    mesh = _mesh(mesh_name)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sch, jsch = transformer.model_schema(cfg), jax_transformer.model_schema(
        jcfg)
    assert schema.partition_specs(sch, mesh) == _specs(
        jax_schema.partition_specs(jsch, mesh))
    for fsdp in (True, False):
        assert rules.param_pspecs(sch, mesh, fsdp) == _specs(
            jax_rules.param_pspecs(jsch, mesh, fsdp))
        assert rules.replication_report(sch, mesh, fsdp) == \
            jax_rules.replication_report(jsch, mesh, fsdp)
    for batch in (1, 16):
        assert rules.cache_pspecs(
            transformer.cache_schema(cfg, batch, 64), mesh, batch) == \
            _specs(jax_rules.cache_pspecs(
                jax_transformer.cache_schema(jcfg, batch, 64), mesh, batch))
        assert rules.batch_pspec(mesh, batch) == tuple(
            jax_rules.batch_pspec(mesh, batch))
        assert rules.cache_rules(mesh, batch) == jax_rules.cache_rules(
            mesh, batch)
    assert rules.dp_degree(mesh) == jax_rules.dp_degree(mesh)
    assert schema.replication_report(sch, mesh) == \
        jax_schema.replication_report(jsch, mesh)


def test_qwen2_heads_fall_back_to_replication():
    """qwen2's 28 heads of 128 are one flattened 3584-wide dim, which a
    16-way axis divides; a 3-way axis does not, and both packages list it
    (and the KV and MLP widths) as replicated."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 3},
                                 axis_names=("data", "model"))
    sch = transformer.model_schema(get_config("qwen2_7b"))
    jsch = jax_transformer.model_schema(jax_get_config("qwen2_7b"))
    assert rules.replication_report(sch, _mesh("16x16")) == {}
    report = rules.replication_report(sch, mesh)
    assert report == jax_rules.replication_report(jsch, mesh)
    assert report["q_heads"] == [28 * 128] and report["kv_flat"] == [512]
    assert rules.param_pspecs(sch, mesh) == _specs(
        jax_rules.param_pspecs(jsch, mesh))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_resolve_matches_jax(mesh_name):
    mesh = _mesh(mesh_name)
    for name in ("dp", "tp", "sp", "data", "model", "pod", "nope", None):
        for size in (None, 1, 2, 4, 6, 16, 28, 32, 512):
            assert ctx._resolve(mesh, name, size) == jax_ctx._resolve(
                mesh, name, size), (name, size)


def test_resolve_spec_dedups_used_axes():
    mesh = _mesh("2x16x16")
    # sp resolves to "data", which dp already took
    assert ctx.resolve_spec(mesh, (32, 64), ("dp", "sp")) == (
        ("pod", "data"), None)
    assert ctx.resolve_spec(mesh, (16, 64), ("sp", "dp")) == ("data", None)
    assert ctx.resolve_spec(mesh, (6, 64, 32), ("dp", "tp", "model")) == (
        None, "model", None)
    with pytest.raises(ValueError):
        ctx.resolve_spec(mesh, (2, 3), ("dp",))


def test_mesh_context_nests_and_constrain_is_a_noop_without_one():
    x = object.__new__(object)
    assert ctx.current_mesh() is None
    m1, m2 = _mesh("4x2"), _mesh("16x16")
    with ctx.use_mesh(m1):
        assert ctx.current_mesh() is m1
        with ctx.use_mesh(m2):
            assert ctx.current_mesh() is m2
        with ctx.use_mesh(None):
            assert ctx.constrain(x, "dp") is x
        assert ctx.current_mesh() is m1
    assert ctx.current_mesh() is None
    assert ctx.constrain(x, "dp", "tp") is x
    assert data_axes(_mesh("2x16x16")) == ("pod", "data")
    assert model_axes(_mesh("4x2")) == ("model",)
    for multi_pod, ranks in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
            make_production_mesh(multi_pod=multi_pod)


@pytest.mark.parametrize("tp", [False, True])
def test_local_layouts_are_the_identity_on_plain_tensors(tp):
    import torch

    from repro_torch.sharding.local import (Local, layout_batch, mesh_of,
                                            replicated, residual)
    x = torch.arange(6.0).reshape(2, 3)
    loc = Local.of(x, tp=tp)
    assert loc.mesh is None and loc.model_rank == 0 and mesh_of(x) is None
    assert loc.act(x) is x and loc.act(x, model_dim=1) is x
    assert loc.param(x) is x and loc.param(x, 1) is x
    assert loc.out(x) is x and loc.out(x, model_dim=1) is x
    assert loc.wrap(x, None) is x and loc.total(x) is x
    state, write = loc.state(x, 1)
    assert state is x and write() is None
    assert replicated(x) is x
    assert torch.equal(residual(x, x), 2 * x)
    batch = {"tokens": x}
    assert layout_batch(batch, None) is batch
    assert ctx.constrain(x, "dp", "tp") is x


def test_params_laid_out_on_a_4_rank_mesh(tmp_path):
    world, arch = 4, "granite_moe_3b_a800m"
    worker.spawn_ranks(worker.run_mesh_rank, world,
                       (world, str(tmp_path / "store"), arch,
                        str(tmp_path)))
    sizes = {"data": 2, "model": 2}
    sharded = 0
    for rank in range(world):
        res = pickle.loads((tmp_path / f"mesh{rank}.pkl").read_bytes())
        for leaf in res["leaves"]:
            want = tuple(
                n // math.prod(sizes[a] for a in ((e,) if isinstance(e, str)
                                                  else e or ()))
                for n, e in zip(leaf["shape"], leaf["spec"]))
            assert leaf["local"] == want, leaf["path"]
            assert leaf["round_trip"], leaf["path"]
            sharded += leaf["local"] != leaf["shape"]
        assert res["opt_mirrors"]
        assert res["opt_step"] == ((), [("R",), ("R",)])
        data = rank // 2
        assert res["constrain"] == (
            [("S", 0), ("R",)],
            [[2.0 * i, 2.0 * i + 1] for i in (2 * data, 2 * data + 1)])
        assert res["axes"] == (("pod", "data"), ("model",))
        assert res["batch_local"] == [[3.0 * r + c for c in range(3)]
                                      for r in (2 * rank, 2 * rank + 1)]
    assert sharded > 0
