"""The port's MoE slice (``repro_torch.models.moe``, ``models.skewshield``,
the MoE branch of the transformer and the serve step, ``serve.engine`` and
the four new configs) against the JAX package on the CPU, at smoke size.

Inputs and weights are made with numpy from fixed seeds and handed to both
packages (weights at a 1/sqrt(fan-in) scale, so outputs stay near 1 and a
tolerance means the same at every element). Tolerances:

* float32 modules and layer stacks: rtol 1e-5 and atol 1e-5 (float32 sums in
  another order); expert loads, drop counts and the host planner's
  placements, moves, migration bytes and theta: equal;
* bfloat16 steps of the port against each other (placement invariance):
  equal, since a placement only relabels experts.

Why the serve path is held in float32: in bfloat16 the two frameworks round
at other points (the SiLU, and the elementwise ops XLA fuses), and the
router's top-k turns a one-ulp difference at a near-tie into another
expert, after which the outputs part by far more than the serve tolerance
(atol 0.3, rtol 0.05) on most seeded smoke weights. ``chip_smoke.py``'s
``serve_moe`` phase shows the same inside the port: its flash and plain
attention steps each agree with the plain attention per call, yet route
entries differently and end far apart. The serve path's layer stack
(``decoder_apply`` through the KV cache, then ``logits_from_hidden``)
takes float32 activations in both packages, where the routing agrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import decoder_apply as jax_decoder_apply
from repro.models import init_cache as jax_init_cache
from repro.models import logits_from_hidden as jax_logits_from_hidden
from repro.models import model_schema as jax_model_schema
from repro.models import moe as jmoe
from repro.models import schema as jschema
from repro.models import skewshield as jskew
from repro.models.layers import rmsnorm as jax_rmsnorm
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import load_reference_params
from repro_torch.launch.serve import moe_placers, serve_local
from repro_torch.models import (decoder_apply, forward, init_cache,
                                logits_from_hidden, model_schema, schema)
from repro_torch.models import moe, skewshield
from repro_torch.models.layers import rmsnorm
from repro_torch.models.schema import tree_map
from repro_torch.serve import ServeEngine
from repro_torch.train.train_step import make_serve_step

MOE_ARCHS = ["granite_moe_3b_a800m", "dbrx_132b"]
NEW_ARCHS = MOE_ARCHS + ["granite_8b", "granite_20b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _np_params(cfg, seed, bf16=False):
    """Weights for the port's schema of ``cfg`` from a numpy seed: normal at
    1/sqrt(fan-in) (the contracting dim), the spec's scale for the
    embedding, ones and zeros where the spec says; float32, or bfloat16 for
    the bfloat16 specs when ``bf16``."""
    rng = np.random.default_rng(seed)

    def make(spec):
        if spec.init in ("zeros", "ones"):
            a = np.full(spec.shape, spec.init == "ones", np.float32)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) > 1 else spec.shape[0]
            scale = spec.scale if spec.scale is not None else fan_in ** -0.5
            a = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
        if bf16 and spec.dtype == torch.bfloat16:
            a = a.astype(ml_dtypes.bfloat16)
        return a

    return tree_map(make, model_schema(cfg))


def _layer_moe(tree, g):
    return {k: v[g] for k, v in tree["groups"]["sub0"]["moe"].items()}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _placement(rng, e, identity):
    return None if identity else rng.permutation(e).astype(np.int32)


# --------------------------------------------------------------------- moe --
@pytest.mark.parametrize("identity", [True, False], ids=["identity",
                                                         "placed"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_jax(arch, identity):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    rng = np.random.default_rng(1)
    p = _layer_moe(_np_params(cfg, 0), 0)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    place = _placement(rng, cfg.moe_experts, identity)
    want, wstats = jmoe.moe(_jnp(p), jcfg, jnp.asarray(x),
                            None if identity else jnp.asarray(place),
                            return_stats=True)
    got, stats = moe.moe(load_reference_params(p, "cpu"), cfg, _t(x),
                         None if identity else _t(place), return_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(stats["expert_load"].numpy(),
                                  np.asarray(wstats["expert_load"]))
    assert int(stats["dropped"]) == int(wstats["dropped"])
    assert float(stats["expert_load"].sum()) == 48 * cfg.moe_topk


def _moe_np(p, cfg, x, placement, drop_last_of_overflow):
    """The MoE function written out in numpy, one (token, slot) entry at a
    time: each expert serves its first ``cap`` entries in (token, slot)
    order; with ``drop_last_of_overflow`` an expert with more than ``cap``
    entries also loses the one ranked ``cap - 1``."""
    xf = x.reshape(-1, x.shape[-1]).astype(np.float64)
    n, e, k = xf.shape[0], cfg.moe_experts, cfg.moe_topk
    cap = moe.capacity_for(n, cfg)
    gates = xf @ p["router"]
    top = np.argsort(-gates, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(gates, top, axis=1)
    w = np.exp(vals - vals.max(1, keepdims=True))
    w /= w.sum(1, keepdims=True)
    phys = placement[top] if placement is not None else top
    counts = np.bincount(phys.reshape(-1), minlength=e)
    seen = np.zeros(e, np.int64)
    out = np.zeros_like(xf)
    for tok in range(n):
        for s in range(k):
            ex = phys[tok, s]
            rank = seen[ex]
            seen[ex] += 1
            if rank >= cap or (drop_last_of_overflow and rank == cap - 1
                               and counts[ex] > cap):
                continue
            h = xf[tok] @ p["w_gate"][ex]
            h = h / (1 + np.exp(-h)) * (xf[tok] @ p["w_up"][ex])
            out[tok] += w[tok, s] * (h @ p["w_down"][ex])
    return out.reshape(x.shape), counts


@pytest.mark.parametrize("identity", [True, False], ids=["identity",
                                                         "placed"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_overflow_matches_jax(arch, identity):
    """At capacity factor 0.5 experts overflow. The JAX package keeps
    ``cap - 1`` tokens in each overflowing expert (the token ranked
    ``cap - 1`` reads the zero row); the port computes the same without a
    duplicate-index write. The numpy model with that extra drop matches
    both; the one without it does not match the reference."""
    cfg = dataclasses.replace(smoke_config(arch), moe_capacity_factor=0.5)
    jcfg = dataclasses.replace(jax_smoke_config(arch),
                               moe_capacity_factor=0.5)
    rng = np.random.default_rng(2)
    p = _layer_moe(_np_params(cfg, 3), 0)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    place = _placement(rng, cfg.moe_experts, identity)
    want, wstats = jmoe.moe(_jnp(p), jcfg, jnp.asarray(x),
                            None if identity else jnp.asarray(place),
                            return_stats=True)
    got, stats = moe.moe(load_reference_params(p, "cpu"), cfg, _t(x),
                         None if identity else _t(place), return_stats=True)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(stats["expert_load"].numpy(),
                                  np.asarray(wstats["expert_load"]))
    assert int(stats["dropped"]) == int(wstats["dropped"]) > 0
    model, counts = _moe_np(p, cfg, x, place, drop_last_of_overflow=True)
    np.testing.assert_allclose(model, want, rtol=1e-4, atol=1e-4)
    assert (counts > moe.capacity_for(48, cfg)).any()
    naive, _ = _moe_np(p, cfg, x, place, drop_last_of_overflow=False)
    assert np.abs(naive - want).max() > 1e-2


def test_capacity_for_matches_jax():
    for arch in MOE_ARCHS:
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (smoke_config(arch), jax_smoke_config(arch))):
            for n in [1, 2, 7, 48, 80, 100, 2049, 8192, 65536]:
                assert moe.capacity_for(n, cfg) == \
                    jmoe.capacity_for(n, jcfg)
    # the serve cell: 4 requests x 2048 tokens, 40 experts, top-8
    assert moe.capacity_for(8192, get_config("granite_moe_3b_a800m")) == 2048


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(5)
    g = rng.random((64, 8)).astype(np.float32)
    g /= g.sum(1, keepdims=True)
    top = np.argsort(-g, axis=1)[:, :2].astype(np.int32)
    want = jmoe.aux_load_balance_loss(jnp.asarray(g), jnp.asarray(top), 8)
    got = moe.aux_load_balance_loss(_t(g), _t(top), 8)
    np.testing.assert_allclose(float(got), float(want), **TOL)


# -------------------------------------------------------------- skewshield --
def _skewed_loads(rng, e, steps):
    """Zipf-like expert loads whose hot experts move every step."""
    base = 1.0 / np.arange(1, e + 1) ** 0.9
    for _ in range(steps):
        yield np.round(rng.permutation(base) * 1000 * e
                       + rng.integers(0, 50, e))


@pytest.mark.parametrize("e,s", [(40, 4), (8, 4), (16, 2)])
def test_skewshield_placer_matches_jax(e, s):
    """A seeded sequence of skewed loads: every update's placement, moved
    experts, migration bytes and theta equal the JAX placer's. Loads come
    back by physical slot, and the caller maps them to logical experts."""
    got_p = skewshield.SkewShieldPlacer(e, s, bytes_per_expert=3e6,
                                        theta_max=0.15)
    want_p = jskew.SkewShieldPlacer(e, s, bytes_per_expert=3e6,
                                    theta_max=0.15)
    moved = 0
    for logical in _skewed_loads(np.random.default_rng(e + s), e, 8):
        physical = np.empty_like(logical)
        physical[got_p.placement] = logical
        got = got_p.update(physical[got_p.placement])
        want = want_p.update(logical)
        np.testing.assert_array_equal(got.placement, want.placement)
        np.testing.assert_array_equal(got.moved_experts, want.moved_experts)
        assert got.migration_bytes == want.migration_bytes
        assert (got.theta_before, got.theta_after) == \
            (want.theta_before, want.theta_after)
        assert sorted(got.placement) == list(range(e))
        moved += len(got.moved_experts)
    assert moved > 0


def test_block_router_and_placements_array():
    r = skewshield.BlockRouter(40, 4)
    np.testing.assert_array_equal(r(np.arange(40)),
                                  jskew.BlockRouter(40, 4)(np.arange(40)))
    assert r.with_n_dest(8).per_shard == 5
    with pytest.raises(ValueError, match="evenly"):
        skewshield.BlockRouter(10, 4)
    placers = [skewshield.SkewShieldPlacer(8, 4, 1e6) for _ in range(3)]
    placers[1].placement = np.arange(8)[::-1].astype(np.int32)
    got = skewshield.placements_array(placers, "cpu")
    want = jskew.placements_array(
        [jskew.SkewShieldPlacer(8, 4, 1e6) for _ in range(3)])
    want = np.asarray(want).copy()
    want[1] = want[1][::-1]
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_permute_expert_params_matches_jax():
    """Bit-identical to the JAX package's, for one layer's float32 weights
    and for a stacked (n_groups, E, ...) bfloat16 tree."""
    cfg = smoke_config("granite_moe_3b_a800m")
    rng = np.random.default_rng(9)
    old = rng.permutation(cfg.moe_experts).astype(np.int32)
    new = rng.permutation(cfg.moe_experts).astype(np.int32)
    for p in (_layer_moe(_np_params(cfg, 1), 2),
              _np_params(cfg, 1, bf16=True)["groups"]["sub0"]["moe"]):
        want = jskew.permute_expert_params(_jnp(p), old, new)
        got = skewshield.permute_expert_params(
            load_reference_params(p, "cpu"), old, new)
        assert torch.equal(got["router"],
                           load_reference_params(p, "cpu")["router"])
        for name, w in want.items():
            np.testing.assert_array_equal(
                got[name].float().numpy(), np.asarray(w, np.float32))


# ------------------------------------------------------------ whole model --
def _placements(cfg, rng):
    return np.stack([rng.permutation(cfg.moe_experts)
                     for _ in range(cfg.n_layers)]).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decoder_apply_with_placements_matches_jax(arch):
    """The layer stack under per-layer placements, collecting the expert
    loads: float32 hidden states within 1e-5 and loads equal, stacked as
    (n_groups, MoE sub-layers per superblock, E)."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    rng = np.random.default_rng(3)
    p = _np_params(cfg, 4)
    place = _placements(cfg, rng)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24)
    want, _, wloads = jax_decoder_apply(
        _jnp(p), jcfg, jnp.asarray(x), jnp.asarray(pos),
        placements=jnp.asarray(place), remat=False, collect_moe=True)
    got, cache, loads = decoder_apply(
        load_reference_params(p, "cpu"), cfg, _t(x), _t(pos),
        placements=_t(place), collect_moe=True)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert loads.shape == (cfg.n_layers, 1, cfg.moe_experts)
    np.testing.assert_array_equal(loads.numpy(), np.asarray(wloads))
    assert (loads.sum(-1) == 48 * cfg.moe_topk).all()


def test_smoke_serve_path_matches_jax():
    """granite-moe's smoke serve path under non-identity placements: prefill
    40 tokens through the KV cache, then 8 decode steps, each step's
    next-token logits (``logits_from_hidden`` of the last final-normed
    hidden state) within 1e-5 of the JAX package's, float32 throughout
    (see the module docstring)."""
    arch = "granite_moe_3b_a800m"
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    rng = np.random.default_rng(6)
    p = _np_params(cfg, 5)
    tp, jp = load_reference_params(p, "cpu"), _jnp(p)
    place = _placements(cfg, rng)
    toks = rng.integers(0, cfg.vocab, (2, 48))
    emb = p["embed"]["tokens"]
    jcache = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jax_init_cache(jcfg, 2, 48))
    cache = tree_map(lambda a: a.float(), init_cache(cfg, 2, 48, "cpu"))
    jstack = jax.jit(jax_decoder_apply, static_argnums=1,
                     static_argnames=("remat",))
    for idx, t in [(0, 40)] + [(i, 1) for i in range(40, 48)]:
        x = emb[toks[:, idx:idx + t]]
        pos = idx + np.arange(t)
        jh, jcache, _ = jstack(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                               cache=jcache, cache_index=idx,
                               placements=jnp.asarray(place), remat=False)
        want = jax_logits_from_hidden(jp, jcfg, jax_rmsnorm(
            jp["final_norm"], jh[:, -1:], jcfg.norm_eps))
        h, cache = decoder_apply(tp, cfg, _t(x), _t(pos), cache=cache,
                                 cache_index=idx, placements=_t(place))
        got = logits_from_hidden(tp, cfg, rmsnorm(tp["final_norm"],
                                                  h[:, -1:], cfg.norm_eps))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for sub in cache:
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[sub][name].numpy(),
                                       np.asarray(jcache[sub][name]), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_placement_invariance(arch):
    """bfloat16, the port alone: the weights permuted to a new placement and
    run under it give the same logits, bit for bit, as the original weights
    under the identity, in the cache-free step and through the cache; the
    loads by physical slot are the identity's, relabelled."""
    cfg = smoke_config(arch)
    params = load_reference_params(_np_params(cfg, 7, bf16=True), "cpu")
    rng = np.random.default_rng(8)
    toks = _t(rng.integers(0, cfg.vocab, (2, 20)))
    nxt = _t(rng.integers(0, cfg.vocab, (2, 4)))
    ident = np.tile(np.arange(cfg.moe_experts, dtype=np.int32),
                    (cfg.n_layers, 1))
    place = _placements(cfg, rng)
    moved = dict(params)
    moved["groups"] = {"sub0": dict(params["groups"]["sub0"])}
    perm_layers = [skewshield.permute_expert_params(
        {k: v[g] for k, v in params["groups"]["sub0"]["moe"].items()},
        ident[g], place[g]) for g in range(cfg.n_layers)]
    moved["groups"]["sub0"]["moe"] = {
        k: torch.stack([pl[k] for pl in perm_layers])
        for k in perm_layers[0]}

    _, _, loads0 = forward(params, cfg, {"tokens": toks},
                           placements=_t(ident), collect_moe=True)
    _, _, loads1 = forward(moved, cfg, {"tokens": toks},
                           placements=_t(place), collect_moe=True)
    for g in range(cfg.n_layers):
        assert torch.equal(loads1[g, 0][place[g]], loads0[g, 0])
    for use_flash in (False, True):
        step = make_serve_step(cfg, use_flash=use_flash)
        a, _ = step(params, None, {"tokens": toks}, 0, _t(ident))
        b, _ = step(moved, None, {"tokens": toks}, 0, _t(place))
        c, _ = step(params, None, {"tokens": toks}, 0)
        assert torch.equal(a, b) and torch.equal(a, c)
    step = make_serve_step(cfg)
    caches = [init_cache(cfg, 2, 24, "cpu") for _ in range(2)]
    for idx, chunk in [(0, toks)] + [(20 + i, nxt[:, i:i + 1])
                                     for i in range(4)]:
        a, caches[0] = step(params, caches[0], {"tokens": chunk}, idx,
                            _t(ident))
        b, caches[1] = step(moved, caches[1], {"tokens": chunk}, idx,
                            _t(place))
        assert torch.equal(a, b)


def test_serve_local_runs_moe_under_placers():
    """``serve_local`` on the granite-moe smoke config on the CPU: the JAX
    launcher's placers (4 shards, 1e6 bytes an expert), finite logits and
    greedy tokens of the right shapes."""
    cfg = smoke_config("granite_moe_3b_a800m")
    placers = moe_placers(cfg)
    assert len(placers) == cfg.n_layers
    assert (placers[0].s, placers[0].bytes_per_expert) == (4, 1e6)
    assert moe_placers(smoke_config("dbrx_132b"))[0].s == 4
    assert moe_placers(get_config("granite_moe_3b_a800m"))[0].s == 4
    assert moe_placers(smoke_config("granite_8b")) == []
    first, greedy = serve_local(cfg, 2, 12, 4, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    assert first.shape == (2, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(first.float()).all())
    assert greedy.shape == (2, 4) and (greedy < cfg.vocab).all()


# ------------------------------------------------------------ serve engine --
def test_serve_engine_matches_jax():
    """``examples/serve_moe.py``'s session scenario: 8 replicas, two hot
    sessions and 40 random ones an interval, 6 intervals; every report
    field equals the JAX engine's."""
    rng = np.random.default_rng(0)
    rng.integers(0, 512, (4, 16))        # the example's prompt draw
    got_e, want_e = ServeEngine(n_replicas=8, theta_max=0.1), \
        JaxServeEngine(n_replicas=8, theta_max=0.1)
    migrated = 0
    for _ in range(6):
        reqs = [(1, 512, 256), (2, 512, 256)]
        reqs += [(int(rng.integers(100, 400)), 64, 32) for _ in range(40)]
        got, want = got_e.run_interval(reqs), want_e.run_interval(reqs)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name))
        migrated += got.migrated_sessions
    assert migrated > 0
    assert got_e.location == want_e.location
    assert got_e.controller.assignment.table == \
        want_e.controller.assignment.table


# ------------------------------------------------------- configs, weights --
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_match_jax(arch):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert schema.count_params(model_schema(cfg)) == \
            jschema.count_params(jax_model_schema(jcfg))
    assert get_config(arch.replace("_", "-")) == get_config(arch)


def test_granite_moe_full_size():
    """granite-moe-3b-a800m: 3.3 B parameters (6.6 GB in bfloat16), 40
    experts top-8 in each of 32 layers."""
    cfg = get_config("granite-moe-3b-a800m")
    n = schema.count_params(model_schema(cfg))
    assert 3.2e9 < n < 3.4e9
    assert all(cfg.layer_is_moe(i) for i in range(cfg.n_layers))


def test_load_reference_params_carries_moe_tree():
    """A JAX MoE parameter tree (bfloat16 weights, the float32 router)
    carries across bit for bit, the stacked (n_groups, E, ...) expert
    weights included."""
    jcfg = jax_smoke_config("granite_moe_3b_a800m")
    jp = jax.tree.map(np.asarray, jschema.init(jax_model_schema(jcfg),
                                               jax.random.PRNGKey(2)))
    tp = load_reference_params(jp, "cpu")
    sch = model_schema(smoke_config("granite_moe_3b_a800m"))
    got_moe, want_moe = tp["groups"]["sub0"]["moe"], \
        jp["groups"]["sub0"]["moe"]
    assert got_moe["router"].dtype == torch.float32
    assert got_moe["w_gate"].dtype == torch.bfloat16
    assert got_moe["w_down"].shape == sch["groups"]["sub0"]["moe"][
        "w_down"].shape
    for name, w in want_moe.items():
        np.testing.assert_array_equal(got_moe[name].float().numpy(),
                                      w.astype(np.float32))
