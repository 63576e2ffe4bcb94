"""The port's optimizer and train step (``repro_torch.train.optimizer``,
``train.train_step.make_train_step``) against the JAX package on the CPU,
at smoke size; the float32 reference loss and the helpers are
``test_torch_train``'s (see its docstring for why the float32 reference
composes the JAX package's layers). Tolerances:

* ``opt_update`` (the JAX function itself, bfloat16 parameters): the
  learning rate rtol 1e-6; the norm rtol 1e-5 (a float32 sum of ~10^5
  squares in another order); moments and master within rtol 2e-5 plus
  1e-6 x the leaf's largest (cancellation in ``b1 m + (1 - b1) g`` and
  ``w - lr (u + wd w)`` leaves errors relative to the operands, not the
  result); each bfloat16 parameter within one bfloat16 ulp of the JAX
  package's plus that master tolerance (the master is cast);
* a float32 train step: loss rtol 1e-5, norm rtol 1e-4; moments within
  1e-4 x the leaf's largest, 2^-6 x for the two leaves above whose
  gradients are a bfloat16 ulp apart (v squares the gap); the updated
  master within lr / 10 of the JAX package's, and within 2.5 x lr for
  those two leaves (Adam's first step moves a weight by lr g / (|g| +
  eps), about lr x sign(g): a small gradient's relative difference moves
  its weight by up to that much, and an element whose gradient is within
  that ulp of 0 may step the other way);
* bfloat16 against the JAX package's ``make_train_step``: loss rtol 5e-3,
  grad norm rtol 5e-2, each updated weight within 2.5 x lr of the JAX
  package's (C11: a few routed entries may differ, and an element whose
  gradient changes sign steps the other way).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.optimizer import opt_init as jax_opt_init
from repro.train.optimizer import opt_update as jax_opt_update
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.convert import (load_reference_opt_state,
                                 load_reference_params)
from repro_torch.models import model_schema
from repro_torch.models.schema import tree_leaves, tree_map, tree_paths
from repro_torch.train import (OptConfig, global_norm, make_train_step,
                               opt_init, opt_update)
from test_torch_train import (ARCHS, BF16_CAST_LEAVES, _batch,
                              _jax_lm_loss_f32,
                              _jnp, _model, _np_params, _place, _placements,
                              _t)


# --------------------------------------------------------------- optimizer --
def _np_grads(cfg, seed, scale):
    """Random gradients in each parameter's dtype (a one-microbatch step's
    gradients), normal x ``scale``."""
    rng = np.random.default_rng(seed)

    def make(spec):
        g = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
        return g.astype(ml_dtypes.bfloat16) if spec.dtype == torch.bfloat16 \
            else g

    return tree_map(make, model_schema(cfg))


def _bf16_ulp_close(got: torch.Tensor, want, path: str) -> None:
    """Within one bfloat16 ulp of ``want`` elementwise, plus the master's
    own tolerance (1e-6 x the leaf's largest) that the cast carries."""
    w = np.asarray(want, np.float32)
    tol = np.abs(w) * 2.0 ** -7 + 1e-6 * float(np.abs(w).max())
    assert (np.abs(got.float().numpy() - w) <= tol).all(), path


@pytest.mark.parametrize("grad_scale", [100.0, 1e-4],
                         ids=["clipped", "unclipped"])
@pytest.mark.parametrize("start", [1, 9], ids=["warmup_edge",
                                               "cosine_tail"])
def test_opt_update_matches_jax(start, grad_scale):
    """Three steps of the JAX package's ``opt_update`` and the port's from
    the same bfloat16 weights, bfloat16 gradients and state (carried across
    by ``load_reference_opt_state``), with warmup 2 and 10 steps in all:
    from step 1 the last warmup step, the first cosine step and the next;
    from step 9 the last cosine step and two past ``total_steps`` (progress
    clipped to 1). Gradients x100 clip (norm > 1), x1e-4 do not."""
    cfg = smoke_config("granite_moe_3b_a800m")
    p = _np_params(cfg, 8, bf16=True)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jparams = _jnp(p)
    jstate = jax_opt_init(jparams)
    jstate["step"] = jnp.asarray(start, jnp.int32)
    tparams = load_reference_params(p, "cpu")
    tstate = load_reference_opt_state(jax.tree.map(np.asarray, jstate),
                                      "cpu")
    assert tstate["step"].dtype == torch.int32 and int(tstate["step"]) == \
        start
    for k in range(3):
        g = _np_grads(cfg, 20 + k, grad_scale)
        jparams, jstate, jm = jax_opt_update(_jnp(g), jstate, jparams,
                                             JaxOptConfig(**kw))
        tparams, tstate, tm = opt_update(load_reference_params(g, "cpu"),
                                         tstate, tparams, OptConfig(**kw))
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert (float(tm["grad_norm"]) > 1.0) == (grad_scale > 1)
        assert float(global_norm(load_reference_params(g, "cpu"))) == \
            float(tm["grad_norm"])
    assert int(tstate["step"]) == int(jstate["step"]) == start + 3
    for key in ("m", "v", "master"):
        for (path, got), want in zip(tree_paths(tstate[key]),
                                     jax.tree.leaves(jstate[key])):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=2e-5,
                atol=1e-6 * float(np.abs(want).max()),
                err_msg=f"{key}{path}")
    for (path, got), want in zip(tree_paths(tparams),
                                 jax.tree.leaves(jparams)):
        assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                             else torch.float32)
        _bf16_ulp_close(got, want, path)


def test_opt_init_and_load_reference_opt_state():
    """``opt_init``: zero moments, a float32 copy of each parameter as the
    master (not an alias of a float32 parameter), step 0, equal to the JAX
    package's; ``load_reference_opt_state`` carries it bit for bit and
    refuses a tree without the four entries."""
    cfg = smoke_config("granite_8b")
    p = _np_params(cfg, 9, bf16=True)
    tparams = load_reference_params(p, "cpu")
    state = opt_init(tparams)
    want = jax_opt_init(_jnp(p))
    carried = load_reference_opt_state(jax.tree.map(np.asarray, want), "cpu")
    for key in ("m", "v", "master"):
        for a, b in zip(tree_leaves(state[key]), tree_leaves(carried[key])):
            assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    assert int(state["step"]) == int(carried["step"]) == 0
    norm = tparams["final_norm"]["scale"]
    assert state["master"]["final_norm"]["scale"].data_ptr() != \
        norm.data_ptr()
    with pytest.raises(ValueError, match="m, v, master and step"):
        load_reference_opt_state({"m": {}, "v": {}}, "cpu")


# -------------------------------------------------------------- train step --
@pytest.fixture(scope="module")
def jax_f32_grad():
    """jitted value-and-grad of :func:`_jax_lm_loss_f32`, one per arch
    (and batch shape)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_smoke_config(arch)
            moe = jcfg.moe_experts > 0
            cache[arch] = jax.jit(jax.value_and_grad(
                lambda q, mb, place: _jax_lm_loss_f32(
                    q, jcfg, mb, placements=place, collect_moe=moe),
                has_aux=moe))
        return cache[arch]

    return get


def _jax_f32_train_step(vg, params, state, batch, place, microbatches,
                        ocfg, moe):
    """The JAX package's ``make_train_step`` (its accumulation, division
    and ``opt_update``) around the float32 reference loss."""
    b = batch["tokens"].shape[0] // microbatches
    g_acc, l_acc, ld_acc = None, 0.0, 0.0
    for i in range(microbatches):
        mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        out, grads = vg(params, mb, place)
        loss, loads = out if moe else (out, 0.0)
        g_acc = grads if g_acc is None else jax.tree.map(
            lambda a, g: a + g.astype(jnp.float32), g_acc, grads)
        l_acc, ld_acc = l_acc + loss, ld_acc + loads
    if microbatches > 1:
        g_acc = jax.tree.map(lambda g: g / microbatches, g_acc)
        l_acc = l_acc / microbatches
    params, state, om = jax_opt_update(g_acc, state, params, ocfg)
    return params, state, {"loss": l_acc, **om, "expert_load": ld_acc}


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, microbatches, jax_f32_grad):
    """A float32 step of ``make_train_step`` (``collect_moe`` on the MoE
    model, under random placements) against the JAX package's step around
    the float32 reference loss: loss, grad norm, lr, expert loads (summed
    over the microbatches, not divided), moments and master. (Further steps
    start from weights that Adam's sign amplification has set apart; the
    optimizer's own steps are held above.)"""
    cfg, jcfg, p, place = _model(arch, 12)
    moe = cfg.moe_experts > 0
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jparams = _jnp(p)
    jstate = jax_opt_init(jparams)
    tparams = load_reference_params(p, "cpu")
    tstate = opt_init(tparams)
    step = make_train_step(cfg, OptConfig(**kw), microbatches=microbatches,
                           collect_moe=True)
    batch = _batch(cfg, 13)
    jparams, jstate, jm = _jax_f32_train_step(
        jax_f32_grad(arch), jparams, jstate, _jnp(batch),
        _place(place, jnp.asarray), microbatches, JaxOptConfig(**kw), moe)
    tparams, tstate, tm = step(tparams, tstate, _t(batch),
                               _place(place, torch.from_numpy))
    for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-6)):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=rtol, err_msg=key)
    assert int(tstate["step"]) == 1
    if moe:
        np.testing.assert_array_equal(tm["expert_load"].numpy(),
                                      np.asarray(jm["expert_load"]))
        assert float(tm["expert_load"].sum()) == \
            batch["tokens"].size * cfg.moe_topk * cfg.n_layers
    else:
        assert "expert_load" not in tm
    for key in ("m", "v"):
        for (path, got), want in zip(tree_paths(tstate[key]),
                                     jax.tree.leaves(jstate[key])):
            want = np.asarray(want)
            rel = 2.0 ** -6 if path in BF16_CAST_LEAVES else 1e-4
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=1e-12 + rel * float(np.abs(want).max()),
                err_msg=f"{key}{path}")
    for (path, got), want in zip(tree_paths(tstate["master"]),
                                 jax.tree.leaves(jstate["master"])):
        step_tol = 2.5 if path in BF16_CAST_LEAVES else 0.1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=kw["lr"] * step_tol,
                                   err_msg=f"master{path}")


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_bf16_matches_jax_train_step(arch, microbatches):
    """bfloat16 weights, the JAX package's ``make_train_step`` itself
    (jitted, remat on): one step from the same weights and state. Loss rtol
    5e-3, grad norm rtol 5e-2, lr equal to rtol 1e-6; each updated weight
    within 2.5 x lr of the JAX package's (C11: a few routed entries may
    differ, and an element whose gradient changes sign steps the other
    way); the loads sum to tokens x top-k x layers."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    moe = cfg.moe_experts > 0
    p = _np_params(cfg, 14, bf16=True)
    place = _placements(cfg, 15) if moe else None
    batch = _batch(cfg, 16)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxOptConfig(**kw),
                                        microbatches=microbatches,
                                        collect_moe=True))
    jparams, _, jm = jstep(_jnp(p), jax_opt_init(_jnp(p)), _jnp(batch),
                           _place(place, jnp.asarray))
    tparams = load_reference_params(p, "cpu")
    step = make_train_step(cfg, OptConfig(**kw), microbatches=microbatches,
                           collect_moe=True)
    tparams, tstate, tm = step(tparams, opt_init(tparams), _t(batch),
                               _place(place, torch.from_numpy))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=5e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=5e-2)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tstate["step"]) == 1
    if moe:
        assert float(tm["expert_load"].sum()) == float(
            jm["expert_load"].sum()) == \
            batch["tokens"].size * cfg.moe_topk * cfg.n_layers
    for got, want in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=2.5 * kw["lr"])


def test_train_step_refuses_flash_and_uneven_microbatches():
    cfg = smoke_config("granite_8b")
    with pytest.raises(NotImplementedError, match="no backward"):
        make_train_step(cfg, OptConfig(), use_flash=True)
    p = load_reference_params(_np_params(cfg, 0), "cpu")
    step = make_train_step(cfg, OptConfig(), microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(p, opt_init(p), _t(_batch(cfg, 0)))
