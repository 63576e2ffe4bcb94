"""The port's training loss (``repro_torch.models.lm_loss``, with remat and
its gradients) against the JAX package on the CPU, at smoke size.

Weights and batches are made with numpy from fixed seeds and handed to
both packages. Numeric parity needs float32 weights (ROADMAP C11: in
bfloat16 the two frameworks round at other points, and a one-ulp
difference at a router near-tie sends a token to another expert). The JAX
package cannot run a float32 model through its ``lm_loss``: the forward
casts the embedding to bfloat16, and ``lax.scan`` refuses a carry that the
first layer promotes to float32. So the float32 reference
(:func:`_jax_lm_loss_f32`) composes the JAX package's own layer
(``transformer._apply_sub``), norm and logits exactly as its ``lm_loss``
composes them, with a Python loop over the superblocks (each under
``jax.checkpoint`` with the JAX package's remat policy) in place of the
scan; the chunked cross-entropy is ``lm_loss``'s, line for line. The JAX
package's ``lm_loss`` and ``make_train_step`` themselves are held in
float32 where no layer promotes the carry (a cut to 0 layers: the embedding,
final norm and chunked loss) and in bfloat16 at full smoke depth.
Tolerances:

* float32 loss: rtol 1e-5 (float32 sums in another order); expert loads:
  equal;
* float32 gradients: each leaf within 1e-6 + 1e-4 x its largest element;
  the embedding's and the first norm's within one bfloat16 ulp of their
  largest (2^-7 x), since their cotangents are rounded to bfloat16 (the
  forward's cast of the embedding, and the first norm's output, which keeps
  its dtype), where a float32 difference of one ulp can round to another
  bfloat16 value;
* bfloat16 against the JAX package's ``lm_loss``: loss rtol 5e-3
  (measured at most 1.3e-3 over six seeds);
* the port with remat on and off: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as jlayers
from repro.models import lm_loss as jax_lm_loss
from repro.models import transformer as jtransformer
from repro_torch.configs import smoke_config
from repro_torch.convert import load_reference_params
from repro_torch.models import layers as tlayers
from repro_torch.models import lm_loss, model_schema
from repro_torch.models.schema import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)

ARCHS = ["granite_8b", "granite_moe_3b_a800m"]
LOSS_TOL = dict(rtol=1e-5, atol=0)


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


def _batch(cfg, seed, b=4, t=24, masked=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[rng.random(labels.shape) < 0.2] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _placements(cfg, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(cfg.moe_experts)
                     for _ in range(cfg.n_layers)]).astype(np.int32)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in
            tree.items()}


def _model(arch, seed, **cut):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    if cut:
        cfg = dataclasses.replace(cfg, **cut)
        jcfg = dataclasses.replace(jcfg, **cut)
    p = _np_params(cfg, seed)
    place = _placements(cfg, seed + 1) if cfg.moe_experts else None
    return cfg, jcfg, p, place


def _live(p):
    """``p`` as port tensors that require grad."""
    return tree_map(lambda a: a.requires_grad_(),
                    load_reference_params(p, "cpu"))


#: leaves whose cotangent is rounded to bfloat16 on its way: the embedding
#: (the forward casts it) and the first superblock's norm (whose output keeps
#: the embedding's dtype): one bfloat16 ulp, 2^-7 of the leaf's largest
BF16_CAST_LEAVES = ("['embed']['tokens']",
                    "['groups']['sub0']['norm']['scale']")


def _assert_grads_close(got, want):
    for (path, g), w in zip(tree_paths(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        rel = 2.0 ** -7 if path in BF16_CAST_LEAVES else 1e-4
        atol = 1e-6 + rel * float(np.abs(w).max(initial=0))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0, atol=atol,
                                   err_msg=path)


def _jax_lm_loss_f32(params, jcfg, batch, placements=None, loss_chunks=8,
                     collect_moe=False):
    """The JAX package's ``lm_loss`` for float32 weights (see the module
    docstring): its forward with a loop over the superblocks, then its
    chunked cross-entropy."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = jlayers.embed(params["embed"], tokens).astype(jnp.bfloat16)
    b, t = tokens.shape
    positions = jnp.arange(t)
    period = jcfg.pattern_period
    n_groups = jcfg.n_layers // period
    if placements is not None:
        placements = placements.reshape(n_groups, period, -1)

    def body(h, gp, gplace):
        loads = []
        for j in range(period):
            h, _, load = jtransformer._apply_sub(
                gp[f"sub{j}"], jcfg, j, h, positions, None, 0, None,
                None if gplace is None else gplace[j], False, collect_moe)
            if load is not None:
                loads.append(load)
        return h, (jnp.stack(loads) if loads else None)

    body = jax.checkpoint(
        body, policy=jax.checkpoint_policies.dots_with_no_batch_dims_saveable)
    group_loads = []
    for g in range(n_groups):
        x, loads = body(x, jax.tree.map(lambda a: a[g], params["groups"]),
                        None if placements is None else placements[g])
        group_loads.append(loads)
    hidden = jlayers.rmsnorm(params["final_norm"], x, jcfg.norm_eps)
    chunks = min(loss_chunks, t)
    while t % chunks:
        chunks -= 1
    hid_c = hidden.reshape(b, chunks, t // chunks, -1).transpose(1, 0, 2, 3)
    lab_c = labels.reshape(b, chunks, t // chunks).transpose(1, 0, 2)

    def one(chunk):
        h, lab = chunk
        logits = jtransformer.logits_from_hidden(params, jcfg, h).astype(
            jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(
            logits, jnp.maximum(lab, 0)[..., None], axis=-1)[..., 0]
        valid = (lab >= 0).astype(jnp.float32)
        return jnp.sum((logz - gold) * valid), jnp.sum(valid)

    losses, counts = jax.lax.map(one, (hid_c, lab_c))
    loss = jnp.sum(losses) / jnp.maximum(jnp.sum(counts), 1.0)
    if collect_moe:
        return loss, jnp.stack(group_loads)
    return loss


def _place(place, to):
    return None if place is None else to(place)


# ----------------------------------------------------------------- lm_loss --
@pytest.mark.parametrize("chunks", [1, 8, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch, chunks):
    """``lm_loss`` at ``loss_chunks`` 1, 8 and 5 (T = 24: 5 is no divisor,
    so both packages take 4), labels partly masked, float32 weights; the MoE
    model under random placements with ``collect_moe``, its loads equal."""
    cfg, jcfg, p, place = _model(arch, 0)
    batch = _batch(cfg, 1)
    moe = cfg.moe_experts > 0
    kw = dict(loss_chunks=chunks, collect_moe=moe)
    want = _jax_lm_loss_f32(_jnp(p), jcfg, _jnp(batch),
                            placements=_place(place, jnp.asarray), **kw)
    got = lm_loss(load_reference_params(p, "cpu"), cfg, _t(batch),
                  placements=_place(place, torch.from_numpy), **kw)
    if moe:
        (want, wloads), (got, loads) = want, got
        assert loads.shape == (cfg.n_layers, 1, cfg.moe_experts)
        np.testing.assert_array_equal(loads.numpy(), np.asarray(wloads))
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


@pytest.mark.parametrize("chunks", [1, 8, 5])
def test_lm_loss_head_matches_jax_lm_loss(chunks):
    """The JAX package's own ``lm_loss`` in float32, cut to 0 layers (the
    embedding, the final norm and the chunked loss) with a vocab of 500
    that pads to 512 (the padded logits masked out of the log-partition):
    the loss and the embedding's and final norm's gradients."""
    cfg, jcfg, p, _ = _model("granite_8b", 2, vocab=500, n_layers=0)
    assert cfg.vocab_padded == 512
    # the scan's body is traced even over 0 groups: bfloat16 weights keep
    # its carry bfloat16 (the arrays are empty)
    p["groups"] = _np_params(cfg, 2, bf16=True)["groups"]
    batch = _batch(cfg, 3)
    want, wgrads = jax.value_and_grad(
        lambda q: jax_lm_loss(q, jcfg, _jnp(batch), loss_chunks=chunks))(
        _jnp(p))
    live = _live(p)
    got = lm_loss(live, cfg, _t(batch), loss_chunks=chunks)
    grads = torch.autograd.grad(got, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL)
    _assert_grads_close(tree_unflatten(live, grads), wgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_embed_grads_match_jax_f32(arch):
    """The embedding alone, float32, no bfloat16 cast between it and the
    loss: the table's gradient (repeated tokens summed) within 1e-6 + 1e-4
    x its largest element of ``jax.grad`` of the JAX package's
    ``layers.embed``. The model-level checks hold this leaf at one
    bfloat16 ulp (it sits behind the forward's cast), which is where the
    train step's second moment of it came to 0.66 of its tolerance."""
    cfg, _, p, _ = _model(arch, 3)
    table = p["embed"]["tokens"]
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32)
    tokens[:, :4] = 7                                 # a repeated token
    cot = rng.standard_normal(tokens.shape + (cfg.d_model,)).astype(
        np.float32)
    want = jax.grad(lambda t: jnp.sum(
        jlayers.embed({"tokens": t}, jnp.asarray(tokens)) * cot))(
            jnp.asarray(table))
    live = torch.from_numpy(table).requires_grad_()
    out = tlayers.embed({"tokens": live}, torch.from_numpy(tokens).long())
    got, = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), live)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 + 1e-4 * float(np.abs(want).max()))


def test_lm_loss_with_every_label_masked_is_zero():
    cfg, _, p, _ = _model("granite_8b", 2)
    batch = _batch(cfg, 3)
    batch["labels"][:] = -1
    assert float(lm_loss(load_reference_params(p, "cpu"), cfg,
                         _t(batch))) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_bf16_matches_jax_lm_loss(arch):
    """bfloat16 weights at full smoke depth, the JAX package's ``lm_loss``
    itself (remat on in both): the loss within rtol 5e-3; the MoE model's
    loads sum to tokens x top-k in every layer (a few routed entries may
    differ between the frameworks, C11)."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    p = _np_params(cfg, 0, bf16=True)
    batch = _batch(cfg, 10)
    moe = cfg.moe_experts > 0
    place = _placements(cfg, 1) if moe else None
    want = jax_lm_loss(_jnp(p), jcfg, _jnp(batch),
                       placements=_place(place, jnp.asarray),
                       collect_moe=moe)
    got = lm_loss(load_reference_params(p, "cpu"), cfg, _t(batch),
                  placements=_place(place, torch.from_numpy),
                  collect_moe=moe)
    if moe:
        (want, _), (got, loads) = want, got
        assert (loads.sum(-1) == batch["tokens"].size * cfg.moe_topk).all()
    np.testing.assert_allclose(float(got), float(want), rtol=5e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    """Every gradient leaf of the loss against ``jax.grad`` of the float32
    reference (remat on in both packages)."""
    cfg, jcfg, p, place = _model(arch, 4)
    batch = _batch(cfg, 5)
    want = jax.grad(lambda q: _jax_lm_loss_f32(
        q, jcfg, _jnp(batch), placements=_place(place, jnp.asarray)))(
        _jnp(p))
    live = _live(p)
    loss = lm_loss(live, cfg, _t(batch),
                   placements=_place(place, torch.from_numpy))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    _assert_grads_close(tree_unflatten(live, grads), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_identical(arch):
    """The port with and without remat: the same loss, loads and every
    gradient bit for bit (the checkpointed superblocks recompute exactly)."""
    cfg, _, p, place = _model(arch, 6)
    batch = _t(_batch(cfg, 7))
    moe = cfg.moe_experts > 0
    out = []
    for remat in (True, False):
        live = _live(p)
        res = lm_loss(live, cfg, batch, remat=remat, collect_moe=moe,
                      placements=_place(place, torch.from_numpy))
        loss = res[0] if moe else res
        out.append((res, torch.autograd.grad(loss, tree_leaves(live))))
    (a, ga), (b, gb) = out
    if moe:
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    else:
        assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
