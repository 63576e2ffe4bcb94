"""Helpers shared by the port's model parity tests (not a test module).

* :func:`np_params` — weights for a schema from a numpy seed: normal at
  1/sqrt(fan-in) of the contracting dim (so the smoke models are not
  chaotic, ROADMAP C6), the spec's own scale where it has one, ones and
  zeros where it says; float32, or bfloat16 for the bfloat16 specs.
* :func:`jax_forward_f32` / :func:`jax_lm_loss_f32` — the JAX package's
  ``forward`` and ``lm_loss`` for float32 weights. Its forward casts the
  embedding to bfloat16 and ``lax.scan`` refuses a carry that the first
  layer promotes to float32 (ROADMAP C11), so these compose its own
  ``transformer._apply_sub``, ``encode``, norm and logits exactly as its
  ``forward`` and ``lm_loss`` do, with a Python loop over the superblocks in
  place of the scan.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.models import layers as jlayers
from repro.models.schema import ParamSpec as JaxParamSpec
from repro.models import transformer as jtransformer
from repro_torch.models.schema import tree_map


def np_params(schema, seed: int, bf16: bool = False):
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

    return tree_map(make, schema)


def np_batch(cfg, seed: int, b: int = 2, t: int = 24, bf16: bool = True,
             labels: bool = False):
    """Tokens (and next-token labels, 20% masked) and the arch's front-end
    input: ``frames`` (B, encoder_seq, D) or ``pixel_embeds``
    (B, prefix_len, D), standard normal, bfloat16 or float32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1]}
    if labels:
        lab = toks[:, 1:].copy()
        lab[rng.random(lab.shape) < 0.2] = -1
        batch["labels"] = lab
    dt = ml_dtypes.bfloat16 if bf16 else np.float32
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(dt)
    elif cfg.frontend == "vision_stub":
        batch["pixel_embeds"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(dt)
    return batch


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(batch):
    """A numpy batch as port tensors: integer arrays as int64, bfloat16
    arrays as bfloat16 (same bits), float32 as float32."""
    out = {}
    for k, v in batch.items():
        if v.dtype == ml_dtypes.bfloat16:
            out[k] = torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        elif np.issubdtype(v.dtype, np.integer):
            out[k] = torch.from_numpy(v).long()
        else:
            out[k] = torch.from_numpy(v)
    return out


def jax_f32_cache(cache_schema):
    """A JAX cache of float32 zeros for a float32 model (the JAX package's
    ``init_cache`` gives its K/V and conv planes in bfloat16, which
    ``dynamic_update_slice`` refuses to take float32 values into)."""
    return jax.tree.map(lambda s: jnp.zeros(s.shape, jnp.float32),
                        cache_schema,
                        is_leaf=lambda s: isinstance(s, JaxParamSpec))


def jax_forward_f32(params, jcfg, batch, cache=None, cache_index=0):
    """The JAX package's ``forward`` (see the module docstring); returns
    (hidden, cache), the cache updated per sub-layer as its scan would."""
    x = jlayers.embed(params["embed"], batch["tokens"]).astype(jnp.bfloat16)
    enc = batch.get("encoder_out")
    if enc is None and jcfg.frontend == "audio_stub" and "frames" in batch:
        enc = jtransformer.encode(params, jcfg, batch["frames"])
    elif jcfg.frontend == "vision_stub" and "pixel_embeds" in batch:
        x = jnp.concatenate([batch["pixel_embeds"].astype(x.dtype), x], 1)
    positions = cache_index + jnp.arange(x.shape[1])
    period = jcfg.pattern_period
    for g in range(jcfg.n_layers // period):
        gp = jax.tree.map(lambda a: a[g], params["groups"])
        for j in range(period):
            name = f"sub{j}"
            sub = (None if cache is None
                   else jax.tree.map(lambda a: a[g], cache[name]))
            x, new, _ = jtransformer._apply_sub(
                gp[name], jcfg, j, x, positions, sub, cache_index, enc, None,
                False)
            if cache is not None:
                cache[name] = jax.tree.map(lambda a, n: a.at[g].set(n),
                                           cache[name], new)
    return jlayers.rmsnorm(params["final_norm"], x, jcfg.norm_eps), cache


def jax_lm_loss_f32(params, jcfg, batch, loss_chunks: int = 8):
    """The JAX package's ``lm_loss`` over :func:`jax_forward_f32`: the
    vision prefix dropped, then its chunked cross-entropy line for line."""
    hidden, _ = jax_forward_f32(params, jcfg, batch)
    labels = batch["labels"]
    if jcfg.frontend == "vision_stub" and "pixel_embeds" in batch:
        hidden = hidden[:, batch["pixel_embeds"].shape[1]:]
    b, t, _ = hidden.shape
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
    return jnp.sum(losses) / jnp.maximum(jnp.sum(counts), 1.0)


# --------------------------------------------------- whole-model checks --
# Each takes an arch of the port's registry and holds the port against the
# JAX package at smoke size; the calling test file states the tolerances.

def _model(arch, seed, bf16=False, **cut):
    import dataclasses
    from repro.configs import smoke_config as jax_smoke_config
    from repro_torch.configs import smoke_config
    from repro_torch.convert import load_reference_params
    from repro_torch.models import model_schema
    cfg = dataclasses.replace(smoke_config(arch), **cut)
    jcfg = dataclasses.replace(jax_smoke_config(arch), **cut)
    p = np_params(model_schema(cfg), seed, bf16=bf16)
    return cfg, jcfg, p, load_reference_params(p, "cpu")


def prefix_of(cfg) -> int:
    return cfg.prefix_len if cfg.frontend == "vision_stub" else 0


def check_forward_bf16(arch, seed, atol, rtol):
    """bfloat16 weights and inputs: the port's ``forward`` + logits against
    the JAX package's own ``forward`` + logits."""
    from repro.models import forward as jax_forward
    from repro.models import logits_from_hidden as jax_logits
    from repro_torch.models import forward, logits_from_hidden
    cfg, jcfg, p, tp = _model(arch, seed, bf16=True)
    batch = np_batch(cfg, seed + 1, t=32)
    jp = to_jax(p)
    hidden, _ = jax_forward(jp, jcfg, to_jax(batch), remat=False)
    want = np.asarray(jax_logits(jp, jcfg, hidden), np.float32)
    with torch.no_grad():
        hidden, _ = forward(tp, cfg, to_torch(batch), remat=False)
        got = logits_from_hidden(tp, cfg, hidden).float().numpy()
    assert got.shape == want.shape == (2, 32 + prefix_of(cfg),
                                       cfg.vocab_padded)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def check_forward_and_cache_f32(arch, seed, rel, cached_rel):
    """float32 weights: the cache-free forward against
    :func:`jax_forward_f32` within ``rel`` x its largest value; then a
    prefill of 16 tokens and 8 decode steps through float32 caches, each
    step's hidden state within ``cached_rel`` x the largest."""
    from repro.models import cache_schema as jax_cache_schema
    from repro_torch.models import cache_schema, forward
    cfg, jcfg, p, tp = _model(arch, seed)
    batch = np_batch(cfg, seed + 1, bf16=False)
    jp = to_jax(p)
    want, _ = jax_forward_f32(jp, jcfg, to_jax(batch))
    with torch.no_grad():
        got, _ = forward(tp, cfg, to_torch(batch))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())
    t, pre = batch["tokens"].shape[1], 16
    seq = t + prefix_of(cfg)
    jcache = jax_f32_cache(jax_cache_schema(jcfg, 2, seq))
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=torch.float32),
                     cache_schema(cfg, 2, seq))
    step = dict(batch, tokens=batch["tokens"][:, :pre])
    idx = 0
    for i in range(pre, t + 1):
        want, jcache = jax_forward_f32(jp, jcfg, to_jax(step), jcache, idx)
        with torch.no_grad():
            got, cache = forward(tp, cfg, to_torch(step), cache, idx)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=cached_rel * np.abs(want).max(),
                                   err_msg=f"position {i}")
        idx += step["tokens"].shape[1] + (prefix_of(cfg) if i == pre else 0)
        step = {k: v for k, v in batch.items() if k != "pixel_embeds"}
        step["tokens"] = batch["tokens"][:, i:i + 1]


def check_prefill_then_decode_bf16(arch, seed, atol, rtol, **cut):
    """The port alone, bfloat16, as the JAX package's
    ``test_prefill_then_decode_matches_full_forward``: teacher-forced decode
    through the cache after a prefill of half the prompt reproduces the
    cache-free forward's logits. ``cut`` replaces config fields."""
    from repro_torch.models import forward, init_cache, logits_from_hidden
    cfg, _, _, tp = _model(arch, seed, bf16=True, **cut)
    batch = to_torch(np_batch(cfg, seed + 1, t=32))
    tokens = batch["tokens"]
    prefix = prefix_of(cfg)
    with torch.inference_mode():
        hidden, _ = forward(tp, cfg, batch, remat=False)
        full = logits_from_hidden(tp, cfg, hidden)
        cache = init_cache(cfg, 2, 32 + prefix, "cpu")
        hidden, cache = forward(tp, cfg, dict(batch, tokens=tokens[:, :16]),
                                cache=cache, cache_index=0)
        logits = [logits_from_hidden(tp, cfg, hidden)]
        step = {k: v for k, v in batch.items() if k != "pixel_embeds"}
        for i in range(16, 32):
            step["tokens"] = tokens[:, i:i + 1]
            hidden, cache = forward(tp, cfg, step, cache=cache,
                                    cache_index=prefix + i)
            logits.append(logits_from_hidden(tp, cfg, hidden))
    np.testing.assert_allclose(torch.cat(logits, 1).float().numpy(),
                               full.float().numpy(), atol=atol, rtol=rtol)


def check_lm_loss_and_grads_f32(arch, seed, loss_rtol, grad_rel,
                                cast_rel, cast_leaves):
    """float32 weights: ``lm_loss`` within ``loss_rtol`` of
    :func:`jax_lm_loss_f32` and every gradient leaf within
    1e-6 + ``grad_rel`` x its largest element of ``jax.grad`` of it
    (``cast_rel`` for ``cast_leaves``, whose cotangents pass a bfloat16
    cast)."""
    from repro_torch.convert import load_reference_params
    from repro_torch.models import lm_loss
    from repro_torch.models.schema import (tree_leaves, tree_paths,
                                           tree_unflatten)
    cfg, jcfg, p, _ = _model(arch, seed)
    batch = np_batch(cfg, seed + 1, bf16=False, labels=True)
    want, wgrads = jax.value_and_grad(
        lambda q: jax_lm_loss_f32(q, jcfg, to_jax(batch)))(to_jax(p))
    live = tree_map(lambda a: a.requires_grad_(),
                    load_reference_params(p, "cpu"))
    loss = lm_loss(live, cfg, to_torch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=loss_rtol)
    for (path, g), w in zip(tree_paths(tree_unflatten(live, grads)),
                            jax.tree.leaves(wgrads)):
        w = np.asarray(w, np.float32)
        rel = cast_rel if path in cast_leaves else grad_rel
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=1e-6 + rel * float(np.abs(w).max(initial=0)), err_msg=path)


def check_lm_loss_bf16(arch, seed, rtol):
    """bfloat16 weights: ``lm_loss`` against the JAX package's own
    ``lm_loss`` (its scan, its remat)."""
    from repro.models import lm_loss as jax_lm_loss
    from repro_torch.models import lm_loss
    cfg, jcfg, p, tp = _model(arch, seed, bf16=True)
    batch = np_batch(cfg, seed + 1, labels=True)
    want = jax_lm_loss(to_jax(p), jcfg, to_jax(batch))
    with torch.no_grad():
        got = lm_loss(tp, cfg, to_torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
