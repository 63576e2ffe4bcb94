"""The port's encoder-decoder and vision paths — cross-attention, the
whisper encoder (``transformer.encode``), the vision prefix, whisper-
large-v3 and internvl2-1b — against the JAX package on the CPU, at smoke
size; and the launchers, train step and weight conversion for all four
archs that came with them.

Weights and inputs are made with numpy from fixed seeds and handed to both
packages (``tests/torch_model_ref.py``). Tolerances:

* cross-attention and the encoder in float32: 1e-5 x the largest value
  (float32 sums in another order);
* the models' forward in bfloat16: atol 0.3 / rtol 0.05, the JAX
  package's serve tolerance (``tests/test_arch_smoke.py``; measured at
  most 0.24 of it); in float32 against the JAX package's layers composed
  as its forward composes them (ROADMAP C11): 2e-5 x the largest hidden
  value cache-free, 2e-3 x through the caches (the embedding and the first
  norm's output are bfloat16, where a float32 difference of one ulp can
  round to another value);
* ``lm_loss`` in float32: rtol 1e-5, gradients 1e-6 + 1e-4 x each leaf's
  largest element (2^-7 x behind a bfloat16 cast), as
  ``tests/test_torch_train.py`` holds them; in bfloat16 against the JAX
  package's own ``lm_loss``: rtol 5e-3;
* a decode step given the encoder output against the same step given the
  frames: bit for bit (the same function of the same numbers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattention
from repro.models import model_schema as jax_model_schema
from repro.models import schema as jschema
from repro.models import transformer as jtransformer
from repro_torch.configs import smoke_config
from repro_torch.convert import load_reference_params
from repro_torch.launch.serve import frontend_inputs, init_request, serve_local
from repro_torch.launch.train import frontend_batch
from repro_torch.models import (attention, init_cache, model_schema, schema,
                                transformer)
from repro_torch.train import OptConfig, make_serve_step, make_train_step
from repro_torch.train import opt_init

import torch_model_ref as ref

ARCHS = ["whisper_large_v3", "internvl2_1b"]
ALL_NEW = ["jamba_1_5_large_398b", "xlstm_125m", *ARCHS]
CAST_LEAVES = ("['embed']['tokens']", "['groups']['sub0']['norm']['scale']")
WHISPER = "whisper_large_v3"


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=0,
                               atol=rel * np.abs(want).max())


# ----------------------------------------------------------------- modules --
def test_cross_attention_matches_jax():
    """Queries from 12 decoder positions (at an offset, to show no RoPE is
    applied), keys and values from 32 encoder frames, not causal."""
    cfg, jcfg = smoke_config(WHISPER), jax_smoke_config(WHISPER)
    p = ref.np_params(attention.attn_schema(cfg, cross=True), 0)
    assert "bq" not in p
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    pos = np.arange(12) + 40
    want, wcache = jattention.attn(
        ref.to_jax(p), jcfg, jnp.asarray(x), jnp.asarray(pos), causal=False,
        kv_source=jnp.asarray(src), use_rope=False)
    tp = load_reference_params(p, "cpu")
    got, cache = attention.attn(tp, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos), causal=False,
                                kv_source=torch.from_numpy(src),
                                use_rope=False)
    assert cache is None and wcache is None
    _close(got, want, 1e-5)
    # use_flash never reaches the kernel with a kv_source, and the queries'
    # positions do not enter
    again, _ = attention.attn(tp, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos - 40), causal=False,
                              kv_source=torch.from_numpy(src),
                              use_rope=False, use_flash=True)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_encode_matches_jax():
    """The whisper encoder over 32 stub frames: sinusoidal positions, two
    non-causal layers, the final norm."""
    cfg, jcfg = smoke_config(WHISPER), jax_smoke_config(WHISPER)
    p = ref.np_params(model_schema(cfg), 2)
    frames = np.random.default_rng(3).standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    want = jtransformer.encode(ref.to_jax(p), jcfg, jnp.asarray(frames))
    got = transformer.encode(load_reference_params(p, "cpu"), cfg,
                             torch.from_numpy(frames))
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    _close(got, want, 1e-5)


# ------------------------------------------------------------------ models --
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_matches_jax(arch):
    ref.check_forward_bf16(arch, 0, atol=0.3, rtol=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_cache_match_jax_f32(arch):
    """internvl2's prefill carries the 16-token vision prefix, and its
    decode index starts past it."""
    ref.check_forward_and_cache_f32(arch, 2, rel=2e-5, cached_rel=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    ref.check_prefill_then_decode_bf16(arch, 4, atol=0.3, rtol=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax_f32(arch):
    """internvl2's loss is on the text only (the prefix dropped)."""
    ref.check_lm_loss_and_grads_f32(arch, 6, loss_rtol=1e-5, grad_rel=1e-4,
                                    cast_rel=2.0 ** -7,
                                    cast_leaves=CAST_LEAVES)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_bf16_matches_jax_lm_loss(arch):
    ref.check_lm_loss_bf16(arch, 8, rtol=5e-3)


def test_whisper_decode_with_encoder_out_equals_decode_with_frames():
    """A prefill and 4 decode steps fed ``encoder_out`` (encoded once)
    against the same steps fed ``frames`` (re-encoded each step, as the
    JAX launcher does): bit for bit."""
    cfg, _, _, tp = ref._model(WHISPER, 10, bf16=True)
    batch = ref.to_torch(ref.np_batch(cfg, 11, t=12))
    step = make_serve_step(cfg)
    with torch.inference_mode():
        enc = transformer.encode(tp, cfg, batch["frames"])
    runs = []
    for front in ({"frames": batch["frames"]}, {"encoder_out": enc}):
        cache = init_cache(cfg, 2, 12, "cpu")
        logits, cache = step(tp, cache, {"tokens": batch["tokens"][:, :8],
                                         **front}, 0)
        out = [logits]
        for i in range(8, 12):
            nxt = {"tokens": batch["tokens"][:, i:i + 1], **front}
            logits, cache = step(tp, cache, nxt, i)
            out.append(logits)
        runs.append(torch.cat(out, 1))
    torch.testing.assert_close(runs[1], runs[0], rtol=0, atol=0)


# ---------------------------------------------------- launchers and steps --
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_local_takes_the_front_end(arch):
    """``serve_local``'s first logits equal the cache-free step's last
    position on the same weights, prompt and front-end input (drawn from
    the same generator), within the serve tolerance; then its greedy
    decode runs past the vision prefix."""
    cfg = smoke_config(arch)
    first, greedy = serve_local(cfg, 2, 12, 4, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    assert greedy.shape == (2, 4) and first.shape == (2, 1,
                                                      cfg.vocab_padded)
    gen = torch.Generator().manual_seed(3)
    params, tokens = init_request(cfg, 2, 12, "cpu", gen)
    front = frontend_inputs(cfg, 2, "cpu", gen)
    assert set(front) == {"frames" if arch == WHISPER else "pixel_embeds"}
    want, _ = make_serve_step(cfg)(params, None, {"tokens": tokens, **front},
                                   0)
    np.testing.assert_allclose(first.float().numpy(), want.float().numpy(),
                               atol=0.3, rtol=0.05)


@pytest.mark.parametrize("arch", ALL_NEW)
def test_train_step_takes_the_new_layer_kinds(arch):
    """One AdamW step of each new arch from the launcher's batch (the
    keyed pipeline's tokens and the JAX launcher's stub front-end input):
    two microbatches give the loss of one batch (float32 weights, within
    1e-5), finite gradients, and every weight moves."""
    cfg = smoke_config(arch)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, (4, 17))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             **frontend_batch(cfg, 4, 0)}
    batch = {k: v.float() if v.is_floating_point() else v
             for k, v in batch.items()}
    p = load_reference_params(ref.np_params(model_schema(cfg), 13), "cpu")
    losses = []
    for micro in (1, 2):
        params = schema.tree_map(torch.clone, p)
        state = opt_init(params)
        params, state, metrics = make_train_step(
            cfg, OptConfig(), microbatches=micro)(params, state, batch)
        assert bool(torch.isfinite(metrics["grad_norm"]))
        losses.append(float(metrics["loss"]))
        moved = [bool((a != b).any()) for a, b in
                 zip(schema.tree_leaves(params), schema.tree_leaves(p))]
        assert all(moved), arch
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


@pytest.mark.parametrize("arch", ALL_NEW)
def test_load_reference_params_converts_a_whole_tree(arch):
    """One call carries a JAX parameter tree of each new arch across:
    every leaf bit for bit in its dtype (the float32 leaves stay float32),
    the encoder tree included; the count equals the port's schema's."""
    jcfg = jax_smoke_config(arch)
    jp = jschema.init(jax_model_schema(jcfg), jax.random.PRNGKey(0))
    tp = load_reference_params(jax.tree.map(np.asarray, jp), "cpu")
    leaves = jax.tree.leaves(jp)
    got = schema.tree_leaves(tp)
    assert len(got) == len(leaves)
    for g, w in zip(got, leaves):
        assert str(g.dtype) == f"torch.{w.dtype.name}"
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    assert ("encoder" in tp) == (arch == WHISPER)
    assert sum(t.numel() for t in got) == schema.count_params(
        model_schema(smoke_config(arch)))
