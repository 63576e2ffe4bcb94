"""The port's serving slice (``repro_torch.models``, ``kernels.flash_attention``,
``train.make_serve_step``, ``launch.serve``) against the JAX package on the
CPU, at smoke size.

Inputs are made with numpy from a seed and weights are carried across with
``load_reference_params`` (or, for ``serve_local``, from the port's seeded
generator into JAX), so both packages see the same numbers. On the CPU the
flash wrapper runs its plain version; the JAX side runs its Pallas kernel in
interpret mode. Tolerances:

* per module, float32 inputs: 1e-5 (float32 sums in another order);
* the flash plain version against the Pallas kernel: 2e-5 in float32 and
  2e-2 in bfloat16, the JAX package's own (``tests/test_kernels.py``);
* whole serve steps, bfloat16 weights and activations: atol 0.3 and
  rtol 0.05 on logits, the JAX package's serve-path tolerance
  (``tests/test_arch_smoke.py``). The two frameworks round bfloat16
  intermediates at other places, so the logits differ by up to ~0.16 at
  these sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattention
from repro.models import init_cache as jax_init_cache
from repro.models import layers as jlayers
from repro.models import model_schema as jax_model_schema
from repro.models import schema as jschema
from repro.train.train_step import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import load_reference_params
from repro_torch.kernels import attention as ops_attention
from repro_torch.kernels import flash_attention, flash_attention_plain
from repro_torch.launch.serve import init_request, serve_local
from repro_torch.models import (attention, init_cache, layers, model_schema,
                                schema)
from repro_torch.train.train_step import make_serve_step

ARCHS = ["gemma3_12b", "qwen2_7b"]
SERVE_ATOL, SERVE_RTOL = 0.3, 0.05


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _logits(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


# ----------------------------------------------------------------- modules --
def test_rmsnorm_matches_jax(rng):
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    p = {"scale": rng.uniform(0.5, 1.5, 48).astype(np.float32)}
    want = np.asarray(jlayers.rmsnorm(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x), 1e-6))
    got = layers.rmsnorm({"scale": _t(p["scale"])}, _t(x), 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos2d", [False, True])
def test_rope_matches_jax(rng, pos2d):
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7) + 40
    if pos2d:
        pos = np.stack([pos, pos + 100])
    want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = layers.rope(_t(x), _t(pos), 1e4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mlp_matches_jax(rng):
    p = {"w_gate": rng.standard_normal((24, 40)) / 5,
         "w_up": rng.standard_normal((24, 40)) / 5,
         "w_down": rng.standard_normal((40, 24)) / 6}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 6, 24)).astype(np.float32)
    want = np.asarray(jlayers.mlp(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x)))
    got = layers.mlp({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _attn_params(arch):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    sch = jattention.attn_schema(jcfg)
    p = _f32_tree(jschema.init(sch, jax.random.PRNGKey(7)))
    if "bq" in p:                       # zeros at init: make the bias count
        r = np.random.default_rng(1)
        p = {k: (r.standard_normal(v.shape).astype(np.float32) * 0.1
                 if k.startswith("b") else v) for k, v in p.items()}
    return cfg, jcfg, p


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_flash,window", [(True, 8), (True, 0),
                                              (False, 8)])
def test_attn_cache_free_matches_jax(rng, arch, use_flash, window):
    cfg, jcfg, p = _attn_params(arch)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    pos = np.arange(20)
    jattn = jax.jit(jattention.attn, static_argnums=1,
                    static_argnames=("window", "use_flash"))
    want, _ = jattn(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                    jnp.asarray(pos), window=window, use_flash=use_flash)
    got, cache = attention.attn(load_reference_params(p, "cpu"), cfg, _t(x),
                                _t(pos), window=window, use_flash=use_flash)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_cache_branch_matches_jax(rng, arch):
    """Prefill 12 tokens into a 16-slot cache, then one decode step: the
    outputs and the cache contents match the JAX package's functional
    update."""
    cfg, jcfg, p = _attn_params(arch)
    tp = load_reference_params(p, "cpu")
    jp = jax.tree.map(jnp.asarray, p)
    flat = cfg.n_kv_heads * cfg.hd
    jcache = {"k": jnp.zeros((2, 16, flat)), "v": jnp.zeros((2, 16, flat))}
    cache = {"k": torch.zeros(2, 16, flat), "v": torch.zeros(2, 16, flat)}
    jattn = jax.jit(jattention.attn, static_argnums=1,
                    static_argnames=("window",))
    for idx, t in ((0, 12), (12, 1)):
        x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
        pos = idx + np.arange(t)
        want, jcache = jattn(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                             window=4, cache=jcache, cache_index=idx)
        got, new = attention.attn(tp, cfg, _t(x), _t(pos), window=4,
                                  cache=cache, cache_index=idx)
        assert new is cache                      # updated in place
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), rtol=1e-5,
                                       atol=1e-5)


def test_chunked_plain_attention_matches_jax(rng):
    """T x S above 2**21 scores: both packages split the queries into the
    same chunks (1500 queries -> 2 x 750)."""
    t, d = 1500, 8
    q = rng.standard_normal((1, 2, t, d)).astype(np.float32)
    k = rng.standard_normal((1, 1, t, d)).astype(np.float32)
    v = rng.standard_normal((1, 1, t, d)).astype(np.float32)
    kw = dict(causal=True, window=300, kv_valid_len=None)
    want = jattention._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v),
                                     q_positions=jnp.arange(t), **kw)
    got = attention._xla_attention(_t(q), _t(k), _t(v),
                                   q_positions=torch.arange(t), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------- flash attention --
FLASH_SHAPES = [
    (1, 2, 2, 64, 64, 32, 0),        # MHA square
    (2, 8, 2, 128, 128, 64, 0),      # GQA 4:1
    (1, 4, 1, 96, 96, 32, 0),        # MQA, ragged T
    (1, 4, 4, 1, 256, 64, 0),        # decode: one query vs KV cache
    (1, 8, 2, 17, 250, 32, 0),       # chunked decode, ragged both axes
    (1, 4, 2, 192, 192, 32, 16),     # sliding windows
    (1, 4, 2, 192, 192, 32, 64),
    (1, 4, 2, 192, 192, 32, 300),
    (1, 4, 2, 100, 100, 240, 32),    # gemma3's head dim
]


@pytest.mark.parametrize("dtype,atol", [(np.float32, 2e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,hq,hkv,t,s,d,window", FLASH_SHAPES)
def test_flash_plain_matches_pallas(b, hq, hkv, t, s, d, window, dtype,
                                    atol):
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d))]
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrs)
    want = pallas_flash(jq, jk, jv, causal=True, window=window, block_t=64,
                        block_s=64, interpret=True)
    q, k, v = (load_reference_params({"a": np.asarray(a)}, "cpu")["a"]
               for a in (jq, jk, jv))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == before      # plain version on CPU
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_logits(got), _logits(want), atol=atol)


def test_flash_fully_masked_rows_are_zero():
    """T > S: the first T - S queries sit before every key and admit none;
    the Pallas kernel gives 0 there (the jnp oracle's softmax gives NaN)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 2, 10, 8)).astype(np.float32)
    k = rng.standard_normal((1, 1, 4, 8)).astype(np.float32)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(k), block_t=64, block_s=64,
                                   interpret=True))
    got = flash_attention(_t(q), _t(k), _t(k)).numpy()
    assert np.all(got[:, :, :6] == 0) and np.all(want[:, :, :6] == 0)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_ops_attention_routes_like_jax(rng):
    """Non-causal full attention takes the plain path (no launch is counted
    on any device); everything masked takes the flash wrapper."""
    q = _t(rng.standard_normal((1, 4, 9, 8)).astype(np.float32))
    k = _t(rng.standard_normal((1, 2, 9, 8)).astype(np.float32))
    full = ops_attention(q, k, k, causal=False)
    torch.testing.assert_close(
        full, flash_attention_plain(q, k, k, causal=False), rtol=0, atol=0)
    torch.testing.assert_close(
        ops_attention(q, k, k, causal=False, window=3),
        flash_attention_plain(q, k, k, causal=False, window=3), rtol=0,
        atol=0)


def test_flash_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 3, 4, 8)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="64x64"):
        flash_attention(q, q, q, block_t=512, block_s=512)


@pytest.mark.parametrize("d", [8, 20, 240])
def test_flash_tma_ready_pads_head_dim_to_8(d):
    """The bf16 kernel reads rows by TMA, 16 bytes apart: the wrapper pads
    D with zero columns to a multiple of 8 and leaves the values alone."""
    from repro_torch.kernels.flash_attention import _tma_ready
    x = torch.from_numpy(np.random.default_rng(d).standard_normal(
        (2, 3, 5, d)).astype(np.float32)).to(torch.bfloat16)
    y = _tma_ready(x)
    assert y.shape == (2, 3, 5, -(-d // 8) * 8) and y.is_contiguous()
    assert torch.equal(y[..., :d], x) and not y[..., d:].any()
    assert y.data_ptr() % 16 == 0
    if d % 8 == 0:
        assert y is x                       # nothing to copy


def test_flash_tma_ready_copies_misaligned_storage():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        2 * 4 * 7 * 16 + 1).astype(np.float32)).to(torch.bfloat16)
    view = x[1:].view(2, 4, 7, 16)
    assert view.data_ptr() % 16 != 0
    from repro_torch.kernels.flash_attention import _tma_ready
    y = _tma_ready(view)
    assert y.data_ptr() % 16 == 0 and torch.equal(y, view)


# ------------------------------------------------------------ whole model --
def _reference_model(arch, seed):
    jcfg = jax_smoke_config(arch)
    jp = jschema.init(jax_model_schema(jcfg), jax.random.PRNGKey(seed))
    return jcfg, jp, load_reference_params(_np_tree(jp), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_free_flash_step_matches_jax(rng, arch):
    """``make_serve_step(cfg, use_flash=True)(params, None, batch, 0)``: a
    prompt longer than gemma3's 32-token smoke window, so the local layers'
    masking matters."""
    jcfg, jp, tp = _reference_model(arch, 0)
    toks = rng.integers(0, jcfg.vocab, (2, 80)).astype(np.int32)
    want, _ = jax.jit(jax_make_serve_step(jcfg, use_flash=True))(
        jp, None, {"tokens": jnp.asarray(toks)}, 0)
    got, cache = make_serve_step(smoke_config(arch), use_flash=True)(
        tp, None, {"tokens": _t(toks).long()}, 0)
    assert cache is None and got.shape == want.shape
    np.testing.assert_allclose(_logits(got), _logits(want), atol=SERVE_ATOL,
                               rtol=SERVE_RTOL)
    # the port's two attention paths agree with each other
    plain, _ = make_serve_step(smoke_config(arch))(
        tp, None, {"tokens": _t(toks).long()}, 0)
    np.testing.assert_allclose(_logits(plain), _logits(got),
                               atol=SERVE_ATOL, rtol=SERVE_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(rng, arch):
    """Prefill 40 tokens, then 8 teacher-forced decode steps through the
    KV cache, step by step against the JAX package's."""
    jcfg, jp, tp = _reference_model(arch, 2)
    cfg = smoke_config(arch)
    toks = rng.integers(0, jcfg.vocab, (2, 48)).astype(np.int32)
    jstep = jax.jit(jax_make_serve_step(jcfg))
    step = make_serve_step(cfg)
    jcache = jax_init_cache(jcfg, 2, 48)
    cache = init_cache(cfg, 2, 48, "cpu")
    for idx, t in [(0, 40)] + [(i, 1) for i in range(40, 48)]:
        chunk = toks[:, idx:idx + t]
        want, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(chunk)}, idx)
        got, cache = step(tp, cache, {"tokens": _t(chunk).long()}, idx)
        np.testing.assert_allclose(_logits(got), _logits(want),
                                   atol=SERVE_ATOL, rtol=SERVE_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_local_greedy_tokens_match_jax(arch):
    """``serve_local``'s greedy tokens against the JAX serve step driven
    through the loop of the JAX launcher's local mode
    (``src/repro/launch/serve.py:86-100``), on the same weights and prompt.

    The JAX loop is fed the port's tokens, so both decode the same sequence,
    and at every step the port's pick must be a top choice of the JAX
    logits: within 2 x atol of their max, which is what two sets of logits
    that agree within atol allow (the smoke models' top-1 margins are often
    below 0.1, where the two frameworks' bfloat16 rounding may pick either
    token)."""
    cfg = smoke_config(arch)
    batch, prompt, n_new = 2, 16, 8
    first, greedy = serve_local(cfg, batch, prompt, n_new, device="cpu",
                                generator=torch.Generator().manual_seed(3))
    assert greedy.shape == (batch, n_new) and first.shape[:2] == (batch, 1)
    params, tokens = init_request(cfg, batch, prompt, "cpu",
                                  torch.Generator().manual_seed(3))
    jcfg = jax_smoke_config(arch)
    jp = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32),
        params)
    serve_step = jax.jit(jax_make_serve_step(jcfg))
    cache = jax_init_cache(jcfg, batch, prompt + n_new)
    logits, cache = serve_step(
        jp, cache, {"tokens": jnp.asarray(tokens.numpy(), jnp.int32)}, 0)
    np.testing.assert_allclose(_logits(first), _logits(logits),
                               atol=SERVE_ATOL, rtol=SERVE_RTOL)
    idx = prompt
    for step in range(n_new):
        last = _logits(logits[:, -1])
        picked = last[np.arange(batch), greedy[:, step]]
        assert np.all(picked >= last.max(-1) - 2 * SERVE_ATOL), step
        nxt = jnp.asarray(greedy[:, step:step + 1], jnp.int32)
        logits, cache = serve_step(jp, cache, {"tokens": nxt}, idx)
        idx += 1


def test_model_schema_and_configs():
    """The full gemma3-12b schema: 12.6 B parameters (25.3 GB in bf16);
    the four archs of the recurrent layers and front ends load by either
    name, and each full schema counts the JAX package's parameters."""
    cfg = get_config("gemma3-12b")
    sch = model_schema(cfg)
    assert schema.count_params(sch) == jschema.count_params(
        jax_model_schema(jax_get_config("gemma3-12b")))
    assert 12.6e9 < schema.count_params(sch) < 12.7e9
    assert [cfg.layer_window(i) for i in range(48)].count(1024) == 40
    for name in ("jamba-1-5-large-398b", "xlstm_125m", "whisper-large-v3",
                 "internvl2_1b"):
        full = get_config(name)
        assert full == get_config(name.replace("-", "_"))
        assert smoke_config(name).name == full.name
        assert schema.count_params(model_schema(full)) == \
            jschema.count_params(jax_model_schema(jax_get_config(
                name.replace("-", "_"))))
