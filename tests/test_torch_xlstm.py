"""The port's sLSTM and mLSTM layers (``repro_torch.models.xlstm``) and
xlstm-125m against the JAX package on the CPU, at smoke size.

Weights and inputs are made with numpy from fixed seeds and handed to both
packages (``tests/torch_model_ref.py``). Tolerances:

* the layers in float32: 1e-5 x the largest value (float32 sums in another
  order, through exponential gates);
* the layers in bfloat16: one bfloat16 ulp at the largest output (2^-7 x);
* the model's forward in bfloat16: atol 0.3 / rtol 0.05, the JAX
  package's serve tolerance (``tests/test_arch_smoke.py``); in float32
  against the JAX package's layers composed as its forward composes them
  (ROADMAP C11): 2e-5 x the largest hidden value cache-free, 2e-3 x
  through the caches (the embedding and the first norm's output are
  bfloat16, where a float32 difference of one ulp can round to another
  value);
* ``lm_loss`` in float32: rtol 1e-5, gradients 1e-6 + 1e-4 x each leaf's
  largest element (2^-7 x behind a bfloat16 cast: ``CAST_LEAVES``), as
  ``tests/test_torch_train.py`` holds them; in bfloat16 against the JAX
  package's own ``lm_loss``: rtol 5e-3;
* one cell alone in float32, no cast in the way: every parameter's and
  the input's gradient within 1e-6 + 1e-4 x each leaf's largest element.

The JAX package's quirks are kept: a cache starts the sLSTM's stabilizer
at 0 (its ``cache_schema``'s zeros), a cache-free call at -1e30; the
mLSTM's gates are shared across heads.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import xlstm as jxlstm
from repro_torch.configs import smoke_config
from repro_torch.convert import load_reference_params
from repro_torch.models import xlstm as txlstm

import torch_model_ref as ref

ARCH = "xlstm_125m"
# the leaves whose cotangents pass a bfloat16 cast: the embedding and the
# first norm, and group 0's mLSTM projections, which reach the loss through
# the cast of the cell's output to its input's dtype (``xlstm.py``'s
# ``.to(x.dtype)``), bfloat16 in sub-layer 0 (it takes the bf16 embedding);
# the cell alone is held at 1e-4 by the ``*_grads_match_jax_f32`` tests
CAST_LEAVES = ("['embed']['tokens']", "['groups']['sub0']['norm']['scale']",
               "['groups']['sub0']['cell']['wq']",
               "['groups']['sub0']['cell']['wk']",
               "['groups']['sub0']['cell']['wv']",
               "['groups']['sub0']['cell']['w_if']",
               "['groups']['sub0']['cell']['b_if']")


def _layer(kind, seed, bf16=False):
    cfg, jcfg = smoke_config(ARCH), jax_smoke_config(ARCH)
    p = ref.np_params(getattr(txlstm, f"{kind}_schema")(cfg), seed,
                      bf16=bf16)
    r = np.random.default_rng(seed + 100)
    for name in [k for k in p if k.startswith("b_")]:   # zeros at init
        p[name] = (r.standard_normal(p[name].shape) * 0.5).astype(
            p[name].dtype)
    return cfg, jcfg, p


def _x(cfg, seed, t, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (2, t, cfg.d_model)).astype(dtype)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got.float()), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _state(cfg, kind, b=2):
    """A cache's zero state for one layer, both packages' layout."""
    d = cfg.d_model
    h, dh = cfg.n_heads, d // cfg.n_heads
    if kind == "slstm":
        shapes = {k: (b, d) for k in ("c", "n", "m", "h")}
    else:
        shapes = {"C": (b, h, dh, dh), "n": (b, h, dh), "m": (b, 1)}
    return {k: np.zeros(s, np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("cached", [False, True],
                         ids=["state_none", "cache_zeros"])
def test_slstm_matches_jax(cached):
    """From ``state=None`` (stabilizer -1e30) and from a cache's zeros
    (stabilizer 0): the output and every state entry."""
    cfg, jcfg, p = _layer("slstm", 0)
    x = _x(cfg, 1, 20)
    st = _state(cfg, "slstm") if cached else None
    want, wstate = jxlstm.slstm(
        ref.to_jax(p), jcfg, jnp.asarray(x),
        state=None if st is None else ref.to_jax(st))
    got, state = txlstm.slstm(
        load_reference_params(p, "cpu"), cfg, torch.from_numpy(x),
        state=None if st is None else load_reference_params(st, "cpu"))
    _close(got, want, 1e-5)
    for name in ("c", "n", "m", "h"):
        _close(state[name], wstate[name], 1e-5)


@pytest.mark.parametrize("chunk", [8, 128])
def test_mlstm_matches_jax(chunk):
    """Chunks of 8 (five chunks of a 40-token input) and 128 (one chunk of
    40), from ``state=None``, then 8 more tokens from the returned state."""
    cfg, jcfg, p = _layer("mlstm", 2)
    x = _x(cfg, 3, 48)
    jp, tp = ref.to_jax(p), load_reference_params(p, "cpu")
    want, wstate = jxlstm.mlstm(jp, jcfg, jnp.asarray(x[:, :40]),
                                chunk=chunk)
    got, state = txlstm.mlstm(tp, cfg, torch.from_numpy(x[:, :40]),
                              chunk=chunk)
    _close(got, want, 1e-5)
    want, wstate = jxlstm.mlstm(jp, jcfg, jnp.asarray(x[:, 40:]),
                                state=wstate, chunk=chunk)
    got, state = txlstm.mlstm(tp, cfg, torch.from_numpy(x[:, 40:]),
                              state=state, chunk=chunk)
    _close(got, want, 1e-5)
    for name in ("C", "n", "m"):
        _close(state[name], wstate[name], 1e-5)


def test_mlstm_output_does_not_depend_on_the_chunking():
    """The port alone, float32: chunks of 4, 16 and 64 over 64 tokens give
    one output (the ``exp(-m)`` floor makes it chunking-invariant)."""
    cfg, _, p = _layer("mlstm", 4)
    tp = load_reference_params(p, "cpu")
    x = torch.from_numpy(_x(cfg, 5, 64))
    outs = [txlstm.mlstm(tp, cfg, x, chunk=c)[0] for c in (4, 16, 64)]
    for out in outs[1:]:
        _close(out, outs[0].numpy(), 1e-5)


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_cells_bf16_match_jax_within_an_ulp(kind):
    cfg, jcfg, p = _layer(kind, 6, bf16=True)
    x = _x(cfg, 7, 24, ml_dtypes.bfloat16)
    want, _ = getattr(jxlstm, kind)(ref.to_jax(p), jcfg, jnp.asarray(x))
    got, _ = getattr(txlstm, kind)(load_reference_params(p, "cpu"), cfg,
                                   ref.to_torch({"x": x})["x"])
    assert got.dtype == torch.bfloat16
    _close(got, want, 2.0 ** -7)


def _cell_grads(kind, cfg, jcfg, p, x, **kw):
    """(port gradients, JAX gradients) of the sum of a cell's output times
    a fixed random cotangent, for every parameter and the input: float32
    throughout, so no bfloat16 cast lies on the path."""
    import jax
    cot = np.random.default_rng(11).standard_normal(x.shape).astype(
        np.float32)
    jfn = getattr(jxlstm, kind)

    def jloss(jp, jx):
        out, _ = jfn(jp, jcfg, jx, **kw)
        return jnp.sum(out * cot)

    wp, wx = jax.grad(jloss, argnums=(0, 1))(ref.to_jax(p), jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in
          load_reference_params(p, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = getattr(txlstm, kind)(tp, cfg, tx, **kw)
    names = sorted(tp)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)),
                              [tp[k] for k in names] + [tx])
    return (dict(zip(names + ["x"], got)),
            {**{k: wp[k] for k in names}, "x": wx})


def _grads_close(got, want):
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            got[name].numpy(), w, rtol=0,
            atol=1e-6 + 1e-4 * float(np.abs(w).max(initial=0)),
            err_msg=name)


@pytest.mark.parametrize("chunk", [8, 128])
def test_mlstm_grads_match_jax_f32(chunk):
    """One mLSTM cell alone, float32 input (no bfloat16 cast between it and
    the loss): gradients of every parameter (nonzero ``b_if``) and of the
    input within 1e-6 + 1e-4 x each leaf's largest element of
    ``jax.grad``, at chunks of 8 and 128 over 40 tokens."""
    cfg, jcfg, p = _layer("mlstm", 2)
    got, want = _cell_grads("mlstm", cfg, jcfg, p, _x(cfg, 3, 40),
                            chunk=chunk)
    _grads_close(got, want)


def test_slstm_grads_match_jax_f32():
    """One sLSTM cell alone, float32 input, nonzero biases: as the mLSTM's
    test, over 20 tokens from ``state=None``."""
    cfg, jcfg, p = _layer("slstm", 0)
    got, want = _cell_grads("slstm", cfg, jcfg, p, _x(cfg, 1, 20))
    _grads_close(got, want)


def test_xlstm_forward_bf16_matches_jax():
    ref.check_forward_bf16(ARCH, 0, atol=0.3, rtol=0.05)


def test_xlstm_forward_and_cache_match_jax_f32():
    ref.check_forward_and_cache_f32(ARCH, 2, rel=2e-5, cached_rel=2e-3)


def test_xlstm_prefill_then_decode_matches_full_forward():
    ref.check_prefill_then_decode_bf16(ARCH, 4, atol=0.3, rtol=0.05)


def test_xlstm_lm_loss_and_grads_match_jax_f32():
    ref.check_lm_loss_and_grads_f32(ARCH, 6, loss_rtol=1e-5, grad_rel=1e-4,
                                    cast_rel=2.0 ** -7,
                                    cast_leaves=CAST_LEAVES)


def test_xlstm_lm_loss_bf16_matches_jax_lm_loss():
    ref.check_lm_loss_bf16(ARCH, 8, rtol=5e-3)
