"""The port's ``REPRO_PERF_*`` paths (``repro_torch.flags``) against the JAX
package's and against the port's own unflagged paths, on the CPU.

* grouped MoE dispatch (``MOE_GROUPED``): the port's layer in G = 2 and 4
  groups equals the JAX package's layer run without the flag on each
  group's contiguous token slice, concatenated (float32, rtol and atol
  1e-5, the MoE parity tests' tolerance), with the loads and drops summed
  over the groups (equal), including an expert that overflows in one
  group only;
* the JAX package is never traced with a flag set in this process: every
  JAX call under a flag runs in a subprocess (``_jax_subprocess``), so the
  jit caches of the other tests stay clean;
* ``WINDOW_SLICE``: the sliced plain attention equals the unsliced path and
  the JAX package's ``_xla_attention`` without the flag (float32, rtol and
  atol 1e-5) at shapes where the band applies (window + chunk < S);
* ``BF16_LOSS``: the logits are the unflagged logits rounded to bfloat16
  (equal), and the port's ``lm_loss`` matches the JAX package's with the
  flag (bfloat16 weights, rtol 5e-3, ROADMAP C11);
* ``BF16_ACCUM``: the flagged step is the step with bfloat16 accumulators
  (equal);
* with no mesh, ``MOE_GROUPED``, ``DECODE_WS``, ``ATTN_SHARD`` and
  ``DEFER_GRAD_SYNC`` change nothing (equal);
* on (2, 2) and (2, 1) gloo meshes (``tests/torch_mesh_worker.py``, spawned
  ranks, a ``FileStore``, timeouts): the flagged serve and train steps
  against the unsharded port with the same flags and the mesh's group
  count (float32 logits and caches within 1e-4 x the largest element; the
  loss rtol 1e-5; the grad norm rtol 1e-4, or 2^-8 with bfloat16
  accumulators; the masters within 2.5 lr, ROADMAP C6); each data rank
  routes only its N / G tokens; a ``DECODE_WS`` decode step gathers no
  layer weight over "data"; ``DEFER_GRAD_SYNC`` reduces the gradients once
  a step (``CommDebugMode``);
* the launchers set the JAX launchers' flags for their run and take
  ``--no-perf-flags``; the deprecated ``ALGORITHMS`` view.

Fixed seeds, no global state (the flags are set with ``monkeypatch`` and
only around port calls), no JAX stage settings of ROADMAP C8.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as jattention
from repro.models import moe as jmoe
from repro_torch import flags
from repro_torch.configs import smoke_config
from repro_torch.convert import load_reference_params
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattention
from repro_torch.models import lm_loss, logits_from_hidden, model_schema, moe
from repro_torch.models.schema import tree_leaves, tree_map
from repro_torch.train import OptConfig, make_train_step, opt_init
from repro_torch.train.train_step import make_serve_step

import torch_mesh_worker as worker

TOL = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ["granite_moe_3b_a800m", "dbrx_132b"]


def _np_params(cfg, seed, bf16=False):
    """Weights for the port's schema of ``cfg`` from a numpy seed (the
    parity tests' rule), float32, or bfloat16 for the bfloat16 specs when
    ``bf16``."""
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


def _set(monkeypatch, *names):
    for name in flags.NAMES:
        monkeypatch.delenv(f"REPRO_PERF_{name}", raising=False)
    for name in names:
        monkeypatch.setenv(f"REPRO_PERF_{name}", "1")


def _jax_subprocess(tmp_path, code: str, names, inputs: dict):
    """Run ``code`` in a fresh interpreter with the flags ``names`` set,
    ``inputs`` (pickled) bound as ``inputs``; returns what it assigns to
    ``result`` (pickled back)."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_PERF_")}
    env.update({f"REPRO_PERF_{n}": "1" for n in names})
    env["PYTHONPATH"] = os.pathsep.join(
        [str(src), str(Path(__file__).parent)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env.setdefault("JAX_PLATFORMS", "cpu")
    src_in, src_out = str(tmp_path / "in.pkl"), str(tmp_path / "out.pkl")
    Path(src_in).write_bytes(pickle.dumps(inputs))
    script = (f"import pickle\ninputs = pickle.load(open({src_in!r}, "
              f"'rb'))\n{code}\npickle.dump(result, open({src_out!r}, "
              f"'wb'))\n")
    run = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return pickle.loads(Path(src_out).read_bytes())


# ------------------------------------------------------------------ flags --
def test_flags_are_on_only_at_exactly_one(monkeypatch):
    _set(monkeypatch)
    assert not any(flags.enabled(n) for n in flags.NAMES)
    for value, on in (("1", True), ("0", False), ("true", False),
                      ("", False)):
        monkeypatch.setenv("REPRO_PERF_MOE_GROUPED", value)
        assert flags.enabled("MOE_GROUPED") is on
    with pytest.raises(KeyError):
        flags.enabled("MOE")


def test_launcher_defaults_match_the_jax_launchers(tmp_path):
    """The train launcher's flags per arch equal what the JAX launcher's
    ``_apply_perf_flags`` sets (run in a subprocess: it writes the
    environment); the serve launcher's are the JAX launcher's two."""
    from repro_torch.configs import ARCHS
    code = ("import os\nfrom repro.launch.train import _apply_perf_flags\n"
            "result = {}\n"
            "for arch in inputs:\n"
            "    for k in [k for k in os.environ if "
            "k.startswith('REPRO_PERF_')]:\n"
            "        del os.environ[k]\n"
            "    _apply_perf_flags(arch, True)\n"
            "    result[arch] = sorted(k[len('REPRO_PERF_'):] for k in "
            "os.environ if k.startswith('REPRO_PERF_'))\n")
    want = _jax_subprocess(tmp_path, code, (), list(ARCHS))
    for arch in ARCHS:
        assert sorted(flags.launcher_defaults("train", arch)) == want[arch]
    assert flags.launcher_defaults("serve", "qwen2_7b") == \
        ("DECODE_WS", "MOE_GROUPED")


@pytest.mark.parametrize("launcher,module", [("serve", launch_serve),
                                             ("train", launch_train)])
def test_launchers_set_their_flags_for_the_run(launcher, module,
                                               monkeypatch):
    """``main`` sets the JAX launcher's flags around its run (a flag set
    to "0" beforehand stays "0"), none with ``--no-perf-flags``, and
    leaves the environment as it found it."""
    _set(monkeypatch)
    monkeypatch.setenv("REPRO_PERF_DECODE_WS", "0")
    seen = []
    monkeypatch.setattr(module, "_run", lambda args: seen.append(
        {n for n in flags.NAMES if flags.enabled(n)}))
    arch = "granite-moe-3b-a800m"
    module.main(["--arch", arch])
    module.main(["--arch", arch, "--no-perf-flags"])
    want = set(flags.launcher_defaults(launcher, arch.replace("-", "_")))
    assert seen == [want - {"DECODE_WS"}, set()]
    assert os.environ["REPRO_PERF_DECODE_WS"] == "0"
    assert not any(flags.enabled(n) for n in flags.NAMES)


# --------------------------------------------------------------- grouped --
def _layer_moe(tree, g):
    return {k: v[g] for k, v in tree["groups"]["sub0"]["moe"].items()}


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grouped_moe_matches_jax_per_group(arch, groups):
    """G groups of the port's layer = the JAX layer (no flag) on each
    group's N / G contiguous tokens; loads and drops summed. At this seed
    an expert overflows in one group and not in another."""
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    rng = np.random.default_rng(4)
    p = _layer_moe(_np_params(cfg, 5), 0)
    x = rng.standard_normal((4, 24, cfg.d_model)).astype(np.float32)
    place = rng.permutation(cfg.moe_experts).astype(np.int32)
    ng = x.shape[0] * x.shape[1] // groups
    outs, loads, dropped = [], [], 0
    for xg in x.reshape(groups, 1, ng, -1):
        out, stats = jmoe.moe(jax_tree(p), jcfg, jnp.asarray(xg),
                              jnp.asarray(place), return_stats=True)
        outs.append(np.asarray(out)[0])
        loads.append(np.asarray(stats["expert_load"]))
        dropped += int(stats["dropped"])
    with moe.fixed_groups(groups):
        got, stats = moe.moe(load_reference_params(p, "cpu"), cfg,
                             torch.from_numpy(x), torch.from_numpy(place),
                             return_stats=True)
    np.testing.assert_allclose(got.numpy(),
                               np.concatenate(outs).reshape(x.shape), **TOL)
    np.testing.assert_array_equal(stats["expert_load"].numpy(),
                                  np.sum(loads, 0))
    assert int(stats["dropped"]) == dropped > 0
    over = np.stack(loads) > moe.capacity_for(ng, cfg)
    assert ((over.sum(0) > 0) & (over.sum(0) < groups)).any()


def jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_grouped_dispatch_counts_the_mesh_data_ranks(monkeypatch):
    """G is 1 without the flag or without a mesh; ``fixed_groups`` sets it
    where it divides the token count."""
    _set(monkeypatch, "MOE_GROUPED")
    assert moe._dispatch_groups(64) == 1
    with moe.fixed_groups(4):
        assert moe._dispatch_groups(64) == 4
        assert moe._dispatch_groups(66) == 1
    assert moe._dispatch_groups(64) == 1


# ------------------------------------------------------ no mesh, no change --
def _serve_and_train(cfg, seed):
    p = load_reference_params(_np_params(cfg, seed), "cpu")
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (4, 9), generator=g)
    place = None
    if cfg.moe_experts:
        place = torch.stack([torch.randperm(cfg.moe_experts, generator=g)
                             for _ in range(cfg.n_layers)])
    free, _ = make_serve_step(cfg)(p, None, {"tokens": toks[:, :-1]}, 0,
                                   place)
    step = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=0,
                                          total_steps=4), microbatches=2)
    params = tree_map(lambda a: a.clone(), p)
    _, state, metrics = step(params, opt_init(params),
                             {"tokens": toks[:, :-1],
                              "labels": toks[:, 1:]}, place)
    return [free] + tree_leaves(params) + tree_leaves(state["master"]) + [
        metrics["loss"], metrics["grad_norm"]]


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "gemma3_12b"])
def test_mesh_flags_change_nothing_without_a_mesh(arch, monkeypatch):
    cfg = dataclasses.replace(smoke_config(arch), n_layers=smoke_config(
        arch).pattern_period)
    _set(monkeypatch)
    want = _serve_and_train(cfg, 3)
    _set(monkeypatch, "MOE_GROUPED", "DECODE_WS", "ATTN_SHARD",
         "DEFER_GRAD_SYNC")
    got = _serve_and_train(cfg, 3)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


# ---------------------------------------------------------- window slice --
@pytest.mark.parametrize("window", [256, 1000])
def test_window_slice_matches_unsliced_and_jax(window, monkeypatch):
    """T = S = 4096: the chunk is 512 query rows, so window + chunk < S and
    every chunk reads its band (the first ones clipped at 0)."""
    rng = np.random.default_rng(window)
    b, h, hkv, t, dh = 1, 4, 2, 4096, 16
    q = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, dh)).astype(np.float32)
    pos = np.arange(t)
    kw = dict(causal=True, window=window, kv_valid_len=None)
    want = np.asarray(jattention._xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), **kw))
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    _set(monkeypatch)
    plain = tattention._xla_attention(tq, tk, tv, q_positions=tpos, **kw)
    _set(monkeypatch, "WINDOW_SLICE")
    calls = []
    block = tattention._attention_block
    monkeypatch.setattr(tattention, "_attention_block", lambda *a, **k_: (
        calls.append(a[1].shape[2]), block(*a, **k_))[1])
    sliced = tattention._xla_attention(tq, tk, tv, q_positions=tpos, **kw)
    assert calls == [window + 512] * (t // 512)
    np.testing.assert_allclose(sliced.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(sliced.numpy(), want, **TOL)


def test_window_slice_leaves_other_calls_alone(monkeypatch):
    """Global layers, cached steps and non-causal calls take the unflagged
    path (equal)."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 2, 256, 8)).astype(np.float32)) for _ in range(3))
    pos = torch.arange(256)
    cases = [dict(causal=True, window=0, kv_valid_len=None),
             dict(causal=False, window=64, kv_valid_len=None),
             dict(causal=True, window=64, kv_valid_len=200)]
    _set(monkeypatch)
    want = [tattention._xla_attention(q, k, v, q_positions=pos, **c)
            for c in cases]
    _set(monkeypatch, "WINDOW_SLICE")
    for w, c in zip(want, cases):
        assert torch.equal(
            tattention._xla_attention(q, k, v, q_positions=pos, **c), w)


# -------------------------------------------------------------- bf16 loss --
def test_bf16_loss_rounds_the_logits(monkeypatch):
    """float32 weights: the flagged logits are the unflagged ones rounded
    to bfloat16 (the padding's -1e30 too)."""
    cfg = smoke_config("gemma3_12b")
    p = load_reference_params(_np_params(cfg, 2), "cpu")
    hidden = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))
    _set(monkeypatch)
    want = logits_from_hidden(p, cfg, hidden)
    _set(monkeypatch, "BF16_LOSS")
    got = logits_from_hidden(p, cfg, hidden)
    assert want.dtype == torch.float32 and got.dtype == torch.bfloat16
    assert torch.equal(got[..., :cfg.vocab], want[..., :cfg.vocab].to(
        torch.bfloat16))
    assert (got[..., cfg.vocab:] < -1e29).all()


@pytest.mark.parametrize("arch", ["granite_8b", "gemma3_12b"])
def test_bf16_loss_matches_jax_with_the_flag(arch, tmp_path, monkeypatch):
    cfg = smoke_config(arch)
    p = _np_params(cfg, 0, bf16=True)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab, (4, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    code = ("import jax, jax.numpy as jnp\n"
            "from repro.configs import smoke_config\n"
            "from repro.models import lm_loss\n"
            "p, batch, arch = inputs\n"
            "result = float(lm_loss(jax.tree.map(jnp.asarray, p), "
            "smoke_config(arch), jax.tree.map(jnp.asarray, batch)))\n")
    want = _jax_subprocess(tmp_path, code, ("BF16_LOSS",), (p, batch, arch))
    _set(monkeypatch, "BF16_LOSS")
    got = lm_loss(load_reference_params(p, "cpu"), cfg,
                  {k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(got), want, rtol=5e-3)


# ------------------------------------------------------------- bf16 accum --
def test_bf16_accum_is_the_bfloat16_accumulator(monkeypatch):
    cfg = smoke_config("granite_8b")
    p = load_reference_params(_np_params(cfg, 4), "cpu")
    toks = torch.randint(0, cfg.vocab, (4, 9),
                         generator=torch.Generator().manual_seed(4))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=4)

    def run(**kw):
        params = tree_map(lambda a: a.clone(), p)
        _, state, m = make_train_step(cfg, ocfg, microbatches=2, **kw)(
            params, opt_init(params), batch)
        return tree_leaves(state["master"]) + [m["grad_norm"]]

    _set(monkeypatch)
    want = run(accum_dtype=torch.bfloat16)
    wide = run()
    _set(monkeypatch, "BF16_ACCUM")
    got = run()
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert not torch.equal(got[-1], wide[-1])


# --------------------------------------------------------------- ALGORITHMS --
def test_algorithms_view_keys_match_jax():
    from repro.core import ALGORITHMS as jax_algorithms
    from repro_torch.core import ALGORITHMS
    from repro_torch.core.balancer import ALGORITHMS as balancer_view
    assert balancer_view is ALGORITHMS
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert sorted(ALGORITHMS) == sorted(jax_algorithms)
        assert "mixed" in ALGORITHMS and callable(ALGORITHMS["mixed"])
    assert caught and all(issubclass(w.category, DeprecationWarning)
                          for w in caught)
    assert "repro_torch.core.balancer.ALGORITHMS" in str(caught[0].message)
    with pytest.raises(TypeError):
        ALGORITHMS["mixed"] = None


# ---------------------------------------------------------- gloo meshes --
SERVE_ARCHS = ["gemma3_12b", "granite_moe_3b_a800m", "qwen2_7b",
               "whisper_large_v3", "dbrx_132b", "jamba_1_5_large_398b"]
TRAIN_ARCHS = ["granite_moe_3b_a800m", "gemma3_12b"]
MESHES = {
    "2x2": ((2, 2), [("flags_serve", a, 60 + i)
                     for i, a in enumerate(SERVE_ARCHS)]
            + [("flags_train", a, 70 + i)
               for i, a in enumerate(TRAIN_ARCHS)]),
    "2x1": ((2, 1), [("flags_serve", "granite_moe_3b_a800m", 80),
                     ("flags_train", "granite_moe_3b_a800m", 81)]),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for name, (shape, cases) in MESHES.items():
        d = tmp_path_factory.mktemp(f"flags_{name}")
        world = shape[0] * shape[1]
        worker.spawn(world, str(d / "store"), cases, str(d),
                     timeout_s=300, shape=shape)
        out[name] = [pickle.loads((d / f"mesh_rank{r}.pkl").read_bytes())
                     for r in range(world)]
    return out


def _rows(ranks, mesh, kind, arch):
    rows = [res[(kind, arch)] for res in ranks[mesh]]
    for row in rows:
        assert "error" not in row, row.get("error")
    return rows


def _close(want, got, rel, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * float(np.abs(want).max(initial=0)),
                               err_msg=what)


SERVE_CASES = [("2x2", a) for a in SERVE_ARCHS] + [
    ("2x1", "granite_moe_3b_a800m")]
TRAIN_CASES = [("2x2", a) for a in TRAIN_ARCHS] + [
    ("2x1", "granite_moe_3b_a800m")]


@pytest.mark.parametrize("mesh,arch", SERVE_CASES)
def test_flagged_serve_matches_unsharded(ranks, mesh, arch):
    """``MOE_GROUPED``, ``DECODE_WS`` and ``ATTN_SHARD``: the cache-free,
    prefill and decode logits and the caches within 1e-4 x the largest."""
    vocab = smoke_config(arch).vocab
    for row in _rows(ranks, mesh, "flags_serve", arch):
        for name in ("free", "logits"):
            want, got = row[name]
            _close(want[..., :vocab], got[..., :vocab], 1e-4, name)
        assert row["cache"]
        for i, (want, got) in enumerate(row["cache"]):
            _close(want, got, 1e-4, f"cache leaf {i}")


@pytest.mark.parametrize("mesh,arch", [
    c for c in SERVE_CASES if smoke_config(c[1]).moe_experts])
def test_grouped_ranks_route_their_own_tokens(ranks, mesh, arch):
    """Each MoE layer of the cache-free step and the prefill routes N / G
    tokens on each rank (G = 2 data ranks); a decode step's groups of one
    token each."""
    cfg = smoke_config(arch)
    layers = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    for row in _rows(ranks, mesh, "flags_serve", arch):
        assert row["dp"] == 2
        n = row["n_tokens"] // row["dp"]
        assert row["route_tokens"][:2 * layers] == [n] * (2 * layers)
        assert set(row["route_tokens"][2 * layers:]) == {1}


@pytest.mark.parametrize("mesh,arch", [c for c in SERVE_CASES
                                       if "jamba" not in c[1]])
def test_decode_ws_gathers_no_layer_weight_over_data(ranks, mesh, arch):
    """One decode step: with ``DECODE_WS`` no all-gather over "data"
    inside the layer stack gathers a weight (the activations it gathers
    are a few rows); without it every layer's weights are gathered there.
    The embedding, the final norm and the logits sit outside the pinned
    span, as in the JAX package; jamba's recurrent layers keep their
    replicated layout and are left out."""
    for row in _rows(ranks, mesh, "flags_serve", arch):
        weights = {name: [r for r in row["gathers"][name]
                          if r[0] == "data" and r[2] and r[3]]
                   for name in ("ws", "no_ws")}
        assert weights["ws"] == []
        assert len(weights["no_ws"]) >= smoke_config(arch).n_layers


@pytest.mark.parametrize("mesh,arch", TRAIN_CASES)
@pytest.mark.parametrize("run", ["flags", "bf16_accum"])
def test_flagged_train_matches_unsharded(ranks, mesh, arch, run):
    """``MOE_GROUPED``, ``ATTN_SHARD`` and ``DEFER_GRAD_SYNC`` (and
    ``BF16_ACCUM``), 2 microbatches: the loss rtol 1e-5 (it is computed
    before the accumulators), the grad norm rtol 1e-4 with float32
    accumulators and one bfloat16 ulp (2^-8) with bfloat16 ones (the
    mesh's partial sums round in another order), the masters within 2.5
    lr; an MoE rank routes its N / G tokens."""
    for row in _rows(ranks, mesh, "flags_train", arch):
        r = row[run]
        np.testing.assert_allclose(r["step_loss"][1], r["step_loss"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"][1], r["grad_norm"][0],
                                   rtol=2 ** -8 if run == "bf16_accum"
                                   else 1e-4)
        for want, got in r["masters"]:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2.5 * row["lr"])
        if smoke_config(arch).moe_experts:
            assert set(r["route_tokens"]) == {row["n_tokens"] // row["dp"]}


@pytest.mark.parametrize("mesh,arch", TRAIN_CASES)
def test_defer_grad_sync_reduces_once_a_step(ranks, mesh, arch):
    """Reduce-scatters of a step (``CommDebugMode``): per microbatch
    without the flag (2 microbatches, twice 1's), once a step with it (2
    microbatches, no more than 1's)."""
    key = "c10d_functional.reduce_scatter_tensor"
    for row in _rows(ranks, mesh, "flags_train", arch):
        c = {k: v.get(key, 0) for k, v in row["counts"].items()}
        assert c[(False, 1)] > 0
        assert c[(False, 2)] == 2 * c[(False, 1)]
        assert 0 < c[(True, 2)] <= c[(True, 1)] == c[(False, 1)]
