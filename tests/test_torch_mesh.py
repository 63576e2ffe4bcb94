"""The port's serve and train steps on DTensors under a 4-rank (2, 2)
("data", "model") gloo mesh, against the unsharded port, on the CPU.

One module-scoped spawn (``tests/torch_mesh_worker.py``: spawned ranks, a
``FileStore`` under a temporary directory, timeouts on the group and on the
join) runs every case on every rank; each parametrised test asserts its own
row of every rank's results. The unsharded port is the oracle: the JAX
package's sharded tests do not run on this CPU (ROADMAP C5), and the port
is held against the JAX package unsharded by the other ``test_torch_*``
files.

* serve, all ten smoke configs, float32 weights (the forward casts the
  embedding to bfloat16, ROADMAP C11): the cache-free step's logits
  (whisper's also from its frames, through the encoder on DTensors), the
  prefill and decode logits and every cache entry within 1e-4 x the
  largest element (the logits on the real vocabulary; the padding is
  -1e30 on both); every MoE layer's routing identical (each entry's row in
  the dispatch buffer, and the loads); the parameters laid out as
  ``param_shardings`` says.
* the launchers: ``serve_local`` and the ``Trainer`` with a mesh, and
  the dry run's bytes per device against the real mesh's shards (see the
  tests).
* train, gemma3, granite-moe and jamba at one superblock: the loss within
  rtol 1e-5, every gradient within 1e-6 + 1e-4 x the leaf's largest
  element, and after one AdamW step of 2 microbatches the float32 masters
  within 2.5 lr (``CARD_CPU_TOL``'s rule, ROADMAP C6); the placements of
  every parameter and optimizer-state leaf after the step equal those
  before it, and the state is laid out as ``opt_shardings`` says. The
  weights the schema keeps in bfloat16 are float64 here, so that the two
  runs' float32 sums in another order do not flip a bfloat16 rounding
  behind the embedding's cast (ROADMAP C15): the mesh reproduces the
  unsharded layer's casts one for one (``models.transformer._operand``).

The weights come from numpy (``torch_mesh_worker.np_params``, the parity
tests' rule); the cases avoid the JAX-traced stage settings of ROADMAP C8
(they run no stream stage) and hold no global state.
"""

import dataclasses
import pickle

import numpy as np
import pytest

from repro_torch.configs import smoke_config
from repro_torch.models import model_schema
from repro_torch.models.schema import tree_paths

import torch_mesh_worker as worker

WORLD = 4
SERVE_ARCHS = ["gemma3_12b", "granite_moe_3b_a800m", "jamba_1_5_large_398b",
               "internvl2_1b", "qwen2_7b", "granite_20b", "dbrx_132b",
               "xlstm_125m", "whisper_large_v3", "granite_8b"]
TRAIN_ARCHS = ["gemma3_12b", "granite_moe_3b_a800m", "jamba_1_5_large_398b"]
LAUNCH_ARCH = "granite_moe_3b_a800m"
CASES = ([("serve", a, 10 + i) for i, a in enumerate(SERVE_ARCHS)]
         + [("train", a, 30 + i) for i, a in enumerate(TRAIN_ARCHS)]
         + [("bytes", a, 40 + i) for i, a in enumerate(SERVE_ARCHS)]
         + [("launchers", LAUNCH_ARCH, 50)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    worker.spawn(WORLD, str(out / "store"), CASES, str(out))
    return [pickle.loads((out / f"mesh_rank{r}.pkl").read_bytes())
            for r in range(WORLD)]


def _rows(ranks, kind, arch):
    rows = [res[(kind, arch)] for res in ranks]
    for row in rows:
        assert "error" not in row, row.get("error")
    return rows


def _close(want, got, rel, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * float(np.abs(want).max(initial=0)),
                               err_msg=what)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_matches_unsharded(ranks, arch):
    vocab = smoke_config(arch).vocab
    for row in _rows(ranks, "serve", arch):
        for name in ("free", "logits", "from_frames"):
            if row[name] is None:
                assert name == "from_frames" and arch != "whisper_large_v3"
                continue
            want, got = row[name]
            _close(want[..., :vocab], got[..., :vocab], 1e-4, name)
        assert row["cache"]
        for i, (want, got) in enumerate(row["cache"]):
            _close(want, got, 1e-4, f"cache leaf {i}")
        assert row["routing_equal"]
        assert all(got == [str(p) for p in want]
                   for got, want in row["param_placements"])


@pytest.mark.parametrize("arch", [a for a in SERVE_ARCHS
                                  if smoke_config(a).moe_experts])
def test_serve_routes_every_moe_layer(ranks, arch):
    """One routing per MoE layer per step (the cache-free step, the
    prefill and 3 decode steps), recorded on both runs and identical."""
    cfg = smoke_config(arch)
    layers = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    for row in _rows(ranks, "serve", arch):
        assert row["routes"] == layers * (2 + worker.SERVE["decode"])
        assert row["routing_equal"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_grads_match_unsharded(ranks, arch):
    cfg = smoke_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
    paths = [p for p, _ in tree_paths(model_schema(cfg))]
    for row in _rows(ranks, "train", arch):
        np.testing.assert_allclose(row["loss"][1], row["loss"][0],
                                   rtol=1e-5)
        assert len(row["grads"]) == len(paths)
        for path, (want, got) in zip(paths, row["grads"]):
            want = np.asarray(want, np.float64)
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=1e-6 + 1e-4 * float(np.abs(want).max(initial=0)),
                err_msg=path)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_unsharded_and_keeps_placements(ranks, arch):
    for row in _rows(ranks, "train", arch):
        np.testing.assert_allclose(row["step_loss"][1], row["step_loss"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(row["grad_norm"][1], row["grad_norm"][0],
                                   rtol=1e-4)
        for want, got in row["masters"]:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2.5 * row["lr"])
        before, after = row["placements"]
        assert before == after
        assert row["opt_layout_ok"]
        assert row["step"] == (1, 1)


def test_launchers_take_a_mesh(ranks):
    """``serve_local(mesh=...)`` and ``Trainer(mesh=...)`` on granite-moe's
    bfloat16 weights: the prefill logits within the JAX package's bfloat16
    serve tolerance (atol 0.3, rtol 0.05) of the unsharded launcher's, the
    first train step's loss within its bfloat16 loss tolerance (rtol
    5e-3), and a trainer resumed from the mesh checkpoint (SkewShield
    rebalancing after every step) repeating the next step's loss
    exactly."""
    for row in _rows(ranks, "launchers", LAUNCH_ARCH):
        (want, want_tokens), (got, got_tokens) = (row["serve"]["plain"],
                                                  row["serve"]["mesh"])
        np.testing.assert_allclose(got, want, atol=0.3, rtol=0.05)
        assert got_tokens.shape == want_tokens.shape == (2, 2)
        np.testing.assert_allclose(row["losses"][0], row["plain_loss"],
                                   rtol=5e-3)
        assert np.isfinite(row["losses"]).all()
        assert row["resumed"] and row["resumed_step"] == 2
        assert row["repeat"] == row["losses"][2]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_dry_run_bytes_match_the_mesh_shards(ranks, arch):
    """``launch.dryrun.bytes_per_device`` on the mesh's axis sizes equals
    the sum of the local shards that the shardings give on the real
    (2, 2) mesh: parameters, optimizer state, cache."""
    for row in _rows(ranks, "bytes", arch):
        assert row["dry_train"]["params"] == row["params"]
        assert row["dry_decode"]["params"] == row["params"]
        assert row["dry_train"]["opt_state"] == row["opt_state"]
        assert row["dry_decode"]["cache"] == row["cache"]


def test_every_rank_sees_the_same_results(ranks):
    """The full tensors each rank gathers agree across the ranks."""
    for kind, arch, _ in CASES:
        if kind not in ("serve", "train"):
            continue
        rows = _rows(ranks, kind, arch)
        key = "logits" if kind == "serve" else "loss"
        for row in rows[1:]:
            np.testing.assert_array_equal(np.asarray(row[key][1]),
                                          np.asarray(rows[0][key][1]))
