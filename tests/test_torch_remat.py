"""The train step's backward is a function of its inputs (ROADMAP C14).

Remat recomputes an MoE superblock in the backward pass with the
forward's routing.

The router's logits are perturbed by one ulp on their second evaluation
only, the recompute in the backward pass, through a stand-in for the
``torch`` name that ``models.moe`` reads (a seam local to each test). Two
experts get identical router logits, so every token whose top-k boundary
falls between them is at an exact tie, and the ulp breaks the tie the
other way in one of the two cases. The gradients must still equal the
ones without remat bit for bit: the recompute must not route again.

The backward of the MoE dispatch gather and of the embedding gives the
same bits on every call: autograd's backward of an indexing gather adds a
row's repeated copies with atomic float adds on the CPU (with more than one
thread), whose order changes between calls.
"""

import dataclasses
import types

import numpy as np

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import layers, lm_loss, model_schema
from repro_torch.models import moe as moe_mod
from repro_torch.models import schema
from repro_torch.models.schema import tree_leaves, tree_map


class _TieTorch(types.SimpleNamespace):
    """``torch`` for ``models.moe``, whose ``topk`` first copies expert
    ``lo``'s logit onto expert ``hi`` (an exact tie) and, once ``armed``,
    moves expert ``bump``'s logit up by one ulp."""

    def __init__(self, lo: int, hi: int, bump: int):
        super().__init__(lo=lo, hi=hi, bump=bump, armed=False, calls=[])

    def __getattr__(self, name):
        return getattr(torch, name)

    def topk(self, gates, k, dim=-1):
        self.calls.append(self.armed)
        cols = list(gates.unbind(-1))
        cols[self.hi] = cols[self.lo]
        # the same ops on every evaluation (a recompute must replay the
        # forward's op sequence); the step is 0 until armed
        col = cols[self.bump]
        with torch.no_grad():
            ulp = torch.nextafter(col, torch.full_like(col, float("inf"))
                                  ) - col
        cols[self.bump] = col + ulp * float(self.armed)
        return torch.topk(torch.stack(cols, -1), k, dim=dim)


def _grads(monkeypatch, cfg, params, batch, remat: bool, bump: int):
    seam = _TieTorch(0, 1, bump)
    monkeypatch.setattr(moe_mod, "torch", seam)
    live = tree_map(lambda a: a.clone().requires_grad_(), params)
    loss, loads = lm_loss(live, cfg, batch, remat=remat, collect_moe=True)
    seam.armed = True              # only a recompute evaluates it again
    grads = torch.autograd.grad(loss, tree_leaves(live))
    monkeypatch.undo()
    return loss, loads, grads, seam.calls


@pytest.mark.parametrize("bump", [0, 1])
def test_remat_recompute_keeps_the_forwards_routing(monkeypatch, bump):
    cfg = dataclasses.replace(smoke_config("granite_moe_3b_a800m"),
                              n_layers=2)
    gen = torch.Generator().manual_seed(11)
    params = tree_map(lambda a: a.float(),
                      schema.init(model_schema(cfg), gen, "cpu"))
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = _grads(monkeypatch, cfg, params, batch, False, bump)
    got = _grads(monkeypatch, cfg, params, batch, True, bump)
    # the seam ran in the forward of both and in the recompute of remat's
    assert want[3] == [False] * cfg.n_layers
    assert got[3] == [False] * cfg.n_layers + [True] * cfg.n_layers
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)


def _repeat_grads(fn, inputs, cotangent, calls=4):
    """The gradients of ``fn`` at ``inputs`` on ``calls`` calls, with a
    buffer of another size allocated before each (other addresses)."""
    rng = np.random.default_rng(0)
    kept, out = [], []
    for _ in range(calls):
        kept.append(torch.empty(int(rng.integers(1, 1 << 20))))
        live = [a.clone().requires_grad_() for a in inputs]
        out.append(torch.autograd.grad(fn(*live), live, cotangent))
    return out


def test_moe_backward_is_the_same_on_every_call():
    cfg = dataclasses.replace(smoke_config("granite_moe_3b_a800m"),
                              d_model=256, moe_experts=16, moe_topk=8)
    gen = torch.Generator().manual_seed(12)
    p = {k: v.float() for k, v in schema.init(
        moe_mod.moe_schema(cfg), gen, "cpu").items()}
    x = torch.randn(2, 64, cfg.d_model, generator=gen)
    names = sorted(p)

    def fn(x, *ws):
        return moe_mod.moe(dict(zip(names, ws)), cfg, x)

    runs = _repeat_grads(fn, [x] + [p[k] for k in names],
                         torch.randn(x.shape, generator=gen))
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def test_embedding_backward_is_the_same_on_every_call():
    gen = torch.Generator().manual_seed(13)
    table = torch.randn(64, 1024, generator=gen)
    tokens = torch.randint(0, 4, (2, 256), generator=gen)  # many repeats
    runs = _repeat_grads(lambda t: layers.embed({"tokens": t}, tokens),
                         [table], torch.randn(2, 256, 1024, generator=gen))
    for run in runs[1:]:
        assert torch.equal(run[0], runs[0][0])
