"""Serving launcher — the local mode of the JAX package's
``launch/serve.py``: random weights, a random prompt, prefill through the KV
cache and greedy decoding, on one device; an MoE arch gets one SkewShield
placer per layer, and every step takes their placements.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --device cpu --tokens 8
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-3b-a800m --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-large-v3 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
      --mode lower --shape decode_32k --mesh single

The CLI runs the arch's smoke config, as the JAX launcher does; callers
with a card pass a full config to :func:`serve_local`. An audio arch
(whisper) gets random stub frames, encoded once for the prefill and all
decode steps; a vision arch (internvl2) a random prefix of pixel
embeddings, which the cache and the decode index make room for.
``serve_local(mesh=...)`` runs every step on DTensors under a device mesh
(``sharding.ctx.use_mesh``). ``--mode lower`` prints the full config's
dry run (:func:`repro_torch.launch.dryrun.lower_cell`): FLOPs, bytes per
device, collective bytes per family and peak memory per device.

As the JAX launcher does, :func:`main` turns on ``REPRO_PERF_DECODE_WS``
and ``REPRO_PERF_MOE_GROUPED`` (``os.environ.setdefault``: a value already
set stays) unless given ``--no-perf-flags`` (:mod:`repro_torch.flags`).
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import flags
from ..configs import smoke_config
from ..models import cache_schema, init_cache, model_schema, schema
from ..models.transformer import encode
from ..models.config import ModelConfig
from ..models.skewshield import SkewShieldPlacer, placements_array
from ..sharding import ctx
from ..streams.device import resolve_device
from ..train.train_step import make_serve_step


def init_request(cfg: ModelConfig, batch: int, prompt: int, device,
                 generator: torch.Generator):
    """Random weights, then a (batch, prompt) prompt of random token ids,
    both drawn from ``generator`` in that order. Returns (params, tokens)."""
    params = schema.init(model_schema(cfg), generator, device)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=generator,
                           device=device)
    return params, tokens


def frontend_inputs(cfg: ModelConfig, batch: int, device,
                    generator: torch.Generator) -> dict:
    """The arch's stub front-end input, standard normal in bfloat16 from
    ``generator``: {"frames": (batch, encoder_seq, D)} for an audio arch,
    {"pixel_embeds": (batch, prefix_len, D)} for a vision arch, else {}
    (the JAX launcher's inputs)."""
    shape = {"audio_stub": ("frames", cfg.encoder_seq),
             "vision_stub": ("pixel_embeds", cfg.prefix_len)}.get(
                 cfg.frontend)
    if shape is None:
        return {}
    name, n = shape
    return {name: torch.randn((batch, n, cfg.d_model), generator=generator,
                              device=device).to(torch.bfloat16)}


def moe_placers(cfg: ModelConfig) -> List[SkewShieldPlacer]:
    """One placer per layer for an MoE arch, as the JAX launcher builds
    them: up to 4 shards that divide the experts evenly (at least 2), and
    1e6 bytes an expert. Empty for a dense arch."""
    if not cfg.moe_experts:
        return []
    shards = max(2, min(4, cfg.moe_experts))
    while cfg.moe_experts % shards:
        shards -= 1
    return [SkewShieldPlacer(cfg.moe_experts, shards, 1e6)
            for _ in range(cfg.n_layers)]


def serve_local(cfg: ModelConfig, batch: int = 2, prompt: int = 16,
                tokens: int = 16, device=None,
                generator: Optional[torch.Generator] = None, mesh=None
                ) -> Tuple[torch.Tensor, np.ndarray]:
    """Prefill a random ``batch`` x ``prompt`` request through the KV cache,
    then decode ``tokens`` greedy tokens, one step each. Attention with a
    cache takes the plain path, so this never reaches the flash kernel. An
    MoE arch runs every step under the placements of
    :func:`moe_placers` (the identity, as the JAX launcher never updates
    them).

    Weights and prompt come from :func:`init_request` with ``generator``
    (seed 0 on the device when None), then the front-end input from
    :func:`frontend_inputs`; whisper's frames are encoded once and every
    step takes the ``encoder_out``. ``device=None`` means the CUDA card
    and raises without one. Returns the prefill's next-token logits
    (batch, 1, vocab_padded) and the greedy tokens (batch, tokens) int64.

    With ``mesh`` (a ``DeviceMesh`` over the default process group, each
    rank calling with the same seed) the weights are laid out by
    ``param_shardings`` (FSDP on "data"), the cache by ``cache_shardings``
    and every step runs under ``sharding.ctx.use_mesh``; the returned
    logits are gathered whole.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params, prompt_tokens = init_request(cfg, batch, prompt, dev, generator)
    front = frontend_inputs(cfg, batch, dev, generator)
    if "frames" in front:
        with torch.inference_mode():
            front = {"encoder_out": encode(params, cfg, front["frames"])}
    prefix = cfg.prefix_len if "pixel_embeds" in front else 0
    placers = moe_placers(cfg)
    placements = placements_array(placers, dev) if placers else None
    cache = init_cache(cfg, batch, prefix + prompt + tokens, dev)
    step = make_serve_step(cfg)
    if mesh is not None:
        params, cache = _lay_out(cfg, params, cache, batch,
                                 prefix + prompt + tokens, mesh)

    def serve_step(*args):
        with ctx.use_mesh(mesh):
            logits, new_cache = step(*args)
        return (logits.full_tensor() if mesh is not None else logits,
                new_cache)

    logits, cache = serve_step(params, cache,
                               {"tokens": prompt_tokens, **front}, 0,
                               placements)
    first = logits
    step_batch = {k: v for k, v in front.items() if k == "encoder_out"}
    idx = prefix + prompt
    outs = []
    for _ in range(tokens):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        outs.append(nxt[:, 0].cpu().numpy())
        logits, cache = serve_step(params, cache,
                                   {"tokens": nxt, **step_batch}, idx,
                                   placements)
        idx += 1
    greedy = np.stack(outs, 1) if outs else np.zeros((batch, 0), np.int64)
    return first, greedy


def _lay_out(cfg: ModelConfig, params, cache, batch: int, max_seq: int,
             mesh):
    """The weights and the cache as DTensors on ``mesh``, by the sharding
    rules."""
    from ..sharding import rules
    return (schema.distribute(params, rules.param_shardings(
                model_schema(cfg), mesh)),
            schema.distribute(cache, rules.cache_shardings(
                cache_schema(cfg, batch, max_seq), mesh, batch)))


def main(argv=None) -> None:
    args = _args(argv)
    with flags.launcher_defaults_set("serve", args.arch.replace("-", "_"),
                                     not args.no_perf_flags):
        _run(args)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", choices=["local", "lower"], default="local")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-perf-flags", action="store_true")
    return ap.parse_args(argv)


def _run(args) -> None:
    arch = args.arch.replace("-", "_")
    if args.mode == "lower":
        import json

        from .dryrun import lower_cell
        print(json.dumps(lower_cell(arch, args.shape, args.mesh), indent=1))
        return
    _, greedy = serve_local(smoke_config(arch), args.batch, args.prompt,
                            args.tokens, device=args.device)
    print(f"{arch}: decoded {args.tokens} tokens x batch {args.batch}")
    print(greedy)


if __name__ == "__main__":
    main()
