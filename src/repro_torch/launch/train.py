"""Training launcher — the local mode of the JAX package's
``launch/train.py``: real steps on one device at the arch's smoke size,
through the whole stack (keyed data pipeline -> microbatched AdamW ->
checkpoints -> SkewShield for MoE archs).

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --mode lower --shape train_4k --mesh multi

``--device`` defaults to the CUDA card. A run resumes from the newest
checkpoint in ``--ckpt`` when there is one. ``--mode lower`` prints the
full config's dry run (:func:`repro_torch.launch.dryrun.lower_cell`),
whose train cell counts the JAX dry run's microbatches unless
``--microbatches`` is given.

As the JAX launcher does, :func:`main` turns on ``REPRO_PERF_MOE_GROUPED``,
and ``REPRO_PERF_ATTN_SHARD`` for the five archs whose heads do not divide
the production mesh's "model" axis (``os.environ.setdefault``: a value
already set stays), unless given ``--no-perf-flags``
(:mod:`repro_torch.flags`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import flags
from ..configs import smoke_config
from ..data.pipeline import KeyedDataPipeline, zipf_sources
from ..train.optimizer import OptConfig
from ..train.trainer import Trainer, TrainerConfig


def frontend_batch(cfg, batch: int, step: int) -> dict:
    """The step's stub front-end input, as the JAX launcher draws it:
    standard normal from ``np.random.default_rng(step)`` in bfloat16,
    ``pixel_embeds`` (batch, prefix_len, D) for a vision arch, ``frames``
    (batch, encoder_seq, D) for an audio arch, else {}."""
    name, n = {"vision_stub": ("pixel_embeds", cfg.prefix_len),
               "audio_stub": ("frames", cfg.encoder_seq)}.get(
                   cfg.frontend, (None, 0))
    if name is None:
        return {}
    a = np.random.default_rng(step).standard_normal((batch, n, cfg.d_model))
    return {name: torch.from_numpy(a).to(torch.bfloat16)}


def main(argv=None) -> None:
    args = _args(argv)
    with flags.launcher_defaults_set("train", args.arch.replace("-", "_"),
                                     not args.no_perf_flags):
        _run(args)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", choices=["local", "lower"], default="local")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=None,
                    help="microbatches a step (default 1; a dry run's train "
                    "cell: the JAX dry run's count)")
    ap.add_argument("--ckpt", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-perf-flags", action="store_true")
    return ap.parse_args(argv)


def _run(args) -> None:
    arch = args.arch.replace("-", "_")
    if args.mode == "lower":
        import json

        from .dryrun import lower_cell
        print(json.dumps(lower_cell(arch, args.shape, args.mesh,
                                    microbatches=args.microbatches),
                         indent=1))
        return

    cfg = smoke_config(arch)
    pipe = KeyedDataPipeline(zipf_sources(32, z=1.0), n_workers=1,
                             seq_len=args.seq, vocab=cfg.vocab)

    def data_fn(step):
        while True:
            pipe.run_interval(n_docs=32)
            b = pipe.worker_batch(0, args.batch)
            if b is not None:
                out = {k: torch.from_numpy(v) for k, v in b.items()}
                out.update(frontend_batch(cfg, args.batch, step))
                return out

    tcfg = TrainerConfig(total_steps=args.steps, checkpoint_every=10,
                         microbatches=args.microbatches or 1,
                         skewshield=cfg.moe_experts > 0)
    tr = Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=5,
                                total_steps=args.steps),
                 tcfg, args.ckpt, data_fn, device=args.device)
    if tr.try_resume():
        print(f"resumed at step {tr.step}")
    hist = tr.run()
    print(f"{arch}: step {tr.step} loss "
          f"{hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
