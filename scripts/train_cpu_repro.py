#!/usr/bin/env python3
"""Repeat the float32 train step that ``chip_smoke.py``'s ``train`` phase
holds the card against (granite-moe-3b-a800m at full width cut to 2
layers, 2 x 128 tokens, 2 microbatches; ``_train_card_vs_cpu``) on the CPU,
and print each call's loss and grad norm, to see whether the CPU reference
gives one result (ROADMAP C14).

  python3 scripts/train_cpu_repro.py [--trials 5] [--threads 0] [--card]

``--threads 0`` keeps torch's default thread count. Between calls a
tensor of a random size is allocated and kept, so the allocator hands each
call other addresses. ``--card`` also runs ``chip_smoke._train_card_vs_cpu``
once (needs a CUDA device). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--card", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import schema
    from repro_torch.models.schema import tree_map
    from repro_torch.models.transformer import model_schema
    from repro_torch.train import OptConfig, make_train_step, opt_init

    if args.threads:
        torch.set_num_threads(args.threads)
    tcfg = chip_smoke.TrainPhaseConfig()
    full = get_config(tcfg.arch)
    cfg = dataclasses.replace(full, n_layers=tcfg.resume_layers)
    # the weights and batch of _train_card_vs_cpu, drawn the same way
    gen = torch.Generator().manual_seed(tcfg.seed + 2)
    weights = tree_map(lambda a: a.float(),
                       schema.init(model_schema(cfg), gen, "cpu"))
    toks = torch.randint(0, full.vocab, (tcfg.cpu_batch, tcfg.cpu_seq + 1),
                         generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(cfg, OptConfig(lr=tcfg.lr,
                                          warmup_steps=tcfg.warmup_steps,
                                          total_steps=tcfg.steps),
                           microbatches=2, collect_moe=True)
    rng = np.random.default_rng()
    kept, calls = [], []
    for _ in range(args.trials):
        kept.append(torch.empty(int(rng.integers(1, 1 << 20))))
        p = tree_map(lambda a: a.clone(), weights)
        t0 = time.perf_counter()
        _, _, m = step(p, opt_init(p), batch)
        calls.append({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "seconds": time.perf_counter() - t0})
    out = {"threads": torch.get_num_threads(), "cpu": calls}
    if args.card:
        res = chip_smoke._train_card_vs_cpu(
            torch, full, tcfg, torch.device("cuda"), torch.cuda.synchronize)
        out["card_vs_cpu"] = {k: res[k] for k in
                              ("loss", "grad_norm", "within_tolerance")}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
