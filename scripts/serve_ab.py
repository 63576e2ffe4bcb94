#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s ``serve`` phase (or with ``--phase train`` its
full-depth train leg) of two or more checkouts in turns on one CUDA card,
so that a change's serve or train path can be held against its parent's
within one call.

    python3 scripts/serve_ab.py PARENT_ROOT CHANGE_ROOT [--rounds 2]
    python3 scripts/serve_ab.py --phase train PARENT_ROOT CHANGE_ROOT

Each root is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` into the ignored ``build/``). The roots run
in the order given and then in reverse, ``--rounds`` times over (parent,
change, change, parent for two roots and one round). Each run is its own
process, which imports that root's ``chip_smoke`` and ``repro_torch`` and
runs ``phase_serve`` on gemma3-12b at ``ServeConfig()``'s sizes (the flash
kernel builds in that root's ``src/repro_torch/build/``), or
``_train_full_depth`` on granite-moe-3b-a800m at ``TrainPhaseConfig()``'s
sizes. One JSON line a run: the root, the cache-free step's seconds, the
cached prefill's seconds and the decode ms per token (median of 16), or
the train step's, loss-and-backward's and ``opt_update``'s ms (medians
from the second step on); then one line with each root's medians over its
runs and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

_HEAD = r"""
import json, statistics, sys
root = sys.argv[1]
sys.path[:0] = [root + "/src", root]
import torch
import chip_smoke
from repro_torch.configs import get_config
"""

_RUNS = {"serve": _HEAD + r"""
scfg = chip_smoke.ServeConfig()
out = chip_smoke.phase_serve(torch, get_config(scfg.arch), scfg, "cuda",
                             torch.cuda.synchronize)
print(json.dumps({
    "cache_free_flash_s": out["cache_free_flash"]["seconds"],
    "prefill_s": out["cached"]["prefill_seconds"],
    "decode_ms_median": out["cached"]["decode_ms_per_token_median"]}))
""", "train": _HEAD + r"""
import pathlib, tempfile
tcfg = chip_smoke.TrainPhaseConfig()
with tempfile.TemporaryDirectory() as tmp:
    out = chip_smoke._train_full_depth(
        torch, get_config(tcfg.arch), tcfg, torch.device("cuda"),
        torch.cuda.synchronize, pathlib.Path(tmp) / "full")
print(json.dumps({
    "step_ms_median": out["step_ms_median_2_on"],
    "loss_backward_ms_median": statistics.median(
        out["loss_backward_ms"][1:]),
    "opt_update_ms_median": statistics.median(out["opt_update_ms"][1:])}))
"""}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--phase", choices=sorted(_RUNS), default="serve")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    order = (args.roots + args.roots[::-1]) * args.rounds
    runs = {str(r): [] for r in args.roots}
    for root in order:
        res = subprocess.run([sys.executable, "-c", _RUNS[args.phase],
                              str(root.resolve())], capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        runs[str(root)].append(rec)
        print(json.dumps({"root": str(root), **rec}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "medians": {
        root: {key: statistics.median(r[key] for r in recs)
               for key in recs[0]} for root, recs in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
