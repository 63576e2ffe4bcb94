#!/usr/bin/env python3
"""Profile train steps of ``chip_smoke.py``'s train cell on one CUDA card:
where a step's time goes, and how long the card idles.

    python3 scripts/train_profile.py [--steps 3] [--out trace.json]

It builds the ``train`` phase's ``Trainer`` (granite-moe-3b-a800m at full
width and depth, ``TrainPhaseConfig()``'s batch, microbatches and data
pipeline), runs ``--steps`` steps unprofiled, then one step under
``torch.profiler`` (CPU and CUDA activities), and reads the exported trace:
the step's wall ms, the card's busy ms (the union of its kernel and memcpy
intervals), the idle share, the kernel launches, and the 15 kernels with the
most device time. One JSON line, then the card's name and power limit.
``--out`` keeps the Chrome trace.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _busy_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.train import OptConfig, Trainer, TrainerConfig

    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 2
    tcfg = chip_smoke.TrainPhaseConfig()
    cfg = get_config(tcfg.arch)
    steps = args.steps + 1
    with tempfile.TemporaryDirectory() as ckpt:
        tr = Trainer(cfg, OptConfig(lr=tcfg.lr,
                                    warmup_steps=tcfg.warmup_steps,
                                    total_steps=steps),
                     TrainerConfig(total_steps=steps,
                                   checkpoint_every=steps + 1,
                                   rebalance_every=steps + 1,
                                   microbatches=tcfg.microbatches,
                                   skewshield=True),
                     ckpt, chip_smoke._draw_batches(torch, tcfg, cfg.vocab),
                     seed=tcfg.seed, device="cuda")
        tr.run(args.steps)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            tr.run(1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        trace = args.out or Path(ckpt) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset")]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in device]
    busy_ms = _busy_us(spans) / 1e3
    by_name = collections.Counter()
    for e in device:
        by_name[e["name"][:120]] += e.get("dur", 0) / 1e3
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                   and "LaunchKernel" in e.get("name", ""))
    print(json.dumps({
        "arch": cfg.name, "batch": tcfg.batch, "seq": tcfg.seq,
        "microbatches": tcfg.microbatches, "profiled_step": tr.step,
        "step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "kernels": sum(1 for e in device if e.get("cat") == "kernel"),
        "kernel_launches": launches,
        "top_device_ms": [[n, ms] for n, ms in by_name.most_common(15)]}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
