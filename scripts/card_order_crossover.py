#!/usr/bin/env python3
"""Where the Mixed planner's psi order is cheaper on the card than on the
host: the crossover that ``llfd.CARD_ORDER_MIN_KEYS`` is set from.

    python3 scripts/card_order_crossover.py [--reps 15]

For each universe size n (2^10 to 2^20 keys, and 883,789, the drift
cell's universe) it draws psi as the drift cell's gamma looks (about 60%
zeros, the rest c^1.5 / S with small integer c, heavy ties) and times
``llfd.psi_ranks`` (the order and its inverse), the median of ``--reps``
calls each on the host's clock: ``host_ms`` without a device (numpy's
stable argsort and the rank scatter), ``card_ms`` on the card (the upload,
the finite check, the stable sort and the scatter there, both copied
back). Each result is held against numpy's first. One JSON line per size,
then one with the card's name and power limit and the smallest n from
which ``card_ms`` stays below ``host_ms``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.balancer import llfd  # noqa: E402


def _psi(n: int, rng: np.random.Generator) -> np.ndarray:
    cost = np.where(rng.random(n) < 0.4, rng.zipf(1.8, n), 0).astype(float)
    mem = 8.0 * (cost + rng.integers(1, 20, n)) + 16.0
    return np.power(cost, 1.5) / mem


def _median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cuda = torch.device("cuda")
    rng = np.random.default_rng(36)
    # every size runs with the threshold out of the way
    llfd.CARD_ORDER_MIN_KEYS = 0
    warm = _psi(1 << 16, rng)
    for _ in range(3):
        llfd.psi_ranks(warm, cuda)
    rows = []
    sizes = sorted([1 << p for p in range(10, 21)] + [883_789])
    for n in sizes:
        psi = _psi(n, rng)
        want = np.argsort(-psi, kind="stable")
        for got in (llfd.psi_ranks(psi), llfd.psi_ranks(psi, cuda)):
            assert np.array_equal(got[0], want), n
            assert np.array_equal(got[1][want], np.arange(n)), n
        row = {"n": n,
               "host_ms": _median_ms(lambda: llfd.psi_ranks(psi), args.reps),
               "card_ms": _median_ms(lambda: llfd.psi_ranks(psi, cuda),
                                     args.reps)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    crossover = None
    for i, row in enumerate(rows):
        if all(r["card_ms"] < r["host_ms"] for r in rows[i:]):
            crossover = row["n"]
            break
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "crossover_n": crossover,
                      "host_cpus": len(os.sched_getaffinity(0)),
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
