#!/usr/bin/env python3
"""Do the port's two CPU stages agree in sketch mode at the stream cell?

    python3 scripts/sketch_oracles.py [PLANNER] [INTERVALS]

Runs ``chip_smoke.py``'s sketch-mode drive (the stream deployment: K =
10^6, window 5, 4M tuples an interval, 15 tasks, the default
``SketchConfig``) with the device backend on the CPU (``device="cpu"``, the
kernels' plain versions) in place of the card, against ``chip_smoke``'s
CPU oracle, the columnar + numpy stage. The device backend folds an
interval into the sketch once with every channel, the columnar backend
twice (traffic, then held state sizes at zero cost); the SpaceSaving
tracker could truncate differently under the two, which would make the
columnar stage no oracle for the card. Defaults: Mixed, 8 intervals.

Prints one JSON line: ``agree`` (every report, table, output and trigger
identical), the head key counts, θ and the host times; the traceback of
the first difference goes to stderr. Needs no GPU; at this size it wants a
few GB of memory and about a minute of host time.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    planner = sys.argv[1] if len(sys.argv) > 1 else "mixed"
    cfg = cs.Config()
    intervals = int(sys.argv[2]) if len(sys.argv) > 2 else cfg.intervals
    t0 = time.perf_counter()
    try:
        run, _ = cs._drive_sketch(cfg, planner, intervals, "cpu",
                                  lambda: None)
    except AssertionError as err:
        traceback.print_exc()
        print(json.dumps({"planner": planner, "agree": False,
                          "error": str(err),
                          "seconds": time.perf_counter() - t0}))
        return 1
    print(json.dumps({"planner": planner, "agree": True,
                      **{k: run[k] for k in (
                          "intervals", "head_keys", "theta", "plan_ms",
                          "interval_ms", "ingest_ms", "rebalances",
                          "table_size")},
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
