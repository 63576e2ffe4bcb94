"""Run one cell of the stream benchmark once and print its result line.

    python3 bench/run.py --workload wc-k1m.drift --seed 7 --seconds 30 \\
        --trace 0

From the root of a checkout on a machine with a CUDA card. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` the per-layer
metrics and a ``breakdown`` of the device's time); the last lines of
standard error are the numbers compared with the reference, each beside its
limit. Without a card, or where a run loads a forbidden module, it prints no
result and exits with 2.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), started=STARTED)
    except (harness.Refused, ImportError, FileNotFoundError) as exc:
        print(f"bench: no result: {exc}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
