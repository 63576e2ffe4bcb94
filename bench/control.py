"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, with one guarantee the configuration
states broken. It sheds every 100th tuple handed to it (delivery at most
once, where the configuration states exactly once): a step a later change
might take to keep up under load. Its routing tables come from the same
kind of controller the program runs (the Mixed planner on the reference's
own exact statistics), so every number the judge compares is produced.

    python3 bench/control.py --workload wc-k1m.drift --seconds 10 \\
        --seeds 1,2,3

runs the harness once per seed at the cell's own size, with the control in
the program's place, and prints each run's numbers beside their limits and
whether the run read ``correct``. The benchmark's own runs never run it.
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
#: one tuple in this many is shed
SHED_EVERY = 100


@dataclasses.dataclass
class _Report:
    tuples: int
    task_loads: np.ndarray
    migrated_bytes: float
    plan_time_s: float


class _Fleet:
    """The reference's window as the harness reads a device fleet."""

    def __init__(self, stage):
        self._stage = stage

    @property
    def vals(self):
        return self._stage.ref.ring(self._stage.ref.window + 1)[0]

    @property
    def pres(self):
        return self._stage.ref.ring(self._stage.ref.window + 1)[1]

    @property
    def task(self):
        ref, ctrl = self._stage.ref, self._stage.controller
        return np.where(ref.held, ref.route(ctrl.assignment.table), -1)

    @property
    def domain(self):
        return self._stage.ref.k


class ControlStage:
    """The reference with tuples shed, behind the stage's surface."""

    def __init__(self, cfg: dict, device: str = "cpu", bench=None):
        from bench import judge, reference
        from repro_torch.core.balancer import (Assignment, BalanceConfig,
                                               Hash32, KeyStats)
        from repro_torch.core.controller import RebalanceController
        self._stats = KeyStats
        self.ref = judge.reference_for(cfg, bench or reference.BENCH)
        self.controller = RebalanceController(
            Assignment(Hash32(cfg["tasks"], seed=cfg.get("hash_seed", 0))),
            BalanceConfig(theta_max=cfg["theta_max"],
                          table_max=cfg["table_max"], window=cfg["window"]),
            algorithm=cfg.get("algorithm", "mixed"))
        self.backend = self
        self.fleet = _Fleet(self)
        self._dest_dense_cache = None
        self.reports = []
        self.outputs = {}
        self.emitted_sum = 0.0
        self._plan_s = 0.0

    def process_interval_arrays(self, keys: np.ndarray):
        keys = keys[(np.arange(keys.size) + 1) % SHED_EVERY != 0]
        ref = self.ref
        loads, moved, dest = ref.step(keys, self.controller.assignment.table)
        self._dest_dense_cache = (None, None, dest)
        self.reports.append(_Report(int(keys.size), loads, moved,
                                    self._plan_s))
        seen = np.flatnonzero(ref.counts)
        self.outputs.update(zip(seen.tolist(), ref.output[seen].tolist()))
        self.emitted_sum = ref.emitted
        alive = np.flatnonzero(ref.held)
        ev = self.controller.on_interval(self._stats(
            keys=alive, cost=ref.cost[alive], mem=ref.mem[alive].copy(),
            freq=ref.counts[alive].astype(np.float64)))
        self._plan_s = ev.result.plan_time_s if ev.result is not None else 0.0
        return self.reports[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import harness
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             device=args.device, stage_factory=ControlStage,
                             log=lambda s: None)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"],
                          "intervals": r["attempted"],
                          "wall_s": time.perf_counter() - t0,
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
