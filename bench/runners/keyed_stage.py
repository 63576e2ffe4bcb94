"""The runner of a keyed stream stage: the program's ``KeyedStage`` as the
configuration states it, fed by a closed loop.

It builds the stage on the routing kernel (the main path: Hash32,
``substrate="kernels"``) with the program's operator that the
configuration's reference operator names (``bench/operators/<operator>.py``,
``PROGRAM``), draws the mix's cycle from the seed, and warms up on the
first ``window + 1`` intervals, so the window opens on a full ring. In the
measured window it hands the stage one interval after another, each as
soon as the stage has returned the last (as a backpressured source feeds
it). After the window it hands ``window + 1`` more intervals drawn from the
run's seed, for the comparison alone, reads what the program produced over
every interval it ran and judges it against the plain reference.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np

from bench import judge, reference, tracing, traffic


def make_stage(config: dict, device: str, bench=reference.BENCH):
    """The program's keyed stage, as the configuration states it."""
    from repro_torch.core.balancer import (Assignment, BalanceConfig,
                                           Hash32)
    from repro_torch.core.controller import RebalanceController
    from repro_torch.streams import operators
    from repro_torch.streams.engine import KeyedStage
    op = reference.load_operator(config["operator"], bench)
    controller = RebalanceController(
        Assignment(Hash32(config["tasks"], seed=config.get("hash_seed", 0))),
        BalanceConfig(theta_max=config["theta_max"],
                      table_max=config["table_max"],
                      window=config["window"]),
        algorithm=config.get("algorithm", "mixed"),
        stats_mode=config.get("stats_mode", "exact"))
    return KeyedStage(
        getattr(operators, op.PROGRAM)(**config.get("operator_args", {})),
        controller, window=config["window"],
        migration_bandwidth=config.get("migration_bandwidth", 1e6),
        state_backend=config.get("state_backend", "device"),
        substrate="kernels", device=device)


class Recorder:
    """Keeps, per interval, the routing table in force, the assignment
    version and the dense F(k) the stage published: references, and a copy
    of a table only when its version moves."""

    def __init__(self, stage):
        self.stage = stage
        self.tables: List[Dict[int, int]] = []
        self.versions: List[int] = []
        self.dense: List[Optional[np.ndarray]] = []
        self._version = None
        self._table: Dict[int, int] = {}

    def before(self) -> None:
        ctrl = self.stage.controller
        if ctrl.assignment_version != self._version:
            self._version = ctrl.assignment_version
            self._table = dict(ctrl.assignment.table)
        self.versions.append(self._version)
        self.tables.append(self._table)

    def after(self) -> None:
        cache = getattr(self.stage.backend, "_dest_dense_cache", None)
        self.dense.append(None if cache is None else cache[2])


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def observe(stage, rec: Recorder, keys: List[np.ndarray]) -> judge.Observed:
    fleet = stage.backend.fleet
    return judge.Observed(
        keys=keys, tables=rec.tables,
        versions=rec.versions + [stage.controller.assignment_version],
        dense=rec.dense, reports=list(stage.reports),
        final_table=dict(stage.controller.assignment.table),
        outputs=stage.outputs, emitted=stage.emitted_sum,
        ring_vals=_host(fleet.vals), ring_pres=_host(fleet.pres),
        owners=fleet.task[:fleet.domain].copy())


def _build_kernels(device: str) -> dict:
    """Build the routing kernel's library where the checkout has none yet
    (a fixed path inside the checkout, so later runs find it)."""
    if not device.startswith("cuda"):
        return {}
    from repro_torch.kernels import _build
    built = _build.library_path("routing_lookup").exists()
    t0 = time.perf_counter()
    _build.build(["routing_lookup"])
    return {"kernel_build_s": 0.0 if built else time.perf_counter() - t0}


def run(ctx) -> dict:
    cfg, run, sync, log = ctx.cell.config, ctx.run, ctx.sync, ctx.log
    bench = ctx.cell.root / "bench"
    import repro_torch.streams.engine  # noqa: F401  (the program, first)
    setup = run.setup = _build_kernels(ctx.device)
    t0 = time.perf_counter()
    source = traffic.Traffic(ctx.cell.traffic, cfg["keys"], cfg["tasks"],
                             cfg.get("hash_seed", 0),
                             cfg["tuples_per_interval"], ctx.seed)
    setup["traffic_s"] = time.perf_counter() - t0
    stage = (ctx.stage_factory or make_stage)(cfg, ctx.device, bench)
    rec = Recorder(stage)
    handed: List[np.ndarray] = []

    def step(keys: np.ndarray) -> None:
        handed.append(keys)
        rec.before()
        stage.process_interval_arrays(keys)
        rec.after()
        sync()

    t0 = time.perf_counter()
    warm = int(cfg["window"]) + 1
    for i in range(warm):
        step(source.interval(i))
    setup["warmup_s"] = time.perf_counter() - t0

    first = len(stage.reports)
    gaps = []
    op = reference.load_operator(cfg["operator"], bench)
    with ctx.window(getattr(op, "SPANS", {})) as mark:
        opened = done = time.perf_counter()
        i = warm
        while done - opened < ctx.seconds or not run.intervals:
            t0 = time.perf_counter()
            gaps.append((t0 - done) * 1e3)
            with mark(tracing.INTERVAL_MARK):
                step(source.interval(i))
            done = time.perf_counter()
            run.interval_ms.append((done - t0) * 1e3)
            run.tuples += int(handed[-1].size)
            run.intervals += 1
            i += 1
        run.window_s = done - opened
    run.reports = stage.reports[first:]
    log(f"setup: {run.setup_s:.4f} s ({json.dumps(setup)})")
    log(f"source: {len(source.cycle)} pre-drawn intervals handed forth and "
        f"back; between one interval's return and the next's hand-off "
        f"max {max(gaps[1:], default=0.0):.4f} ms, "
        f"sum {sum(gaps[1:]):.4f} ms")
    log(f"window: {run.intervals} intervals, {run.tuples} tuples in "
        f"{run.window_s:.4f} s; interval ms: "
        f"{json.dumps([round(x, 3) for x in run.interval_ms])}")

    t0 = time.perf_counter()
    checks = source.checks(warm)
    for keys in checks:
        step(keys)
    log(f"checks: {len(checks)} intervals of the seed's own counts after "
        f"the window in {time.perf_counter() - t0:.4f} s")
    obs = observe(stage, rec, handed)
    del stage
    t0 = time.perf_counter()
    found, failed = judge.judge(cfg, obs, first_window=warm, bench=bench)
    log(f"reference: {len(handed)} intervals replayed in "
        f"{time.perf_counter() - t0:.4f} s")
    return {"checks": found, "failed": failed,
            "attempted": run.intervals + len(checks)}
