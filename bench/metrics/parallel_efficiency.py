"""parallel_efficiency: over all intervals of the window,
sum(mean task load) / sum(max task load + migration stall), in %, from the
per-task loads and the migrated bytes of the stage's judged reports (the
engine's cost model; the stall is the bytes over the configuration's
``migration_bandwidth``). The share of the deployment's tasks that the plan
keeps busy."""

import numpy as np


def read(run):
    if not run.reports:
        return None
    bandwidth = float(run.config.get("migration_bandwidth", 1e6))
    mean = sum(float(np.mean(r.task_loads)) for r in run.reports)
    span = sum(float(np.max(r.task_loads)) + r.migrated_bytes / bandwidth
               for r in run.reports)
    return 100.0 * mean / span if span > 0 else None
