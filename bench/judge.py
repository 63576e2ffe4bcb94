"""The comparison that decides ``correct``: what the program produced over
every interval it ran, against the plain reference replayed over the same
intervals.

The program's outputs are read, never used: the routing tables it published
are judged (their keys lie in the key domain, their destinations among the
tasks) and the reference works out F(k) from them again, and with it
everything that follows: each interval's per-task loads, the migrated bytes,
the destinations the routing kernel published, the owner of every held key,
the window ring with its evictions, each key's last output and the sum of
all emits.

Every number compared is a count of wrong answers or a gap, and has a limit
of its own, which the configuration file states.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .reference import BENCH, ReferenceStage, theta

#: the numbers compared, in the order they are printed
CHECKS = ("tuples_wrong", "loads_gap", "migrated_bytes_gap", "dest_wrong",
          "owner_wrong", "ring_wrong", "outputs_wrong", "emitted_gap",
          "table_wrong", "trigger_wrong")
#: a theta this close to theta_max decides no trigger either way
_THETA_TIE = 1e-12


@dataclasses.dataclass
class Observed:
    """What the program produced, read from it after the window closed.

    Per interval ``t`` it ran (warm-up included): ``keys[t]`` the tuples it
    was meant to get, ``tables[t]`` the routing table in force, ``versions``
    its assignment version before each interval and after the last,
    ``dense[t]`` the dense F(k) it published for the interval (None where
    it published none) and ``reports[t]`` its report. Then its state after
    the last interval: the final table, the last output of each key, the
    sum of emits, the window ring (``ring_vals``, ``ring_pres``, columns by
    interval modulo window + 1) and each key's owner (-1 = not held).
    """

    keys: List[np.ndarray]
    tables: List[Dict[int, int]]
    versions: List[int]
    dense: List[Optional[np.ndarray]]
    reports: list
    final_table: Dict[int, int]
    outputs: Dict[int, float]
    emitted: float
    ring_vals: np.ndarray
    ring_pres: np.ndarray
    owners: np.ndarray


def _table_wrong(table: Dict[int, int], cfg: dict) -> int:
    if not table:
        return 0
    tk = np.fromiter(table.keys(), dtype=np.int64, count=len(table))
    td = np.fromiter(table.values(), dtype=np.int64, count=len(table))
    return int(((tk < 0) | (tk >= cfg["keys"])).sum()
               + ((td < 0) | (td >= cfg["tasks"])).sum())


def reference_for(cfg: dict, bench: Path = BENCH) -> ReferenceStage:
    args = cfg.get("operator_args", {})
    return ReferenceStage(cfg["operator"], cfg["keys"], cfg["tasks"],
                          cfg["window"], cfg.get("hash_seed", 0), bench,
                          **args)


def judge(cfg: dict, obs: Observed, first_window: int = 0,
          bench: Path = BENCH):
    """Replay every interval through the reference and compare.

    Returns ``(checks, failed)``: each number of :data:`CHECKS`, and how
    many intervals from ``first_window`` on read wrong in their own
    numbers (tuples, loads, migrated bytes, destinations, trigger)."""
    ref = reference_for(cfg, bench)
    lim = cfg["limits"]
    k, n_t = int(cfg["keys"]), len(obs.keys)
    c = dict.fromkeys(CHECKS, 0)
    c["loads_gap"] = c["migrated_bytes_gap"] = c["emitted_gap"] = 0.0
    if len(obs.reports) != n_t or len(obs.tables) != n_t:
        raise ValueError("one report and one table per interval expected")
    failed = 0
    for t in range(n_t):
        wrong = 0
        table = obs.tables[t]
        c["table_wrong"] += _table_wrong(table, cfg)
        dest = ref.route(table)
        if obs.dense[t] is not None:
            got = np.asarray(obs.dense[t])
            n = int((got[:k] != dest).sum()) + max(0, k - got.size)
            c["dest_wrong"] += n
            wrong += n
        loads, moved, _ = ref.step(obs.keys[t], table, dest)
        rep = obs.reports[t]
        if int(rep.tuples) != int(obs.keys[t].size):
            c["tuples_wrong"] += 1
            wrong += 1
        got_loads = np.asarray(rep.task_loads, dtype=np.float64)
        if got_loads.shape != loads.shape:
            gap = float("inf")
        else:
            gap = float(np.abs(got_loads - loads).max()
                        / max(float(loads.max()), 1e-300))
        mgap = abs(float(rep.migrated_bytes) - moved)
        gap = gap if np.isfinite(gap) else float("inf")
        mgap = mgap if np.isfinite(mgap) else float("inf")
        c["loads_gap"] = max(c["loads_gap"], gap)
        c["migrated_bytes_gap"] = max(c["migrated_bytes_gap"], mgap)
        wrong += (gap > lim["loads_gap"]) + (mgap > lim["migrated_bytes_gap"])
        th = theta(loads)
        if abs(th - float(cfg["theta_max"])) > _THETA_TIE:
            planned = obs.versions[t + 1] != obs.versions[t]
            if planned != (th > float(cfg["theta_max"])):
                c["trigger_wrong"] += 1
                wrong += 1
        failed += t >= first_window and wrong > 0
    c["table_wrong"] += _table_wrong(obs.final_table, cfg)
    final = ref.route(obs.final_table)
    owners = np.asarray(obs.owners)
    want = np.where(ref.held, final, -1)
    c["owner_wrong"] = int((owners[:k] != want).sum()
                           + (owners[k:] != -1).sum())
    vals, pres = ref.ring(int(cfg["window"]) + 1)
    rv, rp = np.asarray(obs.ring_vals), np.asarray(obs.ring_pres)
    if rv.shape[0] != vals.shape[0] or rv.shape[1] < k:
        c["ring_wrong"] = int(vals.size + pres.size)
    else:
        c["ring_wrong"] = int((rv[:, :k] != vals).sum()
                              + (rp[:, :k] != pres).sum()
                              + np.count_nonzero(rv[:, k:])
                              + np.count_nonzero(rp[:, k:]))
    c["outputs_wrong"] = _outputs_wrong(obs.outputs, ref)
    c["emitted_gap"] = abs(float(obs.emitted) - ref.emitted)
    if not np.isfinite(c["emitted_gap"]):
        c["emitted_gap"] = float("inf")
    return c, int(failed)


def _outputs_wrong(outputs: Dict[int, float], ref: ReferenceStage) -> int:
    ok = np.fromiter(outputs.keys(), dtype=np.int64, count=len(outputs))
    ov = np.fromiter(outputs.values(), dtype=np.float64, count=len(outputs))
    inside = (ok >= 0) & (ok < ref.k)
    wrong = int((~inside).sum())
    ok, ov = ok[inside], ov[inside]
    want = ref.has_output
    got = np.zeros(ref.k, dtype=bool)
    got[ok] = True
    wrong += int((got != want).sum())
    common = want[ok]
    wrong += int((ov[common] != ref.output[ok[common]]).sum())
    return wrong

