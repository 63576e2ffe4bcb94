"""SkewShield: the paper's dynamic key-based partitioning applied to
mixture-of-experts placement — the JAX package's ``models/skewshield.py``.

Mapping: logical experts = keys; expert-parallel shards = task instances;
static placement h(e) = e // (E / n_shards) (contiguous blocks) = the hash
baseline; the routing table = per-expert overrides; state = expert weights,
so migration cost = bytes of experts moved between shards. The controller
runs the Mixed algorithm on measured expert loads at step boundaries. The
resulting placement is an (E,) int32 permutation passed to the forward as a
tensor, so a new plan changes no code path: installing it is a step-boundary
swap plus one gather over the expert dim of the weights.

Slot-count constraint: an (E,) permutation requires every shard to hold
exactly E/S slots, so after the balancer's load-driven plan a count-repair
pass moves the lightest surplus experts to shards with free slots (the
balancer optimizes load; slots are a layout constraint it doesn't know).

``SkewShieldPlacer.update`` takes loads per *logical* expert, while the
forward's ``expert_load`` counts per *physical* slot, as in the JAX package.
Under a placement other than the identity, a caller maps the measured loads
back: ``logical = physical[placement]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import Assignment, BalanceConfig, KeyStats, RebalanceController
from ..core.balancer import metrics
from ..core.balancer.types import HashRouter
from ..streams.device import resolve_device


class BlockRouter(HashRouter):
    """h(e) = e // (E / n_shards): the static contiguous expert layout."""

    def __init__(self, n_experts: int, n_shards: int):
        if n_experts % n_shards:
            raise ValueError(f"{n_experts} experts do not split evenly over "
                             f"{n_shards} shards")
        self.n_experts = n_experts
        self.n_dest = n_shards
        self.per_shard = n_experts // n_shards

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        return np.asarray(keys, np.int64) // self.per_shard

    def with_n_dest(self, n_dest: int) -> "BlockRouter":
        return BlockRouter(self.n_experts, n_dest)


@dataclasses.dataclass
class PlacementUpdate:
    placement: np.ndarray          # (E,) logical expert -> physical slot
    moved_experts: np.ndarray      # logical ids whose shard changed
    migration_bytes: float
    theta_before: float
    theta_after: float
    plan_time_s: float


class SkewShieldPlacer:
    """One placer per MoE layer (or shared, if loads are aggregated)."""

    def __init__(self, n_experts: int, n_shards: int,
                 bytes_per_expert: float,
                 theta_max: float = 0.1, table_max: Optional[int] = None,
                 algorithm: str = "mixed", beta: float = 1.5):
        self.e = n_experts
        self.s = n_shards
        self.per_shard = n_experts // n_shards
        self.bytes_per_expert = bytes_per_expert
        cfg = BalanceConfig(theta_max=theta_max,
                            table_max=table_max if table_max is not None
                            else max(4, n_experts // 2),
                            beta=beta)
        self.controller = RebalanceController(
            Assignment(BlockRouter(n_experts, n_shards)), cfg,
            algorithm=algorithm)
        self.placement = np.arange(n_experts, dtype=np.int32)  # identity

    # ------------------------------------------------------------------ plan
    def shard_of_slot(self, slot: np.ndarray) -> np.ndarray:
        return np.asarray(slot) // self.per_shard

    def current_shards(self) -> np.ndarray:
        """shard of each logical expert under the current placement."""
        return self.shard_of_slot(self.placement)

    def update(self, expert_load: np.ndarray) -> PlacementUpdate:
        """expert_load: (E,) measured tokens per *logical* expert."""
        expert_load = np.asarray(expert_load, np.float64)
        stats = KeyStats(keys=np.arange(self.e, dtype=np.int64),
                         cost=np.maximum(expert_load, 0.0),
                         mem=np.full((self.e,), self.bytes_per_expert))
        shards_before = self.current_shards()
        loads_before = np.bincount(shards_before, weights=expert_load,
                                   minlength=self.s)
        ev = self.controller.on_interval(stats)
        if ev.result is None:                     # balanced already
            return PlacementUpdate(self.placement.copy(),
                                   np.zeros((0,), np.int64), 0.0,
                                   metrics.theta(loads_before),
                                   metrics.theta(loads_before), 0.0)
        want = ev.result.assignment.dest(stats.keys)       # expert -> shard
        want = self._repair_counts(want, expert_load)
        placement = self._slots_from_shards(want)
        moved = np.flatnonzero(self.shard_of_slot(placement)
                               != shards_before)
        loads_after = np.bincount(want, weights=expert_load, minlength=self.s)
        upd = PlacementUpdate(
            placement=placement, moved_experts=moved,
            migration_bytes=float(len(moved)) * self.bytes_per_expert,
            theta_before=metrics.theta(loads_before),
            theta_after=metrics.theta(loads_after),
            plan_time_s=ev.result.plan_time_s)
        self.placement = placement
        return upd

    def _repair_counts(self, want: np.ndarray,
                       load: np.ndarray) -> np.ndarray:
        """Enforce exactly E/S experts per shard, moving lightest first."""
        want = np.asarray(want, np.int64).copy()
        counts = np.bincount(want, minlength=self.s)
        over = [d for d in range(self.s) if counts[d] > self.per_shard]
        under = [d for d in range(self.s) if counts[d] < self.per_shard]
        for d in over:
            members = np.flatnonzero(want == d)
            members = members[np.argsort(load[members])]   # lightest first
            i = 0
            while counts[d] > self.per_shard and under:
                tgt = under[0]
                want[members[i]] = tgt
                counts[d] -= 1
                counts[tgt] += 1
                if counts[tgt] == self.per_shard:
                    under.pop(0)
                i += 1
        return want

    def _slots_from_shards(self, want: np.ndarray) -> np.ndarray:
        """Assign concrete slots, keeping unmoved experts in their old slot
        (minimizes the physical permutation — fewer weights move)."""
        placement = np.full((self.e,), -1, np.int32)
        old_shards = self.current_shards()
        free: Dict[int, List[int]] = {
            d: list(range(d * self.per_shard, (d + 1) * self.per_shard))
            for d in range(self.s)}
        # unmoved experts keep their slots
        for l in range(self.e):
            if want[l] == old_shards[l]:
                slot = int(self.placement[l])
                placement[l] = slot
                free[want[l]].remove(slot)
        for l in range(self.e):
            if placement[l] < 0:
                placement[l] = free[int(want[l])].pop(0)
        return placement


def permute_expert_params(moe_params: dict, old_placement: np.ndarray,
                          new_placement: np.ndarray) -> dict:
    """Physically migrate expert weights to their new slots, on the
    weights' device: ``w_new[new[l]] = w_old[old[l]]``, an ``index_select``
    over the expert dim (the third from last, so a stacked
    (n_groups, E, ...) weight takes one permutation for every group).
    Router weights are logical — untouched."""
    old = np.asarray(old_placement)
    perm = np.empty_like(old)
    perm[np.asarray(new_placement)] = old          # slot_new -> slot_old
    out = dict(moe_params)
    for name in ("w_gate", "w_up", "w_down"):
        w = moe_params[name]
        index = torch.from_numpy(perm.astype(np.int64)).to(w.device)
        out[name] = torch.index_select(w, w.dim() - 3, index)
    return out


def placements_array(placers: List[SkewShieldPlacer],
                     device=None) -> torch.Tensor:
    """(n_layers, E) int32 placement matrix for ``forward(placements=...)``
    on ``device`` (None = the CUDA card; raises without one)."""
    return torch.from_numpy(np.stack([p.placement for p in placers])
                            .astype(np.int32)).to(resolve_device(device))
