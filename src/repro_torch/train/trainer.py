"""Training loop: checkpoint/restart, the straggler watchdog and SkewShield
MoE placement updates — the JAX package's ``train/trainer.py``, on one
device or, with ``mesh``, on DTensors over a device mesh (each rank runs
the same trainer; the parameters are laid out by ``param_shardings``, the
optimizer state as they are, and every step runs under
``sharding.ctx.use_mesh``). Under a mesh a checkpoint holds the full
tensors, gathered on every rank and written by rank 0, and a restore lays
them out again; a SkewShield move permutes the gathered expert weights and
writes each rank's shards back.

Two differences from the JAX package, each a fault of the reference that
the port does not copy:

* **Loads by logical expert.** A step's ``expert_load`` counts entries per
  *physical* slot (``models.moe``), while ``SkewShieldPlacer.update`` takes
  loads per *logical* expert. The JAX trainer passes the physical loads as
  they come, which is right only until the first move. Here each layer's
  loads are mapped back before the update: ``logical = physical[placement]``
  (``placement[l]`` is logical expert ``l``'s slot).
* **Placements in the checkpoint.** The JAX trainer saves the parameters
  and the optimizer state, whose expert slices SkewShield has permuted, but
  not the placements, so after ``try_resume`` every placer starts again at
  the identity and each token reaches another expert's weights. Here the
  checkpoint also holds, per layer, the placement and the placer's routing
  table (its controller's overrides, which its next plan starts from), and
  ``try_resume`` restores both.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import Assignment
from ..models import model_schema, schema
from ..models.config import ModelConfig
from ..models.skewshield import (SkewShieldPlacer, permute_expert_params,
                                 placements_array)
from ..sharding import ctx as shard_ctx
from ..sharding import rules
from ..sharding.local import is_dtensor
from ..streams.device import resolve_device
from .checkpoint import CheckpointManager
from .optimizer import OptConfig, opt_init, opt_shardings
from .train_step import make_train_step

_EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    rebalance_every: int = 10          # SkewShield interval (steps)
    microbatches: int = 1
    log_every: int = 10
    straggler_factor: float = 3.0      # step-time watchdog threshold
    skewshield: bool = True
    theta_max: float = 0.1


class Trainer:
    """``data_fn(step)`` returns the step's batch, {"tokens", "labels"} and
    any front-end input (``frames``, ``pixel_embeds``), as tensors or numpy
    arrays (moved to ``device``; integer ones as int64, floating ones in
    their dtype). Parameters come from
    ``schema.init`` with a generator seeded ``seed`` on ``device`` (None =
    the CUDA card)."""

    def __init__(self, cfg: ModelConfig, opt_cfg: OptConfig,
                 tcfg: TrainerConfig, checkpoint_dir: str,
                 data_fn: Callable[[int], Dict[str, Any]],
                 seed: int = 0, device=None, mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.data_fn = data_fn
        self.device = resolve_device(device)
        self.mesh = mesh
        self.schema = model_schema(cfg)
        self.params = schema.init(
            self.schema, torch.Generator(device=self.device).manual_seed(seed),
            self.device)
        if mesh is not None:
            self.shardings = rules.param_shardings(self.schema, mesh)
            self.params = schema.distribute(self.params, self.shardings)
        self.opt_state = opt_init(self.params)
        self.ckpt = CheckpointManager(checkpoint_dir)
        self.step_fn = make_train_step(
            cfg, opt_cfg, microbatches=tcfg.microbatches,
            collect_moe=tcfg.skewshield and cfg.moe_experts > 0)
        self.step = 0
        self.history: List[Dict[str, float]] = []
        self.step_times: List[float] = []
        self.placers: List[SkewShieldPlacer] = []
        if cfg.moe_experts and tcfg.skewshield:
            bytes_per_expert = 3 * cfg.d_model * cfg.d_ff * 2.0
            n_shards = min(cfg.moe_experts, 16)
            # shards must divide experts for the slot layout
            while cfg.moe_experts % n_shards:
                n_shards -= 1
            self.placers = [SkewShieldPlacer(cfg.moe_experts, n_shards,
                                             bytes_per_expert,
                                             theta_max=tcfg.theta_max)
                            for _ in range(cfg.n_layers)]

    # -------------------------------------------------------------- resume
    def _state(self) -> Dict[str, Any]:
        state = {"params": self.params, "opt": self.opt_state}
        if self.placers:
            state["skewshield"] = {
                "placement": torch.from_numpy(np.stack(
                    [p.placement for p in self.placers]).astype(np.int32)),
                "table": torch.from_numpy(np.stack(
                    [self._table(p) for p in self.placers])),
            }
        return state

    @staticmethod
    def _table(placer: SkewShieldPlacer) -> np.ndarray:
        """The placer's routing-table overrides as (E, 2) rows of (expert,
        shard) in the table's order, padded with -1."""
        rows = np.full((placer.e, 2), -1, np.int64)
        table = placer.controller.assignment.table
        if table:
            rows[:len(table)] = np.asarray(list(table.items()), np.int64)
        return rows

    def try_resume(self) -> bool:
        try:
            step, state, _ = self.ckpt.restore(self._state())
        except (FileNotFoundError, ValueError):
            return False
        self.params, self.opt_state = state["params"], state["opt"]
        if self.mesh is not None:
            self.params = schema.distribute(self.params, self.shardings)
            self.opt_state = schema.distribute(
                self.opt_state, opt_shardings(self.shardings, self.mesh))
        if self.placers:
            sk = state["skewshield"]
            for placer, placement, table in zip(
                    self.placers, sk["placement"].numpy(),
                    sk["table"].numpy()):
                placer.placement = placement.astype(np.int32)
                ctrl = placer.controller
                ctrl.assignment = Assignment(
                    ctrl.assignment.hash_router,
                    {int(e): int(d) for e, d in table if e >= 0})
        self.step = step
        return True

    # ------------------------------------------------------------ main loop
    def placements(self) -> Optional[torch.Tensor]:
        if not self.placers:
            return None
        return placements_array(self.placers, self.device)

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in self.data_fn(step).items():
            v = torch.as_tensor(v)
            out[k] = v.to(self.device,
                          None if v.is_floating_point() else torch.long)
        return out

    def run(self, steps: Optional[int] = None) -> List[Dict[str, float]]:
        steps = steps if steps is not None else self.tcfg.total_steps
        end = self.step + steps
        while self.step < end:
            batch = self._batch(self.step)
            t0 = time.perf_counter()
            with shard_ctx.use_mesh(self.mesh):
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch, self.placements())
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step += 1
            self.step_times.append(dt)
            rec = {"step": self.step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "time_s": dt}
            self.history.append(rec)
            self._watchdog(dt)
            if self.placers and self.step % self.tcfg.rebalance_every == 0 \
                    and "expert_load" in metrics:
                self._rebalance_experts(metrics["expert_load"].cpu().numpy())
            if self.step % self.tcfg.checkpoint_every == 0:
                self.save()
        return self.history

    def save(self):
        state = self._state()
        if self.mesh is not None:
            import torch.distributed as dist
            state = schema.tree_map(
                lambda t: t.full_tensor() if is_dtensor(t) else t, state)
            if dist.get_rank() != 0:
                return
        self.ckpt.save(self.step, state, meta={"arch": self.cfg.name})

    # -------------------------------------------------- fleet health hooks
    def _watchdog(self, dt: float) -> None:
        """Straggler detection: a step far beyond the trailing median flags a
        slow worker; the balancer-level response (derate_worker) lives in the
        controller — here we record the event for the ops plane."""
        if len(self.step_times) < 8:
            return
        med = float(np.median(self.step_times[-8:]))
        if dt > self.tcfg.straggler_factor * med:
            self.history[-1]["straggler_suspect"] = True

    # ----------------------------------------------------- SkewShield hook
    @torch.no_grad()
    def _rebalance_experts(self, expert_load: np.ndarray) -> None:
        """expert_load: (n_groups, moe_per_group, E) accumulated loads by
        physical slot."""
        period = self.cfg.pattern_period
        moe_js = [j for j in range(period) if self.cfg.layer_is_moe(j)]
        n_groups = self.cfg.n_layers // period
        for g in range(n_groups):
            for mi, j in enumerate(moe_js):
                placer = self.placers[g * period + j]
                old = placer.placement.copy()
                upd = placer.update(expert_load[g, mi][old])
                if len(upd.moved_experts):
                    # weights AND optimizer moments move with the expert —
                    # Adam state must stay aligned with its parameter.
                    trees = [self.params["groups"][f"sub{j}"]["moe"]] + [
                        self.opt_state[k]["groups"][f"sub{j}"]["moe"]
                        for k in ("m", "v", "master")]
                    for tree in trees:
                        here = {name: tree[name][g]
                                for name in _EXPERT_WEIGHTS}
                        moved = permute_expert_params(
                            {name: _full(w) for name, w in here.items()},
                            old, upd.placement)
                        for name, w in here.items():
                            w.copy_(_like(moved[name], w))


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def _like(full: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as the DTensor ``t`` (``full`` itself for a
    tensor)."""
    if not is_dtensor(t):
        return full
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, t.device_mesh, t.placements)
