"""Deterministic failure injection + restore-and-replay recovery.

The engine exposes exactly two crash sites through the ``stage.failpoint``
seam (see :class:`~repro_torch.streams.engine.KeyedStage`):

* ``"deliver"`` — the interval's traffic has arrived but *nothing* has
  mutated yet (``process_interval_arrays`` entry, before the backend
  dispatch). A kill here models a task dying between intervals.
* ``"mid"`` — keyed state has been mutated for the interval but no report
  was produced (reference loop: after replay/clear_pause, before the ring
  advances; vectorized backends: after state mutation, before
  ``_finish_interval``). A kill here models a task dying mid-interval, the
  hard case: the half-applied interval must be discarded wholesale.

Faults are *declared*, not random: a :class:`FaultPlan` lists frozen fault
records pinned to intervals, the :class:`FaultInjector` fires each exactly
once (stalls: ``attempts`` times), and recovery is therefore convergent —
replaying a buffered interval does not re-trigger the fault that killed it.

:class:`ChaosRunner` closes the loop: it buffers every delivered interval,
checkpoints the stage at a fixed cadence through
:mod:`repro_torch.streams.checkpoint`, and on any detected failure restores
the last checkpoint and replays the buffered intervals. The resulting
:class:`~repro_torch.streams.engine.IntervalReport` stream is
**bit-identical** to a fault-free run of the same traffic — the
recovery-lossless property ``tests/test_torch_faults.py`` pins on the
object, columnar and device backends, against the JAX package's runner.

Delivery faults (:class:`DropDelivery` / :class:`DuplicateDelivery`) live at
the runner level — the "network" delivers an interval zero or two times —
and are detected by epoch mismatch: after the deliveries, the stage clock
does not equal the expected interval, so the runner restores and replays.
Exactly-once interval semantics are thus *recovered*, not assumed.

Like :mod:`repro_torch.streams.checkpoint`, this module duck-types the
stage — no engine import, numpy and the standard library only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .checkpoint import CheckpointStore, checkpoint_stage, restore_stage

__all__ = [
    "TaskKilled", "TaskStalled",
    "KillTask", "StallTask", "DropDelivery", "DuplicateDelivery",
    "FaultPlan", "FaultInjector", "RecoveryEvent", "ChaosRunner",
]

FAIL_SITES = ("deliver", "mid")


class TaskKilled(RuntimeError):
    """A task crashed at an engine crash site; the interval is lost."""

    def __init__(self, task: int, interval: int, site: str):
        super().__init__(f"task {task} killed at interval {interval} "
                         f"(site={site!r})")
        self.task = task
        self.interval = interval
        self.site = site


class TaskStalled(RuntimeError):
    """A task's store stalled (transient): the attempt fails, retries heal."""

    def __init__(self, task: int, interval: int, site: str):
        super().__init__(f"task {task} stalled at interval {interval} "
                         f"(site={site!r})")
        self.task = task
        self.interval = interval
        self.site = site


@dataclasses.dataclass(frozen=True)
class KillTask:
    """Kill task ``task`` at interval ``interval``, at crash site ``site``."""

    interval: int
    task: int = 0
    site: str = "mid"

    def __post_init__(self):
        if self.site not in FAIL_SITES:
            raise ValueError(f"unknown fail site {self.site!r}; "
                             f"choose from {FAIL_SITES}")


@dataclasses.dataclass(frozen=True)
class StallTask:
    """Stall task ``task`` at interval ``interval`` for ``attempts`` tries.

    Fires at the ``deliver`` site (a stalled store refuses the interval's
    traffic); the delivery succeeds once ``attempts`` failures have burned
    off — modelling a transiently wedged store that heals under retry.
    """

    interval: int
    task: int = 0
    attempts: int = 2

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")


@dataclasses.dataclass(frozen=True)
class DropDelivery:
    """The interval's traffic is never delivered (0 deliveries)."""

    interval: int


@dataclasses.dataclass(frozen=True)
class DuplicateDelivery:
    """The interval's traffic is delivered twice (at-least-once network)."""

    interval: int


@dataclasses.dataclass
class RecoveryEvent:
    """One restore-and-replay episode, for assertions and benchmarks."""

    interval: int                  # the interval whose processing failed
    kind: str                      # "kill@mid", "stall@deliver", "drop", ...
    replayed: int                  # buffered-interval deliveries replayed


class FaultPlan:
    """A deterministic schedule of faults, each consumed exactly once."""

    def __init__(self, faults: Sequence[Any] = ()):
        self.faults: List[Any] = list(faults)
        for f in self.faults:
            if not isinstance(f, (KillTask, StallTask, DropDelivery,
                                  DuplicateDelivery)):
                raise TypeError(f"unknown fault type: {f!r}")
        self._delivery = {}
        for f in self.faults:
            if isinstance(f, DropDelivery):
                self._delivery[f.interval] = (0, "drop")
            elif isinstance(f, DuplicateDelivery):
                self._delivery[f.interval] = (2, "duplicate")

    def take_delivery_fault(self, interval: int) -> Tuple[int, Optional[str]]:
        """(deliveries, kind) for this interval; the fault is consumed."""
        return self._delivery.pop(interval, (1, None))


class FaultInjector:
    """Installable ``stage.failpoint`` that fires a plan's in-engine faults.

    Kills fire exactly once (the ``fired`` set survives restores — the
    injector lives outside the stage, like a real environment does), so a
    recovery replay of the same interval runs clean. Stalls fire up to
    ``attempts`` times and then heal.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired: set = set()
        self._stall_tries: dict = {}

    def install(self, stage) -> "FaultInjector":
        stage.failpoint = self
        return self

    def __call__(self, site: str, stage) -> None:
        # "deliver" fires before begin_interval, "mid" after it
        iv = stage._interval + 1 if site == "deliver" else stage._interval
        for f in self.plan.faults:
            if (isinstance(f, KillTask) and f.interval == iv
                    and f.site == site and f not in self.fired):
                self.fired.add(f)
                raise TaskKilled(f.task, iv, site)
            if (isinstance(f, StallTask) and f.interval == iv
                    and site == "deliver"):
                tries = self._stall_tries.get(f, 0)
                if tries < f.attempts:
                    self._stall_tries[f] = tries + 1
                    raise TaskStalled(f.task, iv, site)


class ChaosRunner:
    """Checkpoint + buffer + restore-and-replay runner for one stage.

    Wraps ``stage.process_interval_arrays`` with the full recovery loop:

    1. buffer the interval's traffic (the upstream replay log);
    2. deliver it through the fault plan's delivery schedule;
    3. on a caught kill/stall or a detected epoch mismatch, restore the
       last checkpoint and replay every buffered interval up to and
       including the failed one — retrying from the checkpoint if a fault
       fires *during* replay — then resume;
    4. at ``checkpoint_every`` boundaries, snapshot the stage (optionally
       persisting through a
       :class:`~repro_torch.streams.checkpoint.CheckpointStore`) and trim
       the replay buffer.

    ``events`` records every recovery episode. With ``plan=None`` the
    runner degrades to a checkpoint-overhead harness (no faults injected).
    """

    def __init__(self, stage, plan: Optional[FaultPlan] = None,
                 checkpoint_every: int = 2,
                 store: Optional[CheckpointStore] = None):
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        self.stage = stage
        self.plan = plan if plan is not None else FaultPlan()
        self.checkpoint_every = checkpoint_every
        self.store = store
        self.injector = FaultInjector(self.plan).install(stage)
        self.events: List[RecoveryEvent] = []
        self._buffer: List[Tuple[int, np.ndarray, Optional[np.ndarray]]] = []
        # interval-0 baseline: recovery works even before the first cadence
        self._ckpt = checkpoint_stage(stage)
        if self.store is not None:
            self.store.save(self._ckpt)

    # -- driving ---------------------------------------------------------------
    def process_interval(self, keys: np.ndarray,
                         values: Optional[np.ndarray] = None):
        """Deliver one interval under the fault plan; returns its report."""
        iv = self.stage._interval + 1
        bkeys = np.asarray(keys, dtype=np.int64).copy()
        bvals = None if values is None else np.asarray(values).copy()
        self._buffer.append((iv, bkeys, bvals))
        deliveries, kind = self.plan.take_delivery_fault(iv)
        fault: Optional[str] = None
        try:
            for _ in range(deliveries):
                self.stage.process_interval_arrays(bkeys, bvals)
        except TaskKilled as e:
            fault = f"kill@{e.site}"
        except TaskStalled as e:
            fault = f"stall@{e.site}"
        if fault is None and self.stage._interval != iv:
            # 0 or 2 deliveries left the stage clock out of step with the
            # source epoch — exactly-once is violated, recover it
            fault = kind or "epoch-mismatch"
        if fault is None:
            self._maybe_checkpoint(iv)
        else:
            self._recover(iv, fault)
        return self.stage.reports[-1]

    # -- recovery --------------------------------------------------------------
    def _recover(self, upto: int, kind: str) -> None:
        """Restore the last checkpoint, replay the buffer through ``upto``."""
        replayed = 0
        while True:
            restore_stage(self.stage, self._ckpt)
            try:
                for biv, bkeys, bvals in self._buffer:
                    if biv <= self.stage._interval:
                        continue          # covered by the checkpoint
                    if biv > upto:
                        break
                    self.stage.process_interval_arrays(bkeys, bvals)
                    replayed += 1
            except (TaskKilled, TaskStalled):
                continue                  # a fault fired mid-replay: retry
            if self.stage._interval == upto:
                break
        self.events.append(RecoveryEvent(interval=upto, kind=kind,
                                         replayed=replayed))
        self._maybe_checkpoint(upto)

    def _maybe_checkpoint(self, interval: int) -> None:
        if interval % self.checkpoint_every != 0:
            return
        self._ckpt = checkpoint_stage(self.stage)
        if self.store is not None:
            self.store.save(self._ckpt)
        # intervals at or before the snapshot can never be replayed again
        self._buffer = [b for b in self._buffer if b[0] > interval]

    # -- introspection ---------------------------------------------------------
    @property
    def reports(self):
        return self.stage.reports

    def buffered_intervals(self) -> List[int]:
        return [iv for iv, _, _ in self._buffer]
