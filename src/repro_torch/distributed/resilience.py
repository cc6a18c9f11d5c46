"""Fault tolerance: step retry from checkpoint, straggler detection, and a
deterministic fault injector for tests (the reference's
``distributed/resilience.py`` in PyTorch; it holds no collective).

On a real cluster the failure signal comes from the runtime (a missing
heartbeat, a NCCL timeout); here :class:`FaultInjector` raises
:class:`WorkerFailure` on a scheduled set of steps, and the loop's recovery
path is the production one: restore the latest checkpoint (onto any device:
:meth:`repro_torch.checkpoint.CheckpointManager.restore`) and resume from
the data stream position of the restored step (the batches are a pure
function of (seed, step), so no data is lost or duplicated).  With no
checkpoint yet, a failure resets the step to 0 and keeps the current state,
as the reference's loop does.

Straggler mitigation: :class:`StepMonitor` keeps an EWMA of step wall time
and flags steps slower than ``threshold`` x the average.  The hook is
pluggable; the default action logs and counts.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

logger = logging.getLogger("repro_torch.resilience")

__all__ = ["WorkerFailure", "FaultInjector", "StepMonitor", "run_resilient"]


class WorkerFailure(RuntimeError):
    """Simulated loss of a worker (heartbeat timeout / hardware fault)."""


@dataclass
class FaultInjector:
    fail_at_steps: frozenset[int] = frozenset()
    _fired: set[int] = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise WorkerFailure(f"injected worker failure at step {step}")


@dataclass
class StepMonitor:
    threshold: float = 3.0
    ewma_alpha: float = 0.2
    ewma_s: Optional[float] = None
    stragglers: list[int] = field(default_factory=list)
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self.ewma_s is not None and dt > self.threshold * self.ewma_s:
            is_straggler = True
            self.stragglers.append(step)
            logger.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                           step, dt, self.ewma_s)
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma_s)
        self.ewma_s = (dt if self.ewma_s is None
                       else (1 - self.ewma_alpha) * self.ewma_s
                       + self.ewma_alpha * dt)
        return is_straggler


def _scalar(v) -> float:
    return float(v.item() if torch.is_tensor(v) else v)


def run_resilient(
    *,
    state,                               # initial (params, opt_state, ...)
    step_fn: Callable,                   # (state, batch) -> (state, metrics)
    batch_fn: Callable[[int], object],   # step -> batch (pure in step)
    n_steps: int,
    checkpoint_manager=None,
    checkpoint_every: int = 50,
    injector: Optional[FaultInjector] = None,
    monitor: Optional[StepMonitor] = None,
    max_restarts: int = 8,
    log_every: int = 10,
) -> tuple[object, list[dict]]:
    """Train loop with checkpoint/restart recovery.

    Returns (final state, metrics history).  Each recovery restores the
    latest checkpoint and replays the deterministic data stream from there.
    Reading the metrics (``.item()``) is the step's one synchronisation
    with the device; ``dt`` is the host time of ``step_fn`` before it.
    """
    monitor = monitor or StepMonitor()
    history: list[dict] = []
    step = 0
    restarts = 0
    if (checkpoint_manager is not None
            and checkpoint_manager.latest_step() is not None):
        step, state = checkpoint_manager.restore(state)
        logger.info("resumed from checkpoint step %d", step)

    while step < n_steps:
        try:
            if injector is not None:
                injector.check(step)
            t0 = time.time()
            state, metrics = step_fn(state, batch_fn(step))
            dt = time.time() - t0
            monitor.observe(step, dt)
            rec = {"step": step, "dt": dt,
                   **{k: _scalar(v) for k, v in metrics.items()}}
            history.append(rec)
            if log_every and step % log_every == 0:
                logger.info("step %d: %s", step,
                            {k: round(v, 4) for k, v in rec.items()
                             if k != "step"})
            step += 1
            if checkpoint_manager is not None and step % checkpoint_every == 0:
                checkpoint_manager.save(step, state)
        except WorkerFailure as exc:
            restarts += 1
            logger.warning("%s; recovering (restart %d/%d)", exc, restarts,
                           max_restarts)
            if restarts > max_restarts:
                raise
            if (checkpoint_manager is not None
                    and checkpoint_manager.latest_step() is not None):
                step, state = checkpoint_manager.restore(state)
                logger.info("rolled back to step %d", step)
            else:
                logger.warning("no checkpoint yet; restarting from step 0 "
                               "state")
                step = 0
    if checkpoint_manager is not None:
        checkpoint_manager.save(step, state)
    return state, history
