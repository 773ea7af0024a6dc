"""Fault-tolerant training driver: checkpoint/restart and straggler
detection, the port of ``runtime/fault_tolerance.py``.

  * **Checkpoint/restart** — the driver checkpoints every ``ckpt_every``
    steps (atomic directories, see ``repro_torch.checkpoint``) and on a
    ``StepFailure`` restores the last complete checkpoint and replays. The
    data pipeline is stateless by step, so the replay is exact.
  * **Straggler detection** — per-step wall times feed an EWMA; a step
    slower than ``straggler_factor``× the EWMA is counted and logged.

The reference's elastic re-mesh (``elastic_mesh``, ``reshard_state``)
needs more than one device and waits for ROADMAP item 9.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_leaves

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint

log = logging.getLogger("repro_torch.runtime")


class StepFailure(RuntimeError):
    """Raised by fault-injection hooks to simulate a node failure."""


@dataclasses.dataclass
class StragglerStats:
    ewma: float = 0.0
    alpha: float = 0.2
    factor: float = 3.0
    slow_steps: int = 0
    samples: int = 0

    def observe(self, dt: float) -> bool:
        self.samples += 1
        if self.samples == 1:
            self.ewma = dt
            return False
        slow = dt > self.factor * self.ewma and self.samples > 5
        if slow:
            self.slow_steps += 1
            log.warning("straggler: step took %.3fs (ewma %.3fs)", dt,
                        self.ewma)
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


@dataclasses.dataclass
class DriverConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 10
    straggler_factor: float = 3.0


def _synchronize(state: Any) -> None:
    """Wait for the device of the state's first tensor (step timing)."""
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            return


class TrainDriver:
    """Runs ``step_fn`` over a batch function with full restart semantics.

    step_fn(state, batch) → (state, metrics); ``state`` is one tree
    bundling params/opt/compression so checkpointing is a single tree op.
    """

    def __init__(self, cfg: DriverConfig, step_fn: Callable,
                 init_state: Any,
                 batch_for_step: Callable[[int], Any], *,
                 fault_hook: Callable[[int], None] | None = None,
                 on_restart: Callable[[Any], Any] | None = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = init_state
        self.batch_for_step = batch_for_step
        self.fault_hook = fault_hook
        self.on_restart = on_restart
        self.stragglers = StragglerStats(factor=cfg.straggler_factor)
        self.restarts = 0
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------- restore
    def _resume_step(self) -> int:
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return 0
        self.state = restore_checkpoint(self.cfg.ckpt_dir, step, self.state)
        log.info("restored checkpoint at step %d", step)
        return step

    # ----------------------------------------------------------------- run
    def run(self) -> Any:
        step = self._resume_step()
        while step < self.cfg.total_steps:
            try:
                step = self._run_span(step)
            except StepFailure as e:
                self.restarts += 1
                log.error("step failure at %d: %s (restart %d/%d)", step, e,
                          self.restarts, self.cfg.max_restarts)
                if self.restarts > self.cfg.max_restarts:
                    raise
                if self.on_restart is not None:
                    self.state = self.on_restart(self.state)
                step = self._resume_step()
        return self.state

    def _run_span(self, step: int) -> int:
        while step < self.cfg.total_steps:
            if self.fault_hook is not None:
                self.fault_hook(step)
            batch = self.batch_for_step(step)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            _synchronize(self.state)
            self.stragglers.observe(time.perf_counter() - t0)
            self.metrics_log.append(
                {k: float(v) for k, v in metrics.items()})
            step += 1
            if step % self.cfg.ckpt_every == 0 \
                    or step == self.cfg.total_steps:
                save_checkpoint(self.cfg.ckpt_dir, step, self.state,
                                keep=self.cfg.keep)
        return step
