"""The training loop: the counterpart of :mod:`reprover_tpu.training.loop`.

Same semantics as the JAX package's ``Trainer``:

- one train step per batch; the loss is read on the host (a device sync)
  only every ``log_interval`` steps, with ``steps_per_sec`` over that
  window;
- validation every ``val_interval`` steps through a task callback, then a
  checkpoint (kept as latest even when the monitored key is absent);
- early stopping on the monitored metric after ``patience`` checks without
  improvement, a graceful wall-clock limit, and the divergence guard;
- a final validation and checkpoint when the last step is not a
  validation step.

Batches are the collated numpy dicts of the data module; the loop moves
their arrays to ``device`` (:func:`numeric_batch`).

Under a data-parallel mesh every rank runs this loop on the same global
batches (the train step takes each rank's rows). Every rank calls the
validation callback (its collectives need them all) and takes the
metrics of the rank at ``data`` coordinate 0, so every rank stops, early
or at the time limit, at the same step; that rank alone writes the
checkpoints, in the one-card layout.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Dict, Iterable, Optional

from reprover_tpu_torch.parallel.collectives import broadcast_object
from reprover_tpu_torch.parallel.mesh import is_first_rank
from reprover_tpu_torch.training.tasks import TrainState, numeric_batch
from reprover_tpu_torch.utils.checkpoint import CheckpointManager
from reprover_tpu_torch.utils.metrics import MetricWriter

logger = logging.getLogger(__name__)

ValidateFn = Callable[[TrainState, int], Dict[str, float]]


@dataclasses.dataclass
class TrainerConfig:
    max_steps: int = 800_000
    val_interval: int = 5_000  # steps between validations
    log_interval: int = 50
    monitor: str = "Recall@10_val"
    monitor_mode: str = "max"
    patience: int = 5  # early-stopping checks without improvement
    ckpt_dir: Optional[str] = None
    resume: bool = False
    # Graceful wall-clock budget: fit() stops after the first train step
    # that crosses it, so the final validation and checkpoint still run.
    time_limit_s: Optional[float] = None
    # Divergence guard (training/health.py): abort with DivergenceError when
    # the loss EMA stays above factor x its running min for
    # `divergence_patience` consecutive log windows. None disables.
    divergence_factor: Optional[float] = None
    divergence_patience: int = 6


class Trainer:
    """Drive (train_step, loader, validate) to completion."""

    def __init__(
        self,
        config: TrainerConfig,
        train_step: Callable,  # (state, batch) -> (state, loss tensor)
        writer: MetricWriter,
        validate_fn: Optional[ValidateFn] = None,
        on_train_batch_end: Optional[Callable[[], None]] = None,
        device: Any = "cuda",
        mesh: Any = None,
    ) -> None:
        self.config = config
        self.train_step = train_step
        self.writer = writer
        self.validate_fn = validate_fn
        self.on_train_batch_end = on_train_batch_end
        self.device = device
        self.mesh = mesh if mesh is not None and mesh.spans("data") else None
        self.ckpt: Optional[CheckpointManager] = None
        if config.ckpt_dir:
            self.ckpt = CheckpointManager(
                config.ckpt_dir, monitor=config.monitor, mode=config.monitor_mode,
                writer=is_first_rank(self.mesh),
            )

    def _agreed(self, value: Any) -> Any:
        """``value`` of the rank at ``data`` coordinate 0, on every rank."""
        return value if self.mesh is None else broadcast_object(value, self.mesh)

    def fit(self, state: TrainState, train_loader: Iterable) -> TrainState:
        cfg = self.config
        step = int(state.step)
        if self.ckpt and cfg.resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
            step = int(state.step)
            logger.info("resumed from checkpoint at step %d", step)

        best = -math.inf if cfg.monitor_mode == "max" else math.inf
        checks_since_improvement = 0
        guard = None
        if cfg.divergence_factor is not None:
            from reprover_tpu_torch.training.health import DivergenceGuard

            guard = DivergenceGuard(factor=cfg.divergence_factor, patience=cfg.divergence_patience)
        t_start = time.monotonic()
        t_last = t_start
        done = False

        while not done:
            epoch_had_batches = False
            for batch in train_loader:
                epoch_had_batches = True
                state, loss = self.train_step(state, numeric_batch(batch, self.device))
                step += 1
                if self.on_train_batch_end is not None:
                    # e.g. mark the corpus embeddings stale.
                    self.on_train_batch_end()

                if step % cfg.log_interval == 0:
                    loss_f = float(loss)  # the one device sync of the window
                    now = time.monotonic()
                    sps = cfg.log_interval / (now - t_last)
                    t_last = now
                    self.writer.write(step, {"loss": loss_f, "steps_per_sec": sps})
                    if guard is not None:
                        # Raises DivergenceError: a non-zero exit before a
                        # poisoned checkpoint is exported.
                        guard.update(step, loss_f)

                if self.validate_fn and step % cfg.val_interval == 0:
                    metrics = self._validate(state, step)
                    # Saved whether or not the monitored key exists: the
                    # manager keeps it as latest; best-tracking and early
                    # stopping engage only when the monitor is present.
                    if self.ckpt:
                        self.ckpt.save(step, state, metrics)
                    current = metrics.get(cfg.monitor)
                    if current is not None:
                        improved = current > best if cfg.monitor_mode == "max" else current < best
                        if improved:
                            best = current
                            checks_since_improvement = 0
                        else:
                            checks_since_improvement += 1
                        if checks_since_improvement >= cfg.patience:
                            logger.info("early stopping: no %s improvement in %d checks",
                                        cfg.monitor, cfg.patience)
                            done = True
                            break
                    # Validation and checkpoint time stay out of the next
                    # steps_per_sec window (it covers train steps only).
                    t_last = time.monotonic()
                if step >= cfg.max_steps:
                    done = True
                    break
                if cfg.time_limit_s is not None and self._agreed(
                        time.monotonic() - t_start >= cfg.time_limit_s):
                    logger.info("time limit reached (%.0fs) at step %d — stopping",
                                cfg.time_limit_s, step)
                    done = True
                    break
            if not epoch_had_batches:
                break  # empty loader — nothing to train on

        if self.validate_fn and step % cfg.val_interval != 0:
            metrics = self._validate(state, step)
            if self.ckpt:
                self.ckpt.save(step, state, metrics)
        if self.ckpt:
            self.ckpt.wait()
        return state

    def _validate(self, state: TrainState, step: int) -> Dict[str, float]:
        metrics = self._agreed(self.validate_fn(state, step))
        self.writer.write(step, metrics)
        return metrics
