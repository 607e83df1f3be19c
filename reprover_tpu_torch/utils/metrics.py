"""Metric writers: the counterpart of :mod:`reprover_tpu.utils.metrics`.

A copy of the JAX package's writers (importing that module runs
``reprover_tpu/utils/__init__.py``, which imports JAX and Orbax). Values are
host floats; the training loop syncs the device only at its log interval.
``metrics.jsonl`` keeps the JAX package's records and keys (``loss``,
``steps_per_sec``, ``Recall@k_val``, ``MRR``, ...). The WandB sink
(:class:`WandbWriter`, ``make_writer(wandb_project=...)``) needs the
``wandb`` package, which the port does not bundle: without it the factory
logs a warning and keeps the other writers, as the JAX package's does.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

Scalars = Dict[str, float]
TextRows = List[Dict[str, str]]


class MetricWriter:
    def write(self, step: int, scalars: Scalars) -> None:
        raise NotImplementedError

    def write_text(self, step: int, key: str, rows: TextRows) -> None:
        """Log a small table of text samples. Optional."""

    def write_hparams(self, hparams: Dict) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlWriter(MetricWriter):
    """Append one JSON object per write — the durable experiment log."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, "a")

    def write(self, step: int, scalars: Scalars) -> None:
        rec = {"step": step, "time": time.time(), **scalars}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def write_text(self, step: int, key: str, rows: TextRows) -> None:
        rec = {"step": step, "text_table": key, "rows": rows}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def write_hparams(self, hparams: Dict) -> None:
        self._f.write(json.dumps({"hparams": hparams}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class StdoutWriter(MetricWriter):
    def __init__(self, every: int = 1) -> None:
        self.every = every

    def write(self, step: int, scalars: Scalars) -> None:
        if step % self.every == 0:
            parts = ", ".join(f"{k}={v:.6g}" for k, v in scalars.items())
            logger.info("step %d: %s", step, parts)


class WandbWriter(MetricWriter):
    """WandB sink, parity with the reference's logger config; requires the
    ``wandb`` package (not bundled — gated)."""

    def __init__(self, project: str, name: Optional[str] = None) -> None:
        import wandb  # gated import

        self._wandb = wandb
        self.run = wandb.init(project=project, name=name)

    def write(self, step: int, scalars: Scalars) -> None:
        self._wandb.log(scalars, step=step)

    def write_text(self, step: int, key: str, rows: TextRows) -> None:
        if not rows:
            return
        cols = list(rows[0].keys())
        table = self._wandb.Table(columns=cols, data=[[r.get(c, "") for c in cols] for r in rows])
        self._wandb.log({key: table}, step=step)

    def write_hparams(self, hparams: Dict) -> None:
        self.run.config.update(hparams, allow_val_change=True)

    def close(self) -> None:
        self._wandb.finish()


class MultiWriter(MetricWriter):
    def __init__(self, writers: List[MetricWriter]) -> None:
        self.writers = writers

    def write(self, step: int, scalars: Scalars) -> None:
        for w in self.writers:
            w.write(step, scalars)

    def write_text(self, step: int, key: str, rows: TextRows) -> None:
        for w in self.writers:
            w.write_text(step, key, rows)

    def write_hparams(self, hparams: Dict) -> None:
        for w in self.writers:
            w.write_hparams(hparams)

    def close(self) -> None:
        for w in self.writers:
            w.close()


def make_writer(
    log_dir: Optional[str],
    wandb_project: Optional[str] = None,
    stdout_every: int = 50,
) -> MetricWriter:
    """Stdout every ``stdout_every`` steps, plus ``log_dir/metrics.jsonl``,
    plus WandB under ``wandb_project`` when the ``wandb`` package is there
    (a warning and no WandB when it is not)."""
    writers: List[MetricWriter] = [StdoutWriter(stdout_every)]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        writers.append(JsonlWriter(os.path.join(log_dir, "metrics.jsonl")))
    if wandb_project:
        try:
            writers.append(WandbWriter(wandb_project))
        except ImportError:
            logger.warning("wandb not installed; skipping WandB logging")
    return MultiWriter(writers)
