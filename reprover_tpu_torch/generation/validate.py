"""Generator validation: CE loss + beam-search Top-k accuracy on the port.

The counterpart of the JAX package's ``generation/validate.py``
(``validation_metrics``), with the parity it keeps with the reference
validation step (`reference/generation/model.py:157-210`): per val batch,
compute the teacher-forced loss and beam-search ``num_beams`` candidates,
then for each k in 1..num_beams count an example correct if any of its
top-k decoded candidates exactly equals the ground-truth tactic (the
reference's ``TopkAccuracy`` torchmetric with sum reduction,
`generation/model.py:25-46`; ``<a>`` marks are stripped on both sides).

``causal_validation_metrics`` does the same for the decoder-only family:
the teacher-forced ``causal_lm_loss`` on ``CausalGeneratorDataModule``
batches and the same beam-search Top-k exact match.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from reprover_tpu_torch.data import remove_marks
from reprover_tpu_torch.training.tasks import generation_loss, numeric_batch

logger = logging.getLogger(__name__)


def validation_metrics(
    model: Any,  # TacticGeneratorModel
    loader: Iterable[Dict[str, Any]],
    num_beams: int = 1,
    limit_batches: Optional[int] = None,
    writer: Any = None,  # Optional[MetricWriter]: emits sample text tables
    step: int = 0,
    num_text_samples: int = 8,
) -> Dict[str, float]:
    """``loss_val`` and ``top{k}_acc_val`` for k in 1..num_beams over the
    first ``limit_batches`` batches of ``loader``."""
    losses = []
    correct = np.zeros(num_beams, dtype=np.int64)
    total = 0
    samples = []

    for i, batch in enumerate(loader):
        if limit_batches is not None and i >= limit_batches:
            break
        tensors = numeric_batch(
            {k: batch[k] for k in ("state_ids", "state_mask", "tactic_ids")}, model.device
        )
        with torch.no_grad():
            losses.append(float(generation_loss(model.params, model.cfg, tensors)))
        if num_beams > 0:
            candidates = model.generate(batch["state"], num_beams)
            for state, cands, target in zip(batch["state"], candidates, batch["tactic"]):
                texts = [remove_marks(t) for t, _ in cands]
                tgt = remove_marks(target)
                for k in range(num_beams):
                    if tgt in texts[: k + 1]:
                        correct[k:] += 1
                        break
                if len(samples) < num_text_samples:
                    # Sample input/output rows (the reference's WandB tables,
                    # `generation/model.py:139-155`).
                    samples.append(
                        {"state": state, "ground_truth": tgt,
                         "prediction": texts[0] if texts else ""}
                    )
                total += 1

    if writer is not None and samples:
        writer.write_text(step, "val_samples", samples)
    metrics: Dict[str, float] = {"loss_val": float(np.mean(losses)) if losses else 0.0}
    if total:
        for k in range(num_beams):
            metrics[f"top{k + 1}_acc_val"] = float(correct[k]) / total
    return metrics


def causal_validation_metrics(
    model: Any,  # CausalTacticGeneratorModel
    loader: Iterable[Dict[str, Any]],
    num_beams: int = 1,
    limit_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Decoder-only counterpart of :func:`validation_metrics`: teacher-forced
    ``causal_lm_loss`` on ``CausalGeneratorDataModule`` batches plus the same
    beam-search Top-k exact-match accuracy (the reference delegates this
    family's evaluation to LLaMA-Factory; in-framework here)."""
    from reprover_tpu_torch.models.causal_lm import causal_lm_loss

    losses = []
    correct = np.zeros(num_beams, dtype=np.int64)
    total = 0
    for i, batch in enumerate(loader):
        if limit_batches is not None and i >= limit_batches:
            break
        tensors = numeric_batch(
            {k: batch[k] for k in ("input_ids", "attention_mask", "labels")}, model.device
        )
        with torch.no_grad():
            losses.append(float(causal_lm_loss(model.params, model.cfg, tensors["input_ids"],
                                               tensors["attention_mask"], tensors["labels"])))
        if num_beams > 0:
            candidates = model.generate(batch["state"], num_beams)
            for cands, target in zip(candidates, batch["tactic"]):
                texts = [remove_marks(t) for t, _ in cands]
                tgt = remove_marks(target)
                for k in range(num_beams):
                    if tgt in texts[: k + 1]:
                        correct[k:] += 1
                        break
                total += 1

    metrics: Dict[str, float] = {"loss_val": float(np.mean(losses)) if losses else 0.0}
    if total:
        for k in range(num_beams):
            metrics[f"top{k + 1}_acc_val"] = float(correct[k]) / total
    return metrics
