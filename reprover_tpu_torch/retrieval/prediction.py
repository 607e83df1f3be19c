"""Retriever validation metrics and the predictions artifact on the port.

:func:`validation_metrics` is the JAX package's
(``reprover_tpu.retrieval.prediction.validation_metrics``) with two
repairs for the port: the embedding probe is copied to host numpy before
the health telemetry reads it (the port's corpus embeddings are a device
tensor, which ``np.asarray`` cannot take on a card), and the telemetry
comes from the port's ``training.health`` (the JAX package's import of its
own runs ``reprover_tpu/training/__init__.py``, which imports JAX).
:func:`predict` and :func:`save_predictions` are the JAX package's, which
import no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from reprover_tpu.retrieval.prediction import predict, save_predictions
from reprover_tpu_torch.training.health import embedding_anisotropy, embedding_eff_rank

__all__ = ["validation_metrics", "predict", "save_predictions"]


def validation_metrics(
    retriever: Any,
    loader: Any,
    num_retrieved: int = 100,
    reindex_batch_size: int = 64,
) -> Dict[str, float]:
    """Recall@1..num_retrieved (%) + MRR over an eval loader, plus the
    embedding-health probe (``emb_eff_rank``, ``cos_offdiag_*``) of the
    first 512 re-indexed corpus embeddings.

    Examples whose tactic has no positive premises are skipped
    (`retrieval/model.py:233-236`)."""
    recall: List[List[float]] = [[] for _ in range(num_retrieved)]
    mrr: List[float] = []
    retriever.reindex_corpus(batch_size=reindex_batch_size)

    for batch in loader:
        retrieved, _ = retriever.retrieve_batch(batch["context"], num_retrieved)
        for all_pos, premises in zip(batch["all_pos_premises"], retrieved):
            all_pos = set(all_pos)
            if not all_pos:
                continue
            first_match = False
            for j in range(num_retrieved):
                tp = len(all_pos.intersection(premises[: j + 1]))
                recall[j].append(tp / len(all_pos))
                if premises[j] in all_pos and not first_match:
                    mrr.append(1.0 / (j + 1))
                    first_match = True
            if not first_match:
                mrr.append(0.0)

    metrics = {
        f"Recall@{j + 1}_val": 100 * float(np.mean(recall[j])) if recall[j] else 0.0
        for j in range(num_retrieved)
    }
    metrics["MRR"] = float(np.mean(mrr)) if mrr else 0.0
    if getattr(retriever, "corpus_embeddings", None) is not None:
        probe = retriever.corpus_embeddings[:512].float().cpu().numpy()
        metrics["emb_eff_rank"] = embedding_eff_rank(probe)
        metrics.update(embedding_anisotropy(probe))
    return metrics
