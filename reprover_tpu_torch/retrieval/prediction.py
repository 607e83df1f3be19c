"""Retriever validation metrics and the predictions artifact on the port.

A copy of the JAX package's ``retrieval/prediction.py``, with one repair in
:func:`validation_metrics`: the embedding probe is copied to host numpy
before the health telemetry (the port's ``training.health``) reads it, since
the port's corpus embeddings are a device tensor, which ``np.asarray``
cannot take on a card. :func:`predict` writes the per-tactic records of
``predictions.pickle`` (`reference/retrieval/model.py:281-336`), which
generator training reads through ``generation.datamodule.load_preds``.
"""

from __future__ import annotations

import logging
import pickle
from typing import Any, Dict, List

import numpy as np

from reprover_tpu_torch.training.health import embedding_anisotropy, embedding_eff_rank

__all__ = ["validation_metrics", "predict", "save_predictions"]

logger = logging.getLogger(__name__)


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


def predict(
    retriever: Any,
    loader: Any,
    num_retrieved: int = 100,
    reindex_batch_size: int = 64,
) -> List[Dict[str, Any]]:
    """Per-tactic retrieval records (`retrieval/model.py:281-327` schema).

    ``reindex_batch_size`` defaults to the reference's eval/index batch of 64
    (`retrieval/index.py:24`); the in-retriever lazy reindex keeps the
    reference's 32 (`retrieval/model.py:348`)."""
    retriever.reindex_corpus(batch_size=reindex_batch_size)
    outputs: List[Dict[str, Any]] = []
    for batch in loader:
        retrieved, scores = retriever.retrieve_batch(batch["context"], num_retrieved)
        for i in range(len(batch["context"])):
            outputs.append(
                {
                    "url": batch["url"][i],
                    "commit": batch["commit"][i],
                    "file_path": batch["file_path"][i],
                    "full_name": batch["full_name"][i],
                    "start": batch["start"][i],
                    "tactic_idx": batch["tactic_idx"][i],
                    "context": batch["context"][i],
                    "all_pos_premises": batch["all_pos_premises"][i],
                    "retrieved_premises": retrieved[i],
                    "scores": scores[i],
                }
            )
    return outputs


def save_predictions(outputs: List[Dict[str, Any]], path: str) -> None:
    """Write the ``predictions.pickle`` artifact
    (`retrieval/model.py:329-336`)."""
    with open(path, "wb") as f:
        pickle.dump(outputs, f)
    logger.info("retrieval predictions saved to %s", path)
