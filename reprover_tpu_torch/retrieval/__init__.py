"""Premise retrieval: the dense retriever, the indexer CLI, validation
metrics, the training CLI (``python -m reprover_tpu_torch.retrieval.main``),
the standalone evaluator and the BM25 baseline.

Imports are lazy, as in ``reprover_tpu/retrieval/__init__.py:7-15``, so the
host-side consumers (the BM25 baseline, the evaluator) do not load the model
code.
"""

_LAZY = {
    "PremiseRetriever": ("reprover_tpu_torch.retrieval.retriever", "PremiseRetriever"),
    "predict": ("reprover_tpu_torch.retrieval.prediction", "predict"),
    "save_predictions": ("reprover_tpu_torch.retrieval.prediction", "save_predictions"),
    "validation_metrics": ("reprover_tpu_torch.retrieval.prediction", "validation_metrics"),
    "build_preds_map": ("reprover_tpu_torch.retrieval.evaluate", "build_preds_map"),
    "evaluate_split": ("reprover_tpu_torch.retrieval.evaluate", "evaluate_split"),
    "BM25Okapi": ("reprover_tpu_torch.retrieval.bm25", "BM25Okapi"),
}

__all__ = list(_LAZY)


def __getattr__(name: str) -> object:
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
