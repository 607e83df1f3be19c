"""Premise retrieval: the dense retriever, the indexer CLI, validation
metrics and the training CLI (``python -m reprover_tpu_torch.retrieval.main``)."""

from reprover_tpu_torch.retrieval.prediction import predict, save_predictions, validation_metrics
from reprover_tpu_torch.retrieval.retriever import PremiseRetriever

__all__ = ["PremiseRetriever", "predict", "save_predictions", "validation_metrics"]
