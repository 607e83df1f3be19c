"""Premise retrieval: the dense retriever and the indexer CLI."""

from reprover_tpu_torch.retrieval.retriever import PremiseRetriever

__all__ = ["PremiseRetriever"]
