"""Tactic generation: beam search and the seq2seq generator model."""

from reprover_tpu_torch.generation.beam_search import BeamSearchResult, beam_search
from reprover_tpu_torch.generation.generator import TacticGeneratorModel

__all__ = ["BeamSearchResult", "beam_search", "TacticGeneratorModel"]
