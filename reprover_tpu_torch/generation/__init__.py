"""Tactic generation: beam search, the seq2seq generator model, and (loaded
on first use) the decoder-only generator, its fine-tuning data module and
the trainable BPE tokenizer."""

from reprover_tpu_torch.generation.beam_search import BeamSearchResult, beam_search
from reprover_tpu_torch.generation.generator import TacticGeneratorModel

__all__ = [
    "BeamSearchResult",
    "beam_search",
    "TacticGeneratorModel",
    "CausalTacticGeneratorModel",
    "CausalGeneratorDataModule",
    "TacticBpeTokenizer",
]


def __getattr__(name: str) -> object:
    # Lazy, as in the JAX package: the decoder-only family is imported only
    # when it is used.
    if name == "CausalTacticGeneratorModel":
        from reprover_tpu_torch.generation.causal_generator import CausalTacticGeneratorModel

        return CausalTacticGeneratorModel
    if name == "CausalGeneratorDataModule":
        from reprover_tpu_torch.generation.causal_datamodule import CausalGeneratorDataModule

        return CausalGeneratorDataModule
    if name == "TacticBpeTokenizer":
        from reprover_tpu_torch.generation.bpe_tokenizer import TacticBpeTokenizer

        return TacticBpeTokenizer
    raise AttributeError(name)
