"""Tactic generators that load the port's models.

The generator classes of ``reprover_tpu.prover.tactic_generator`` import
no JAX until ``initialize()`` loads a model from a checkpoint path; these
subclasses keep their behaviour (beam search, premise packing,
postprocessing) and load :class:`~reprover_tpu_torch.generation.TacticGeneratorModel`
and :class:`~reprover_tpu_torch.retrieval.PremiseRetriever` instead, on
``device``.
"""

from __future__ import annotations

from typing import Any, Optional

from reprover_tpu.prover import tactic_generator as base


class LocalTacticGenerator(base.LocalTacticGenerator):
    """In-process beam-search generation on this host's card."""

    def __init__(
        self,
        model_or_path: Any,
        max_inp_seq_len: int = 2048,
        max_oup_seq_len: int = 512,
        length_penalty: float = 0.0,
        quantize: "bool | str" = False,
        device: str = "cuda",
    ) -> None:
        super().__init__(model_or_path, max_inp_seq_len, max_oup_seq_len, length_penalty, quantize)
        self.device = device

    def initialize(self) -> None:
        if self.model is None:
            from reprover_tpu_torch.generation import TacticGeneratorModel

            self.model = TacticGeneratorModel.load_hf(
                self._path,
                self.max_inp_seq_len,
                self.max_oup_seq_len,
                self.length_penalty,
                quantize=self.quantize,
                device=self.device,
            )


class RetrievalAugmentedTacticGenerator(base.RetrievalAugmentedTacticGenerator):
    """Retrieve premises, pack them into the state, then generate."""

    def __init__(
        self,
        gen: base.TacticGenerator,
        retriever_or_path: Any,
        indexed_corpus_path: Optional[str] = None,
        max_inp_seq_len: int = 2048,
        max_num_retrieved: int = 100,
        approximate: bool = False,
        device: str = "cuda",
    ) -> None:
        super().__init__(
            gen, retriever_or_path, indexed_corpus_path, max_inp_seq_len,
            max_num_retrieved, approximate,
        )
        self.device = device

    def initialize(self) -> None:
        self.gen.initialize()
        if self.retriever is None:
            from reprover_tpu_torch.retrieval import PremiseRetriever

            if self.indexed_corpus_path is None:
                raise ValueError("a retriever checkpoint needs indexed_corpus_path")
            self.retriever = PremiseRetriever.load_hf(
                self._ret_path,
                self.max_inp_seq_len,
                approximate=self.approximate,
                device=self.device,
            )
            self.retriever.load_corpus(self.indexed_corpus_path)
