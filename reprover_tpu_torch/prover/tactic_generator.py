"""Tactic generator implementations for proof search on the port's models.

A copy of the JAX package's ``prover/tactic_generator.py`` whose generators
load :class:`~reprover_tpu_torch.generation.TacticGeneratorModel` and
:class:`~reprover_tpu_torch.retrieval.PremiseRetriever` on ``device``
(default ``cuda``). Parity with `reference/prover/tactic_generator.py`: the
protocol is an async
``generate(state, file_path, theorem_full_name, theorem_pos, num_samples)
-> [(tactic, logprob)]`` (`tactic_generator.py:13-29`). Implementations:

- :class:`FixedTacticGenerator` — one fixed tactic wrapped in ``{ … }``
  (`tactic_generator.py:150-166`); doubles as the search-infrastructure test
  backend.
- :class:`LocalTacticGenerator` — in-process ByT5 beam search on this host's
  card (the reference's ``HuggingFaceGenerator``, `tactic_generator.py:169-243`),
  including the remove-marks + dedup-keep-first postprocessing.
- :class:`RetrievalAugmentedTacticGenerator` — retrieve top premises, pack
  them into the state with ``format_augmented_state``, delegate
  (`tactic_generator.py:246-298`).
- :class:`RemoteTacticGenerator` — client of the shared inference
  service (the reference's ``VllmGenerator``/``VllmActor`` role,
  `proof_search.py:332-366`): prover worker processes submit requests over a
  queue; the service batches them continuously across concurrent searches.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from reprover_tpu_torch.data import Pos, remove_marks


class TacticGenerator:
    """Protocol: async tactic candidate generation for one proof state."""

    def initialize(self) -> None:  # heavyweight setup, called once per worker
        pass

    async def generate(
        self,
        state: str,
        file_path: str,
        theorem_full_name: str,
        theorem_pos: Pos,
        num_samples: int,
    ) -> List[Tuple[str, float]]:
        raise NotImplementedError


class FixedTacticGenerator(TacticGenerator):
    """Always suggest one fixed tactic (`tactic_generator.py:150-166`)."""

    def __init__(self, tactic: str, module: Optional[str] = None) -> None:
        self.tactic = tactic
        self.module = module

    async def generate(
        self,
        state: str,
        file_path: str,
        theorem_full_name: str,
        theorem_pos: Pos,
        num_samples: int,
    ) -> List[Tuple[str, float]]:
        return [(f"{{ {self.tactic} }}", 1.0)]


def postprocess_candidates(
    texts: List[str], scores: List[float]
) -> List[Tuple[str, float]]:
    """remove ``<a>`` marks, dedup keeping the first (highest-scored)
    occurrence (`tactic_generator.py:235-241`)."""
    out_text: List[str] = []
    out_score: List[float] = []
    for t, s in zip(texts, scores):
        t = remove_marks(t)
        if t not in out_text:
            out_text.append(t)
            out_score.append(s)
    return list(zip(out_text, out_score))


class LocalTacticGenerator(TacticGenerator):
    """In-process beam-search generation on this host's device.

    Encoder-decoder (ByT5) checkpoints only: a decoder-only checkpoint
    raises ``NotImplementedError`` when ``initialize()`` loads it (the
    decoder-only family is not ported yet)."""

    def __init__(self, model_or_path: Any, max_inp_seq_len: int = 2048,
                 max_oup_seq_len: int = 512, length_penalty: float = 0.0,
                 quantize: "bool | str" = False, device: str = "cuda") -> None:
        if isinstance(model_or_path, str):
            self._path = model_or_path
            self.model = None
        else:
            self._path = None
            self.model = model_or_path
        self.max_inp_seq_len = max_inp_seq_len
        self.max_oup_seq_len = max_oup_seq_len
        self.length_penalty = length_penalty
        self.quantize = quantize  # not ported: load_hf raises on it
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

    async def generate(
        self,
        state: str,
        file_path: str,
        theorem_full_name: str,
        theorem_pos: Pos,
        num_samples: int,
    ) -> List[Tuple[str, float]]:
        assert self.model is not None, "initialize() first"
        candidates = self.model.generate([state], num_samples)[0]
        return postprocess_candidates(
            [t for t, _ in candidates], [s for _, s in candidates]
        )


class RetrievalAugmentedTacticGenerator(TacticGenerator):
    """Retrieve premises, pack into the state, then generate
    (`tactic_generator.py:246-298`)."""

    def __init__(
        self,
        gen: TacticGenerator,
        retriever_or_path: Any,
        indexed_corpus_path: Optional[str] = None,
        max_inp_seq_len: int = 2048,
        max_num_retrieved: int = 100,
        approximate: bool = False,
        device: str = "cuda",
    ) -> None:
        self.approximate = approximate
        self.device = device
        self.gen = gen
        if isinstance(retriever_or_path, str):
            self._ret_path = retriever_or_path
            self.retriever = None
        else:
            self._ret_path = None
            self.retriever = retriever_or_path
        self.indexed_corpus_path = indexed_corpus_path
        self.max_inp_seq_len = max_inp_seq_len
        self.max_num_retrieved = max_num_retrieved

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

    async def generate(
        self,
        state: str,
        file_path: str,
        theorem_full_name: str,
        theorem_pos: Pos,
        num_samples: int,
    ) -> List[Tuple[str, float]]:
        from reprover_tpu_torch.data import format_augmented_state

        assert self.retriever is not None, "initialize() first"
        premises, _ = self.retriever.retrieve(
            state, file_path, theorem_full_name, theorem_pos, self.max_num_retrieved
        )
        # remove_marks matches the training input distribution: the generator
        # datamodule strips ``<a>`` premise marks from the augmented state
        # (`/root/reference/generation/datamodule.py:79`), but the reference's
        # search path feeds the marked string to the model
        # (`/root/reference/prover/tactic_generator.py:293`) — a train/search
        # skew its pretrained byt5 init happens to tolerate. Measured here:
        # a from-scratch model at 80% step accuracy on (mark-free) val inputs
        # proved 0/200 theorems through the marked path.
        aug = remove_marks(
            format_augmented_state(state, premises, self.max_inp_seq_len)
        )
        return await self.gen.generate(
            aug, file_path, theorem_full_name, theorem_pos, num_samples
        )


class RemoteTacticGenerator(TacticGenerator):
    """Client of the shared inference service (continuous batching).

    Submits (state, metadata) over a multiprocessing queue and awaits the
    reply without blocking the event loop — so a prover can interleave Lean
    waits with generation waits. The server side lives in
    :mod:`reprover_tpu_torch.prover.service`.
    """

    def __init__(self, client: Any) -> None:
        self.client = client  # reprover_tpu_torch.prover.service.ServiceClient

    async def generate(
        self,
        state: str,
        file_path: str,
        theorem_full_name: str,
        theorem_pos: Pos,
        num_samples: int,
    ) -> List[Tuple[str, float]]:
        candidates = await self.client.agenerate(
            state, file_path, theorem_full_name, theorem_pos, num_samples
        )
        return postprocess_candidates(
            [t for t, _ in candidates], [s for _, s in candidates]
        )
