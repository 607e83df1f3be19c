"""Tactic generator model: ByT5 seq2seq with batched beam-search generation.
The counterpart of :class:`reprover_tpu.generation.TacticGeneratorModel`
(serving: ``__init__``, ``load_hf``, ``generate`` and the streaming-engine
hooks ``make_stepwise_engine``, ``tokenize_for_engine`` and
``decode_candidates``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reprover_tpu_torch.generation.beam_search import BeamSearchResult, beam_search
from reprover_tpu_torch.models.hf_import import load_hf_t5
from reprover_tpu_torch.models.quantize import quantize_t5_params, resolve_quantize_bits
from reprover_tpu_torch.models.t5 import (
    Params,
    T5Config,
    decode_step,
    default_dtype,
    encode,
    fuse_mlp_params,
    init_decode_state,
    place_params,
    reorder_decode_state,
    resolve_device,
)
from reprover_tpu_torch.tokenizer import ByT5Tokenizer, round_to_bucket


class TacticGeneratorModel:
    """Seq2seq model wrapper; beam search for serving."""

    def __init__(
        self,
        params: Params,
        cfg: T5Config,
        max_inp_seq_len: int,
        max_oup_seq_len: int,
        length_penalty: float = 0.0,
        bucket_multiple: int = 256,
    ) -> None:
        self.params = params
        self.cfg = cfg
        self.max_inp_seq_len = max_inp_seq_len
        self.max_oup_seq_len = max_oup_seq_len
        self.length_penalty = length_penalty
        self.bucket_multiple = bucket_multiple
        self.tokenizer = ByT5Tokenizer()
        self.device = params["decoder"]["final_norm"].device

    @classmethod
    def load_hf(
        cls,
        ckpt_dir: str,
        max_inp_seq_len: int,
        max_oup_seq_len: int,
        length_penalty: float = 0.0,
        compute_dtype: Optional[torch.dtype] = None,
        quantize: "bool | str" = False,
        device: Any = "cuda",
    ) -> "TacticGeneratorModel":
        """Load a local HF T5/ByT5 checkpoint onto ``device``; ``quantize``
        (``True``/``"int8"``/``"int4"``) stores the matrix-product weights
        in 8 or 4 bits (quantized from the float32 checkpoint)."""
        dev = resolve_device(device)
        params, cfg = load_hf_t5(ckpt_dir, compute_dtype=compute_dtype or default_dtype(dev))
        params = fuse_mlp_params(params)
        if quantize:
            params = quantize_t5_params(params, bits=resolve_quantize_bits(quantize))
        params = place_params(params, cfg, dev)
        return cls(params, cfg, max_inp_seq_len, max_oup_seq_len, length_penalty)

    @torch.inference_mode()
    def generate_ids(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, num_beams: int, max_length: int
    ) -> BeamSearchResult:
        """Encode, then beam-search ``num_beams`` sequences per source row."""
        cfg = self.cfg
        enc = encode(self.params, cfg, input_ids, attention_mask)
        cache = init_decode_state(
            self.params, cfg, enc, attention_mask, max_length, num_beams=num_beams
        )
        return beam_search(
            lambda state, tokens: decode_step(self.params, cfg, state, tokens),
            reorder_decode_state,
            cache,
            batch_size=input_ids.shape[0],
            num_beams=num_beams,
            max_length=max_length,
            eos_id=cfg.eos_token_id,
            pad_id=cfg.pad_token_id,
            start_id=cfg.decoder_start_token_id,
            length_penalty=self.length_penalty,
            device=self.device,
        )

    def generate(
        self,
        states: Sequence[str],
        num_samples: int,
        max_length: Optional[int] = None,
    ) -> List[List[Tuple[str, float]]]:
        """Beam-search ``num_samples`` candidates per input state -> per-state
        lists of (decoded text, sequence score) in descending score order."""
        max_length = max_length or self.max_oup_seq_len
        batch = self.tokenizer(
            states, max_length=self.max_inp_seq_len, bucket_multiple=self.bucket_multiple
        )
        result = self.generate_ids(
            torch.from_numpy(batch.input_ids).to(self.device, torch.long),
            torch.from_numpy(batch.attention_mask).to(self.device),
            num_samples,
            max_length,
        )
        sequences = result.sequences.cpu().numpy()
        scores = result.scores.cpu().numpy()
        return [
            [
                (self.tokenizer.decode(sequences[b, k], skip_special_tokens=True), float(scores[b, k]))
                for k in range(num_samples)
            ]
            for b in range(len(states))
        ]

    # -------------------------------------------------------------- #
    # Streaming-engine integration (model-agnostic serving loop)
    # -------------------------------------------------------------- #

    def make_stepwise_engine(
        self, num_slots: int, num_beams: int, chunk_size: int = 8,
        mesh: Any = None, step_buckets: Any = None,
        quantize: "bool | str" = False, reorder_mode: str = "auto",
    ) -> Any:
        """The continuous-batching engine for this model family
        (``step_buckets``: length-bucketed stepping, see
        ``StepwiseEngineBase``)."""
        from reprover_tpu_torch.generation.engine import StepwiseBeamEngine

        return StepwiseBeamEngine(
            self.params,
            self.cfg,
            num_slots=num_slots,
            num_beams=num_beams,
            max_src_len=round_to_bucket(self.max_inp_seq_len, self.bucket_multiple),
            max_decode_len=self.max_oup_seq_len,
            length_penalty=self.length_penalty,
            chunk_size=chunk_size,
            mesh=mesh,
            step_buckets=step_buckets,
            quantize=quantize,
            reorder_mode=reorder_mode,
        )

    def tokenize_for_engine(self, states: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize an admission wave padded to the engine's source bucket."""
        batch = self.tokenizer(
            states,
            max_length=self.max_inp_seq_len,
            pad_to=round_to_bucket(self.max_inp_seq_len, self.bucket_multiple),
        )
        return batch.input_ids, batch.attention_mask

    def decode_candidates(
        self, seqs: np.ndarray, scores: np.ndarray, lens: np.ndarray
    ) -> List[Tuple[str, float]]:
        """Finalized engine beams -> (text, score), matching ``generate``."""
        return [
            (self.tokenizer.decode(seqs[k], skip_special_tokens=True), float(scores[k]))
            for k in range(len(scores))
        ]
