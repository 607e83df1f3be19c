"""Tactic generator model: ByT5 seq2seq with batched beam-search generation.
The counterpart of :class:`reprover_tpu.generation.TacticGeneratorModel`
(serving only: ``__init__``, ``load_hf`` and ``generate``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from reprover_tpu.tokenizer import ByT5Tokenizer
from reprover_tpu_torch.generation.beam_search import BeamSearchResult, beam_search
from reprover_tpu_torch.models.hf_import import load_hf_t5, reject_decoder_only
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

QUANTIZE_TODO = "ROADMAP.md Queue 1 item 8 (quantization)"


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
        self.device = params["shared_embedding"].device

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
        if quantize:
            raise NotImplementedError(f"quantized serving is not ported yet: {QUANTIZE_TODO}")
        reject_decoder_only(ckpt_dir)
        dev = resolve_device(device)
        params, cfg = load_hf_t5(ckpt_dir, compute_dtype=compute_dtype or default_dtype(dev))
        params = place_params(fuse_mlp_params(params), cfg, dev)
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

