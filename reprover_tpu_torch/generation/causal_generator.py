"""Decoder-only tactic generator: causal LM + batched beam search, the
counterpart of :mod:`reprover_tpu.generation.causal_generator`.

Left-padded prompt prefill fills the KV cache, then the port's beam search
continues from each prompt's last token, so the returned sequences hold only
generated tokens (no prompt echo to strip). Prompts use the
``[GOAL]\\n{state}\\n[PROOFSTEP]\\n`` template of the reference's decoder-only
serving. The tokenizer is anything with the HF surface (``__call__`` ->
``input_ids``, ``decode``): a checkpoint's own, or the trainable
:class:`~reprover_tpu_torch.generation.bpe_tokenizer.TacticBpeTokenizer`.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reprover_tpu_torch.generation.beam_search import BeamSearchResult, beam_search
from reprover_tpu_torch.models.causal_lm import (
    CausalDecodeState,
    CausalLMConfig,
    Params,
    decode_step,
    place_params,
    prefill,
    reorder_decode_state,
)
from reprover_tpu_torch.models.quantize import quantize_causal_params, resolve_quantize_bits
from reprover_tpu_torch.models.t5 import default_dtype, resolve_device

# The serving prompt must match the fine-tuning instruction byte for byte
# (the JAX package's ``generation/preprocess.py`` TEMPLATE).
GOAL_TEMPLATE = "[GOAL]\n%s\n[PROOFSTEP]\n"


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _left_pad(encoded: List[List[int]], width: int, pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows LEFT-padded to ``width``, keeping each row's tail."""
    ids = np.full((len(encoded), width), pad_id, np.int32)
    mask = np.zeros((len(encoded), width), np.int32)
    for i, row in enumerate(encoded):
        row = row[-width:]
        ids[i, width - len(row):] = row
        mask[i, width - len(row):] = 1
    return ids, mask


class CausalTacticGeneratorModel:
    """Decoder-only model wrapper with the TacticGeneratorModel interface."""

    def __init__(
        self,
        params: Params,
        cfg: CausalLMConfig,
        tokenizer: Any,
        max_inp_seq_len: int,
        max_oup_seq_len: int,
        length_penalty: float = 0.0,
        template: str = GOAL_TEMPLATE,
        bucket_multiple: int = 128,
        quantize: "bool | str" = False,
    ) -> None:
        if quantize:
            params = quantize_causal_params(params, bits=resolve_quantize_bits(quantize))
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_inp_seq_len = max_inp_seq_len
        self.max_oup_seq_len = max_oup_seq_len
        self.length_penalty = length_penalty
        self.template = template
        self.bucket_multiple = bucket_multiple
        self.device = params["final_norm"].device

    @classmethod
    def load_hf(
        cls,
        ckpt_dir: str,
        max_inp_seq_len: int,
        max_oup_seq_len: int,
        length_penalty: float = 0.0,
        template: str = GOAL_TEMPLATE,
        compute_dtype: Optional[torch.dtype] = None,
        quantize: "bool | str" = False,
        device: Any = "cuda",
    ) -> "CausalTacticGeneratorModel":
        """A local HF LLaMA-family checkpoint with its own tokenizer (HF
        ``AutoTokenizer``, which needs ``transformers``) on ``device``."""
        from reprover_tpu_torch.models.hf_import_causal import load_hf_causal_lm

        try:
            from transformers import AutoTokenizer
        except ImportError:
            raise ImportError(
                f"{ckpt_dir}: loading a checkpoint's tokenizer needs the 'transformers' package; "
                "without it, build CausalTacticGeneratorModel with a TacticBpeTokenizer"
            ) from None
        dev = resolve_device(device)
        params, cfg = load_hf_causal_lm(ckpt_dir, compute_dtype=compute_dtype or default_dtype(dev))
        if quantize:
            params = quantize_causal_params(params, bits=resolve_quantize_bits(quantize))
        return cls(place_params(params, cfg, dev), cfg, AutoTokenizer.from_pretrained(ckpt_dir),
                   max_inp_seq_len, max_oup_seq_len, length_penalty, template)

    def _tokenize(self, prompts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        encoded = [self.tokenizer(p, add_special_tokens=True)["input_ids"] for p in prompts]
        encoded = [ids[-self.max_inp_seq_len:] for ids in encoded]
        longest = max(len(ids) for ids in encoded)
        width = min(_round_up(max(longest, 2), self.bucket_multiple), self.max_inp_seq_len)
        width = max(width, 2)  # prefill needs >= 1 column before the start token
        return _left_pad(encoded, width, self.cfg.pad_token_id)

    @torch.inference_mode()
    def generate_ids(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, num_beams: int, max_new: int
    ) -> BeamSearchResult:
        """Prefill everything but each prompt's last real token (the final
        column, by left padding), then beam-search from it."""
        cfg = self.cfg
        b = input_ids.shape[0]
        _, cache = prefill(self.params, cfg, input_ids[:, :-1], attention_mask[:, :-1],
                           max_decode_len=max_new + 1)
        cache = CausalDecodeState(
            k=cache.k.repeat_interleave(num_beams, dim=1),
            v=cache.v.repeat_interleave(num_beams, dim=1),
            key_mask=cache.key_mask.repeat_interleave(num_beams, dim=0),
            step=cache.step,
            position=cache.position.repeat_interleave(num_beams, dim=0),
        )
        return beam_search(
            lambda state, tokens: decode_step(self.params, cfg, state, tokens),
            reorder_decode_state,
            cache,
            batch_size=b,
            num_beams=num_beams,
            max_length=max_new + 1,  # counts the start (last prompt) token
            eos_id=cfg.eos_token_id,
            pad_id=cfg.pad_token_id,
            start_id=input_ids[:, -1],
            length_penalty=self.length_penalty,
            device=self.device,
        )

    def _texts(self, seqs: np.ndarray, scores: np.ndarray, lens: np.ndarray
               ) -> List[Tuple[str, float]]:
        """Beams -> (text, score): skip column 0 (the prompt's last token),
        drop eos/pad; ids past the tokenizer's vocabulary decode to nothing."""
        out = []
        for k in range(len(scores)):
            toks = [t for t in seqs[k, 1: lens[k]].tolist()
                    if t not in (self.cfg.eos_token_id, self.cfg.pad_token_id)]
            text = self.tokenizer.decode(toks, skip_special_tokens=True)
            out.append((text.strip(), float(scores[k])))
        return out

    def generate(
        self, states: Sequence[str], num_samples: int, max_length: Optional[int] = None
    ) -> List[List[Tuple[str, float]]]:
        """Beam-search candidates per state (template applied here) ->
        (text, score) descending."""
        ids, mask = self._tokenize([self.template % s for s in states])
        result = self.generate_ids(
            torch.from_numpy(ids).to(self.device, torch.long),
            torch.from_numpy(mask).to(self.device, torch.long),
            num_samples, max_length or self.max_oup_seq_len,
        )
        sequences = result.sequences.cpu().numpy()
        scores = result.scores.cpu().numpy()
        lengths = result.lengths.cpu().numpy()
        return [self._texts(sequences[b], scores[b], lengths[b]) for b in range(len(states))]

    # -------------------------------------------------------------- #
    # Streaming-engine integration (model-agnostic serving loop)
    # -------------------------------------------------------------- #

    def make_stepwise_engine(
        self, num_slots: int, num_beams: int, chunk_size: int = 8,
        mesh: Any = None, step_buckets: Any = None,
        quantize: "bool | str" = False, reorder_mode: str = "auto",
    ) -> Any:
        """The continuous-batching engine for this model family."""
        from reprover_tpu_torch.generation.causal_engine import CausalStepwiseEngine

        return CausalStepwiseEngine(
            self.params,
            self.cfg,
            num_slots=num_slots,
            num_beams=num_beams,
            max_src_len=self.max_inp_seq_len,
            # +1: like the classic path's ``max_new + 1``, the decode length
            # counts the start token (the prompt's last real token).
            max_decode_len=self.max_oup_seq_len + 1,
            length_penalty=self.length_penalty,
            chunk_size=chunk_size,
            mesh=mesh,
            step_buckets=step_buckets,
            quantize=quantize,
            reorder_mode=reorder_mode,
        )

    def tokenize_for_engine(self, states: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Template + LEFT-pad every admission row to exactly
        ``max_inp_seq_len`` (the engine's prompt bucket), keeping the prompt
        tail on truncation."""
        encoded = [self.tokenizer(self.template % s, add_special_tokens=True)["input_ids"]
                   for s in states]
        return _left_pad(encoded, self.max_inp_seq_len, self.cfg.pad_token_id)

    def decode_candidates(
        self, seqs: np.ndarray, scores: np.ndarray, lens: np.ndarray
    ) -> List[Tuple[str, float]]:
        """Finalized engine beams -> (text, score), matching ``generate``."""
        return self._texts(seqs, scores, lens)
