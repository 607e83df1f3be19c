"""Trainable tactic tokenizer for the in-framework decoder-only path: a copy
of :mod:`reprover_tpu.generation.bpe_tokenizer` for the port.

The reference's decoder-only story assumes a downloadable HF checkpoint
with its own subword tokenizer (`reference/prover/tactic_generator.py:
183-192` loads ``AutoTokenizer``). Offline — and for from-scratch causal
models trained inside this framework — there is no such artifact, so this
adapter turns the owned C++ BPE core (``native/bpe.cpp``, built
for the BM25 baseline) into a full causal-LM tokenizer with the HF surface
``CausalTacticGeneratorModel`` expects (``__call__`` -> ``input_ids``,
``decode``).

Losslessness matters more than it does for BM25: the prover's replay
environment matches generated tactics against traced tactics by EXACT
string, so ``decode(encode(text)) == text`` must hold for any text over the
trained character set. The native core's pre-tokenizer drops whitespace
(fine for retrieval scoring, fatal for generation), so this adapter maps
whitespace to sentinel characters before encoding and back after decoding
(the sentencepiece ``▁`` idea). Characters unseen at training time encode
to ``[UNK]`` and cannot round-trip — ``decode`` drops them, which makes a
mismatch (an honest miss) rather than a crash.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

from reprover_tpu_torch.native import BpeTokenizer

# Sentinels chosen outside the Lean/Mathlib character distribution; a text
# that already contains one would not round-trip (asserted during train()).
_SPACE = "▁"  # ▁
_NEWLINE = "⏎"  # ⏎
_TAB = "⇥"  # ⇥

_SPECIALS = ["[PAD]", "[UNK]", "[EOS]", "[BOS]"]
PAD_ID, UNK_ID, EOS_ID, BOS_ID = range(4)


def _to_wire(text: str) -> str:
    return (
        text.replace(" ", _SPACE).replace("\n", _NEWLINE).replace("\t", _TAB)
    )


def _from_wire(text: str) -> str:
    return (
        text.replace(_SPACE, " ").replace(_NEWLINE, "\n").replace(_TAB, "\t")
    )


class TacticBpeTokenizer:
    """HF-shaped trainable BPE tokenizer (C++ core, Python fallback)."""

    pad_token_id = PAD_ID
    unk_token_id = UNK_ID
    eos_token_id = EOS_ID
    bos_token_id = BOS_ID

    def __init__(self, bpe: BpeTokenizer | None = None) -> None:
        self._bpe = bpe if bpe is not None else BpeTokenizer()

    # -- training / persistence --------------------------------------- #

    def train(self, texts: Sequence[str], vocab_size: int = 8192) -> None:
        for t in texts[:256]:
            assert not any(s in t for s in (_SPACE, _NEWLINE, _TAB)), (
                "training text contains a whitespace sentinel character"
            )
        # Character-coverage floor: every printable ASCII char (plus the
        # whitespace sentinels and the common Lean/Mathlib symbols) enters
        # the base vocab even if absent from the corpus sample, so tactics
        # over this alphabet round-trip instead of hitting [UNK].
        coverage = (
            " \n\t"
            + "".join(chr(c) for c in range(33, 127))
            + "⊢⊓⊔∘∀∃≤≥≠∈∉∧∨¬←→↔↦⁻¹₀₁₂₃₄₅₆₇₈₉αβγδεζηθικλμνξπρστφχψωℕℤℚℝℂ∑∏∫√∞∅⊆⊂∪∩×"
        )
        self._bpe.train(
            [_to_wire(t) for t in texts] + [_to_wire(coverage)],
            vocab_size,
            specials=_SPECIALS,
        )

    @property
    def vocab_size(self) -> int:
        return len(self._bpe.vocab)

    def save(self, path: str) -> None:
        self._bpe.save(path)

    @classmethod
    def load(cls, path: str) -> "TacticBpeTokenizer":
        return cls(BpeTokenizer.load(path))

    # -- HF-shaped surface (CausalTacticGeneratorModel contract) ------- #

    def __call__(self, text: str, add_special_tokens: bool = True) -> Dict:
        """Encode one prompt; no bos/eos are added (the causal generator
        seeds beams from the prompt's last real token, and training appends
        ``[EOS]`` to targets explicitly)."""
        return {"input_ids": self._bpe.encode_ids(_to_wire(text))}

    def encode_ids(self, text: str) -> List[int]:
        return self._bpe.encode_ids(_to_wire(text))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        vocab = self._bpe.vocab
        n_special = len(_SPECIALS)
        pieces = []
        for i in ids:
            if skip_special_tokens and 0 <= i < n_special:
                continue
            if 0 <= i < len(vocab):
                pieces.append(vocab[i])
        return _from_wire("".join(pieces))

    def batch_decode(
        self, batch: Sequence[Sequence[int]], skip_special_tokens: bool = True
    ) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]


def train_tactic_tokenizer(
    corpus_texts: Sequence[str],
    vocab_size: int = 8192,
    save_path: str | None = None,
) -> TacticBpeTokenizer:
    """Train on premise code + state/tactic text, optionally persist."""
    tok = TacticBpeTokenizer()
    tok.train(list(corpus_texts), vocab_size)
    if save_path is not None:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        tok.save(save_path)
    return tok
