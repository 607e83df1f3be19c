"""Decoder-only generator data pipeline: state/tactic pairs -> causal batches.
A copy of the JAX package's ``generation/causal_datamodule.py``.

The reference fine-tunes decoder-only models OUTSIDE its repo (export to
LLaMA-Factory, `reference/generation/preprocess.py:30-37`, then serve
the result, `prover/tactic_generator.py:183-192`). This framework trains the
causal family in-process: the same example stream as the seq2seq pipeline
(`generation/datamodule.py` — premise-augmented states keyed by retriever
predictions, ``<a>`` marks stripped), formatted with the SAME
``[GOAL]/[PROOFSTEP]`` template the exporter and the serving wrapper use,
tokenized by any HF-shaped tokenizer (``TacticBpeTokenizer`` offline, or a
checkpoint's own), and packed into fixed-shape ``input_ids / attention_mask
/ labels`` batches for ``models/causal_lm.causal_lm_loss``.

Skew guards (the measured train/search failure class):
- prompt and target are encoded SEPARATELY and concatenated, because at
  serving time the prompt is encoded alone and generation appends to it —
  encoding the joined string would let BPE merge across the boundary and
  train on token sequences the server can never produce;
- on overflow the prompt is truncated from the LEFT (keep the tail nearest
  ``[PROOFSTEP]``), exactly like ``CausalTacticGeneratorModel._tokenize``;
- labels cover only the target tokens + one ``[EOS]`` (-100 elsewhere,
  the HF convention the loss expects).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from reprover_tpu_torch.data.corpus import Corpus
from reprover_tpu_torch.generation.datamodule import (
    GeneratorDataset,
    load_preds,
)
from reprover_tpu_torch.generation.preprocess import TEMPLATE
from reprover_tpu_torch.retrieval.datamodule import Loader

Example = Dict[str, Any]
Batch = Dict[str, Any]


def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class CausalGeneratorDataset(GeneratorDataset):
    """Same examples as ``GeneratorDataset``; causal-LM collation."""

    def __init__(
        self,
        data_path: str,
        corpus: Optional[Corpus],
        preds: Optional[Dict],
        tokenizer: Any,  # HF-shaped: __call__ -> {"input_ids": [...]}
        max_seq_len: int,
        p_drop: float,
        is_train: bool,
        bucket_multiple: int = 128,
        seed: int = 0,
    ) -> None:
        # max_inp/max_oup below only bound the byte-level premise packing in
        # format_augmented_state; the token-level cap is max_seq_len here.
        super().__init__(
            data_path,
            corpus,
            preds,
            max_inp_seq_len=4 * max_seq_len,
            max_oup_seq_len=max_seq_len,
            p_drop=p_drop,
            is_train=is_train,
            bucket_multiple=bucket_multiple,
            seed=seed,
        )
        self.causal_tokenizer = tokenizer
        self.max_seq_len = max_seq_len

    def collate(self, examples: List[Example]) -> Batch:
        tok = self.causal_tokenizer
        eos = tok.eos_token_id
        pad = tok.pad_token_id
        rows = []
        for ex in examples:
            prompt = tok(TEMPLATE % ex["state"])["input_ids"]
            target = tok(ex["tactic"])["input_ids"] + [eos]
            # keep the full target; give the prompt the remaining budget
            budget = self.max_seq_len - len(target)
            if budget < 1:
                raise ValueError(f"tactic alone exceeds max_seq_len={self.max_seq_len}")
            prompt = prompt[-budget:]
            rows.append((prompt, target))

        longest = max(len(p) + len(t) for p, t in rows)
        width = min(
            _round_up(max(longest, 2), self.bucket_multiple), self.max_seq_len
        )
        n = len(rows)
        input_ids = np.full((n, width), pad, np.int32)
        attention_mask = np.zeros((n, width), np.int32)
        labels = np.full((n, width), -100, np.int32)
        for i, (prompt, target) in enumerate(rows):
            seq = prompt + target
            input_ids[i, : len(seq)] = seq
            attention_mask[i, : len(seq)] = 1
            labels[i, len(prompt) : len(seq)] = target

        batch: Batch = {
            "state": [ex["state"] for ex in examples],
            "tactic": [ex["tactic"] for ex in examples],
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "labels": labels,
        }
        for key in examples[0].keys():
            if key not in batch:
                batch[key] = [ex[key] for ex in examples]
        return batch


class CausalGeneratorDataModule:
    """Mirror of ``GeneratorDataModule`` for the decoder-only family."""

    def __init__(
        self,
        data_path: str,
        tokenizer: Any,
        batch_size: int,
        eval_batch_size: int,
        max_seq_len: int,
        p_drop: float,
        corpus_path: Optional[str] = None,
        preds_path: Optional[str] = None,
        bucket_multiple: int = 128,
        seed: int = 0,
    ) -> None:
        self.data_path = data_path
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.eval_batch_size = eval_batch_size
        self.max_seq_len = max_seq_len
        self.p_drop = p_drop
        self.bucket_multiple = bucket_multiple
        self.seed = seed
        self.corpus = Corpus(corpus_path) if corpus_path is not None else None
        self.preds = load_preds(preds_path) if preds_path is not None else None
        self.ds_train: Optional[CausalGeneratorDataset] = None
        self.ds_val: Optional[CausalGeneratorDataset] = None

    def setup(self, stage: Optional[str] = None) -> None:
        def make(split: str, is_train: bool) -> CausalGeneratorDataset:
            return CausalGeneratorDataset(
                os.path.join(self.data_path, f"{split}.json"),
                self.corpus,
                self.preds,
                self.tokenizer,
                self.max_seq_len,
                self.p_drop,
                is_train,
                self.bucket_multiple,
                self.seed,
            )

        if stage in (None, "fit"):
            self.ds_train = make("train", True)
        if stage in (None, "fit", "validate"):
            self.ds_val = make("val", False)

    def train_dataloader(self) -> Loader:
        return Loader(self.ds_train, self.batch_size, True, True, self.seed)

    def val_dataloader(self) -> Loader:
        return Loader(self.ds_val, self.eval_batch_size, False, False)
