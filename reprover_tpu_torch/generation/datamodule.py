"""Generator data pipeline: (state, tactic) pairs with retrieval augmentation.

Capability parity with `reference/generation/datamodule.py`:

- flattening theorems to (state_before, tactic) pairs with ``<a>`` marks
  stripped from targets (`generation/datamodule.py:44-61`);
- optional augmentation of the state with retrieved premises keyed by
  (file_path, full_name, state) with train-time premise dropout
  (`generation/datamodule.py:66-80`, preds dict built at
  `generation/datamodule.py:150-154`);
- collation masks pad positions of the tactic ids to -100 for the CE loss
  (`generation/datamodule.py:99-100`).

A copy of the JAX package's ``generation/datamodule.py``. Padding is
bucketed on both encoder and decoder sides (``bucket_multiple`` 128), so a
train step sees a few (src, tgt) shape pairs only: the 2300-byte reference
input pads to 2304.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np

from reprover_tpu_torch.data import Corpus, format_augmented_state, remove_marks
from reprover_tpu_torch.retrieval.datamodule import Loader
from reprover_tpu_torch.tokenizer import ByT5Tokenizer

Example = Dict[str, Any]
Batch = Dict[str, Any]


class GeneratorDataset:
    def __init__(
        self,
        data_path: str,
        corpus: Optional[Corpus],
        preds: Optional[Dict],
        max_inp_seq_len: int,
        max_oup_seq_len: int,
        p_drop: float,
        is_train: bool,
        bucket_multiple: int = 128,
        seed: int = 0,
    ) -> None:
        self.corpus = corpus
        self.preds = preds
        self.max_inp_seq_len = max_inp_seq_len
        self.max_oup_seq_len = max_oup_seq_len
        self.p_drop = p_drop
        self.is_train = is_train
        self.bucket_multiple = bucket_multiple
        self.tokenizer = ByT5Tokenizer()
        self.rng = np.random.default_rng(seed)
        self.data = self._load_data(data_path)

    def _load_data(self, data_path: str) -> List[Example]:
        data: List[Example] = []
        with open(data_path) as f:
            theorems = json.load(f)
        for thm in theorems:
            for tac in thm["traced_tactics"]:
                data.append(
                    {
                        "url": thm["url"],
                        "commit": thm["commit"],
                        "file_path": thm["file_path"],
                        "full_name": thm["full_name"],
                        "state": tac["state_before"],
                        "tactic": remove_marks(tac["tactic"]),
                    }
                )
        return data

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Example:
        ex = dict(self.data[idx])
        if self.preds is not None:
            pred = self.preds[ex["file_path"], ex["full_name"], ex["state"]]
            ex["state"] = format_augmented_state(
                ex["state"],
                pred["retrieved_premises"],
                self.max_inp_seq_len,
                self.p_drop if self.is_train else 0.0,
                rng=self.rng,
            )
        ex["state"] = remove_marks(ex["state"])
        return ex

    def collate(self, examples: List[Example]) -> Batch:
        state = [ex["state"] for ex in examples]
        tok_state = self.tokenizer(
            state,
            max_length=self.max_inp_seq_len,
            bucket_multiple=self.bucket_multiple,
        )
        tactic = [ex["tactic"] for ex in examples]
        tok_tactic = self.tokenizer(
            tactic,
            max_length=self.max_oup_seq_len,
            bucket_multiple=self.bucket_multiple,
        )
        tactic_ids = tok_tactic.input_ids.copy().astype(np.int32)
        tactic_ids[tok_tactic.attention_mask == 0] = -100

        batch: Batch = {
            "state": state,
            "state_ids": tok_state.input_ids,
            "state_mask": tok_state.attention_mask,
            "tactic": tactic,
            "tactic_ids": tactic_ids,
            "tactic_mask": tok_tactic.attention_mask,
        }
        for key in examples[0].keys():
            if key not in batch:
                batch[key] = [ex[key] for ex in examples]
        return batch


def load_preds(preds_path: str) -> Dict:
    """Load a retriever ``predictions.pickle`` into the lookup dict keyed by
    (path, full_name, state) (`generation/datamodule.py:150-154`).

    Accepts both this framework's artifacts and reference-produced ones
    (class paths remapped at unpickle time)."""
    from reprover_tpu_torch.data.interop import load_reference_pickle

    preds = {}
    records = load_reference_pickle(preds_path)
    for pred in records:
        ctx = pred["context"]
        preds[ctx.path, ctx.theorem_full_name, ctx.state] = pred
    return preds


class GeneratorDataModule:
    def __init__(
        self,
        data_path: str,
        batch_size: int,
        eval_batch_size: int,
        max_inp_seq_len: int,
        max_oup_seq_len: int,
        p_drop: float,
        corpus_path: Optional[str] = None,
        preds_path: Optional[str] = None,
        bucket_multiple: int = 128,
        seed: int = 0,
    ) -> None:
        self.data_path = data_path
        self.batch_size = batch_size
        self.eval_batch_size = eval_batch_size
        self.max_inp_seq_len = max_inp_seq_len
        self.max_oup_seq_len = max_oup_seq_len
        self.p_drop = p_drop
        self.bucket_multiple = bucket_multiple
        self.seed = seed
        self.corpus = Corpus(corpus_path) if corpus_path is not None else None
        self.preds = load_preds(preds_path) if preds_path is not None else None
        self.ds_train: Optional[GeneratorDataset] = None
        self.ds_val: Optional[GeneratorDataset] = None

    def setup(self, stage: Optional[str] = None) -> None:
        def make(split: str, is_train: bool) -> GeneratorDataset:
            return GeneratorDataset(
                os.path.join(self.data_path, f"{split}.json"),
                self.corpus,
                self.preds,
                self.max_inp_seq_len,
                self.max_oup_seq_len,
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
