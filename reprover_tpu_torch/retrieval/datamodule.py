"""Retrieval data pipeline: flattening, negative sampling, batch collation.

A copy of the JAX package's ``retrieval/datamodule.py``. Capability parity with the reference datamodule
(`reference/retrieval/datamodule.py`), re-designed for TPU execution:

- Flattening semantics match `retrieval/datamodule.py:44-90`: one example per
  (tactic, positive premise) in training, one per tactic in eval.
- Negative sampling matches `retrieval/datamodule.py:95-128`: premises are
  partitioned into "in the positive premise's file" vs "outside it" (only
  premises accessible at the context position), then
  ``min(num_in_file_negatives, available)`` in-file + random out-of-file
  negatives are drawn.
- Collation produces a single stacked premise tensor ``[B*(1+n), L]`` in
  column order [pos(B), neg_0(B), neg_1(B), ...] so the whole premise side is
  ONE encoder pass on the MXU instead of the reference's 1+n separate
  pad-to-longest groups, and the ``[B, B*(1+n)]`` multi-positive label matrix
  (`retrieval/datamodule.py:160-175`) lines up column-for-column.
- Padding is bucketed (multiples of ``bucket_multiple``) so XLA compiles a
  handful of shapes instead of one per batch; the masked mean-pool makes
  padding mathematically inert.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from reprover_tpu_torch.data import Context, Corpus, Pos, get_all_pos_premises
from reprover_tpu_torch.tokenizer import ByT5Tokenizer

Example = Dict[str, Any]
Batch = Dict[str, Any]


class RetrievalDataset:
    """Flattened (tactic, premise) examples with negative sampling."""

    def __init__(
        self,
        data_paths: Sequence[str],
        corpus: Corpus,
        num_negatives: int,
        num_in_file_negatives: int,
        max_seq_len: int,
        is_train: bool,
        bucket_multiple: int = 128,
        seed: int = 0,
        strict_negatives: bool = False,
    ) -> None:
        assert 0 <= num_in_file_negatives <= num_negatives
        self.corpus = corpus
        self.num_negatives = num_negatives
        self.num_in_file_negatives = num_in_file_negatives
        self.max_seq_len = max_seq_len
        self.is_train = is_train
        self.bucket_multiple = bucket_multiple
        # strict_negatives reproduces the reference's `random.sample`
        # behavior exactly: too few accessible out-of-file premises is an
        # error (`reference/retrieval/datamodule.py:121-127`). Default
        # off: small/synthetic corpora routinely hit it and back-fill instead.
        self.strict_negatives = strict_negatives
        self.tokenizer = ByT5Tokenizer()
        self.rng = np.random.default_rng(seed)
        self.data: List[Example] = list(
            itertools.chain.from_iterable(self._load_data(p) for p in data_paths)
        )

    def _load_data(self, data_path: str) -> List[Example]:
        """One example per (tactic, pos premise) when training, per tactic
        otherwise (`retrieval/datamodule.py:44-90`)."""
        data: List[Example] = []
        with open(data_path) as f:
            theorems = json.load(f)
        for thm in theorems:
            file_path = thm["file_path"]
            for i, tac in enumerate(thm["traced_tactics"]):
                context = Context(
                    file_path,
                    thm["full_name"],
                    Pos.of(thm["start"]),
                    tac["state_before"],
                )
                all_pos_premises = get_all_pos_premises(
                    tac["annotated_tactic"], self.corpus
                )
                base = {
                    "url": thm["url"],
                    "commit": thm["commit"],
                    "file_path": file_path,
                    "full_name": thm["full_name"],
                    "start": thm["start"],
                    "tactic_idx": i,
                    "context": context,
                    "all_pos_premises": all_pos_premises,
                }
                if self.is_train:
                    # Training ignores tactics with no positive premises.
                    for pos_premise in all_pos_premises:
                        data.append({**base, "pos_premise": pos_premise})
                else:
                    data.append(base)
        return data

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Example:
        if not self.is_train:
            return self.data[idx]
        ex = dict(self.data[idx])
        ex["neg_premises"] = self._sample_negatives(ex)
        return ex

    def _sample_negatives(self, ex: Example) -> List:
        """In-file + random accessible negatives
        (`retrieval/datamodule.py:99-128` semantics, including the quirk that
        "in-file" means *in the positive premise's file*)."""
        ctx: Context = ex["context"]
        pos_premise = ex["pos_premise"]
        in_file: List = []
        out_file: List = []

        # Premises defined earlier in the context's own file.
        for p in self.corpus.get_premises(ctx.path):
            if p == pos_premise:
                continue
            if p.end < ctx.theorem_pos:
                if pos_premise.path == ctx.path:
                    in_file.append(p)
                else:
                    out_file.append(p)

        # Premises in transitively imported files.
        for dep in self.corpus.get_dependencies(ctx.path):
            if dep == pos_premise.path:
                in_file.extend(
                    p for p in self.corpus.get_premises(dep) if p != pos_premise
                )
            else:
                out_file.extend(self.corpus.get_premises(dep))

        k_in = min(len(in_file), self.num_in_file_negatives)
        if self.strict_negatives:
            # Reference semantics: exactly num_negatives - k_in out-of-file
            # samples, error if the pool is too small (random.sample raises,
            # `retrieval/datamodule.py:121-127`).
            k_out = self.num_negatives - k_in
            if k_out > len(out_file):
                raise ValueError(
                    f"strict negative sampling: need {k_out} out-of-file "
                    f"negatives but only {len(out_file)} accessible"
                )
        else:
            k_out = min(len(out_file), self.num_negatives - k_in)
        # Scarce out-of-file pool: top back up from in-file (the reference's
        # `random.sample` would raise here, `retrieval/datamodule.py:123-127`;
        # real Mathlib corpora never hit it, small/synthetic ones do).
        k_in = min(len(in_file), self.num_negatives - k_out)
        chosen_in = [
            in_file[i]
            for i in self.rng.choice(len(in_file), size=k_in, replace=False)
        ]
        chosen_out = [
            out_file[i]
            for i in self.rng.choice(len(out_file), size=k_out, replace=False)
        ]
        chosen = chosen_in + chosen_out
        pool = in_file + out_file
        if len(chosen) < self.num_negatives and pool:
            # Last resort: fewer accessible premises than negatives — repeat.
            extra = self.num_negatives - len(chosen)
            chosen += [
                pool[i] for i in self.rng.choice(len(pool), size=extra, replace=True)
            ]
        return chosen

    def collate(self, examples: List[Example]) -> Batch:
        batch: Batch = {}
        contexts = [ex["context"] for ex in examples]
        tok_ctx = self.tokenizer(
            [c.serialize() for c in contexts],
            max_length=self.max_seq_len,
            bucket_multiple=self.bucket_multiple,
        )
        batch["context"] = contexts
        batch["context_ids"] = tok_ctx.input_ids
        batch["context_mask"] = tok_ctx.attention_mask

        if self.is_train:
            b = len(examples)
            n = self.num_negatives
            # Column order [pos(B), neg_0(B), ..., neg_{n-1}(B)] matching the
            # reference label layout (`retrieval/datamodule.py:164-173`).
            premises = [ex["pos_premise"] for ex in examples]
            for i in range(n):
                premises.extend(ex["neg_premises"][i] for ex in examples)
            tok_prem = self.tokenizer(
                [p.serialize() for p in premises],
                max_length=self.max_seq_len,
                bucket_multiple=self.bucket_multiple,
            )
            batch["pos_premise"] = premises[:b]
            batch["neg_premises"] = [
                premises[b * (1 + i) : b * (2 + i)] for i in range(n)
            ]
            batch["premise_ids"] = tok_prem.input_ids
            batch["premise_mask"] = tok_prem.attention_mask

            label = np.zeros((b, b * (1 + n)), dtype=np.float32)
            for j in range(b):
                all_pos = examples[j]["all_pos_premises"]
                for k, premise_k in enumerate(premises):
                    label[j, k] = float(premise_k in all_pos)
            batch["label"] = label

        for key in examples[0].keys():
            if key not in batch:
                batch[key] = [ex[key] for ex in examples]
        return batch


class Loader:
    """Minimal shuffling batch loader (torch-DataLoader replacement).

    The reference leans on torch DataLoader worker processes
    (`retrieval/datamodule.py:269-278`); host-side tokenization of byte
    sequences is cheap enough that a single-process loader keeps a TPU fed —
    collation overlaps with device compute because dispatch is async.
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool,
        drop_last: bool,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for lo in range(0, len(order), self.batch_size):
            idxs = order[lo : lo + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            yield self.dataset.collate([self.dataset[int(i)] for i in idxs])


class RetrievalDataModule:
    """Wires the corpus + train/val/predict datasets
    (`retrieval/datamodule.py:201-300`)."""

    def __init__(
        self,
        data_path: str,
        corpus_path: str,
        num_negatives: int,
        num_in_file_negatives: int,
        batch_size: int,
        eval_batch_size: int,
        max_seq_len: int,
        bucket_multiple: int = 128,
        seed: int = 0,
        strict_negatives: bool = False,
    ) -> None:
        import os

        self.strict_negatives = strict_negatives
        self.data_path = data_path
        self.num_negatives = num_negatives
        self.num_in_file_negatives = num_in_file_negatives
        self.batch_size = batch_size
        self.eval_batch_size = eval_batch_size
        self.max_seq_len = max_seq_len
        self.bucket_multiple = bucket_multiple
        self.seed = seed
        self.corpus = Corpus(corpus_path)
        self._join = lambda split: os.path.join(data_path, f"{split}.json")
        self.ds_train: Optional[RetrievalDataset] = None
        self.ds_val: Optional[RetrievalDataset] = None
        self.ds_pred: Optional[RetrievalDataset] = None

    def setup(self, stage: Optional[str] = None) -> None:
        def make(paths, is_train):
            return RetrievalDataset(
                paths,
                self.corpus,
                self.num_negatives,
                self.num_in_file_negatives,
                self.max_seq_len,
                is_train,
                self.bucket_multiple,
                self.seed,
                strict_negatives=self.strict_negatives,
            )

        self.ds_train = make([self._join("train")], True)
        if stage in (None, "fit", "validate"):
            self.ds_val = make([self._join("val")], False)
        if stage in (None, "fit", "predict"):
            # Predict over every split (`retrieval/datamodule.py:255-267`).
            self.ds_pred = make(
                [self._join(s) for s in ("train", "val", "test")], False
            )

    def train_dataloader(self) -> Loader:
        return Loader(
            self.ds_train, self.batch_size, True, True, self.seed
        )

    def val_dataloader(self) -> Loader:
        return Loader(self.ds_val, self.eval_batch_size, False, False)

    def predict_dataloader(self) -> Loader:
        return Loader(self.ds_pred, self.eval_batch_size, False, False)
