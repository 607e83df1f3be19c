"""BM25 sparse-retrieval baseline: a copy of ``reprover_tpu/retrieval/bm25.py:1-303``,
which the port may not import, over the port's ``data/`` and
``native/bpe.{py,cpp}``. Host-side numpy and a process pool: it needs no
device. ``python -m reprover_tpu_torch.retrieval.bm25 train-tokenizer
--data-path <split dir> --output-path <tok.json>``, then ``retrieve
--tokenizer-path <tok.json> --data-path <split dir> --output-path
<predictions.pickle> --num-cpus N``; ``retrieval.evaluate`` scores the pickle.

Parity with `/root/reference/retrieval/bm25/main.py` + the ``rank_bm25``
``BM25Okapi`` scorer it depends on, with the HF Rust BPE replaced by the
framework's C++ tokenizer (:mod:`reprover_tpu_torch.native.bpe`) and the Ray actor
pool replaced by a multiprocessing pool (SURVEY.md §2.2).

``BM25Okapi`` formula (rank_bm25 semantics, k1=1.5, b=0.75, epsilon=0.25):
idf(t) = ln((N - df + 0.5) / (df + 0.5)); negative idfs are floored to
``epsilon * average_idf``. score(q, d) = sum_t idf(t) * f(t,d) * (k1+1) /
(f(t,d) + k1 * (1 - b + b * |d|/avgdl)).

Scoring is vectorized over the *accessible* subset of documents (the role of
``get_batch_scores``, `bm25/main.py:48`) with a term-at-a-time sparse
accumulation over a CSR-like postings layout — O(query terms x postings)
instead of rank_bm25's per-document Python loop.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import pickle
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class BM25Okapi:
    """Okapi BM25 over pre-tokenized documents (token strings)."""

    def __init__(
        self,
        corpus_tokens: Sequence[Sequence[str]],
        k1: float = 1.5,
        b: float = 0.75,
        epsilon: float = 0.25,
    ) -> None:
        self.k1 = k1
        self.b = b
        n_docs = len(corpus_tokens)
        self.doc_len = np.array([len(d) for d in corpus_tokens], dtype=np.float64)
        self.avgdl = float(self.doc_len.mean()) if n_docs else 0.0

        # term -> postings (doc indices + term frequencies)
        vocab: Dict[str, int] = {}
        postings_doc: List[List[int]] = []
        postings_tf: List[List[int]] = []
        df: List[int] = []
        for di, doc in enumerate(corpus_tokens):
            for tok, tf in Counter(doc).items():
                ti = vocab.get(tok)
                if ti is None:
                    ti = len(vocab)
                    vocab[tok] = ti
                    postings_doc.append([])
                    postings_tf.append([])
                    df.append(0)
                postings_doc[ti].append(di)
                postings_tf[ti].append(tf)
                df[ti] += 1

        self.vocab = vocab
        self.postings_doc = [np.asarray(x, dtype=np.int64) for x in postings_doc]
        self.postings_tf = [np.asarray(x, dtype=np.float64) for x in postings_tf]

        # Okapi idf with negative flooring (rank_bm25 semantics).
        df_arr = np.asarray(df, dtype=np.float64)
        idf = np.log((n_docs - df_arr + 0.5) / (df_arr + 0.5))
        avg_idf = float(idf.mean()) if len(idf) else 0.0
        idf = np.where(idf < 0, epsilon * avg_idf, idf)
        self.idf = idf

        # Precomputed per-document length normalization.
        self._norm = self.k1 * (
            1 - self.b + self.b * self.doc_len / max(self.avgdl, 1e-9)
        )

    def get_scores(self, query_tokens: Sequence[str]) -> np.ndarray:
        """BM25 scores against every document."""
        scores = np.zeros(len(self.doc_len), dtype=np.float64)
        for tok in query_tokens:
            ti = self.vocab.get(tok)
            if ti is None:
                continue
            docs = self.postings_doc[ti]
            tf = self.postings_tf[ti]
            scores[docs] += (
                self.idf[ti] * tf * (self.k1 + 1) / (tf + self._norm[docs])
            )
        return scores

    def get_batch_scores(
        self, query_tokens: Sequence[str], doc_ids: Sequence[int]
    ) -> np.ndarray:
        """Scores restricted to ``doc_ids`` (`bm25/main.py:48` role).

        NB: rank_bm25 computes avgdl over the *full* corpus even for subset
        scoring; parity preserved."""
        return self.get_scores(query_tokens)[np.asarray(doc_ids, dtype=np.int64)]


# ------------------------------------------------------------------ #
# Tokenizer training CLI (role of retrieval/bm25/train_tokenizer.py)
# ------------------------------------------------------------------ #


def train_tokenizer(
    data_path: str, output_path: str, vocab_size: int = 30000
) -> None:
    """Train the BPE tokenizer on premises + train-split proof states
    (`train_tokenizer.py:28-45`)."""
    from reprover_tpu_torch.data import Context, Corpus, Pos
    from reprover_tpu_torch.native import BpeTokenizer

    corpus = Corpus(os.path.join(data_path, "../corpus.jsonl"))
    premises = [p.serialize() for p in corpus.all_premises]

    states: List[str] = []
    with open(os.path.join(data_path, "train.json")) as f:
        for thm in json.load(f):
            for tac in thm["traced_tactics"]:
                states.append(
                    Context(
                        thm["file_path"],
                        thm["full_name"],
                        Pos.of(thm["start"]),
                        tac["state_before"],
                    ).serialize()
                )

    tok = BpeTokenizer()
    tok.train(premises + states, vocab_size=vocab_size)
    tok.save(output_path)
    logger.info("tokenizer saved to %s", output_path)


# ------------------------------------------------------------------ #
# Prediction pipeline (role of retrieval/bm25/main.py)
# ------------------------------------------------------------------ #

_worker_state: Dict[str, Any] = {}


def _init_worker(tokenizer_path: str, data_path: str) -> None:
    """Per-process init: each worker holds its own corpus + BM25 index
    (`bm25/main.py:73-89` actor state)."""
    from reprover_tpu_torch.data import Corpus
    from reprover_tpu_torch.native import BpeTokenizer

    tokenizer = BpeTokenizer.load(tokenizer_path)
    corpus = Corpus(os.path.join(data_path, "../corpus.jsonl"))
    tokenized = [tokenizer.encode(p.serialize()) for p in corpus.all_premises]
    _worker_state["tokenizer"] = tokenizer
    _worker_state["corpus"] = corpus
    _worker_state["bm25"] = BM25Okapi(tokenized)


def process_theorem(
    thm: Dict[str, Any],
    num_retrieved: int = 100,
    use_all_premises: bool = False,
    corpus: Any = None,
    tokenizer: Any = None,
    bm25: Any = None,
) -> List[Dict[str, Any]]:
    """Retrieve premises for each tactic of one theorem
    (`bm25/main.py:24-70`)."""
    from reprover_tpu_torch.data import Context, Pos, get_all_pos_premises

    corpus = corpus or _worker_state["corpus"]
    tokenizer = tokenizer or _worker_state["tokenizer"]
    bm25 = bm25 or _worker_state["bm25"]

    file_path = thm["file_path"]
    if use_all_premises:
        accessible = list(range(len(corpus)))
    else:
        accessible = corpus.get_accessible_premise_indexes(
            file_path, Pos.of(thm["start"])
        )

    preds = []
    for i, tac in enumerate(thm["traced_tactics"]):
        ctx = Context(
            file_path, thm["full_name"], Pos.of(thm["start"]), tac["state_before"]
        )
        q = tokenizer.encode(ctx.serialize())
        scores = np.asarray(bm25.get_batch_scores(q, accessible))
        top = np.argsort(scores)[::-1][:num_retrieved]
        retrieved_idxs = [accessible[j] for j in top]
        preds.append(
            {
                "url": thm["url"],
                "commit": thm["commit"],
                "file_path": file_path,
                "full_name": thm["full_name"],
                "start": thm["start"],
                "tactic_idx": i,
                "context": ctx,
                "all_pos_premises": get_all_pos_premises(
                    tac["annotated_tactic"], corpus
                ),
                "retrieved_premises": [corpus[j] for j in retrieved_idxs],
                "scores": scores[top].tolist(),
            }
        )
    return preds


def _process_one(args: Tuple[Dict[str, Any], int, bool]) -> List[Dict[str, Any]]:
    thm, num_retrieved, use_all = args
    return process_theorem(thm, num_retrieved, use_all)


def run_bm25(
    tokenizer_path: str,
    data_path: str,
    output_path: str,
    num_retrieved: int = 100,
    use_all_premises: bool = False,
    num_cpus: int = 32,
    splits: Sequence[str] = ("train", "val", "test"),
) -> None:
    # Fail fast here rather than hanging a worker pool on a bad path.
    assert os.path.exists(tokenizer_path), f"no tokenizer at {tokenizer_path}"
    theorems = list(
        itertools.chain.from_iterable(
            json.load(open(os.path.join(data_path, f"{split}.json")))
            for split in splits
        )
    )
    logger.info("BM25 over %d theorems with %d processes", len(theorems), num_cpus)

    if num_cpus > 1:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        with ctx.Pool(
            num_cpus, initializer=_init_worker, initargs=(tokenizer_path, data_path)
        ) as pool:
            chunks = pool.imap_unordered(
                _process_one,
                [(t, num_retrieved, use_all_premises) for t in theorems],
            )
            preds = list(itertools.chain.from_iterable(chunks))
    else:
        _init_worker(tokenizer_path, data_path)
        preds = list(
            itertools.chain.from_iterable(
                process_theorem(t, num_retrieved, use_all_premises)
                for t in theorems
            )
        )

    with open(output_path, "wb") as f:
        pickle.dump(preds, f)
    logger.info("saved predictions to %s", output_path)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="BM25 premise retrieval baseline")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_tok = sub.add_parser("train-tokenizer")
    p_tok.add_argument("--vocab-size", type=int, default=30000)
    p_tok.add_argument("--data-path", type=str, required=True)
    p_tok.add_argument("--output-path", type=str, required=True)

    p_run = sub.add_parser("retrieve")
    p_run.add_argument("--tokenizer-path", type=str, required=True)
    p_run.add_argument("--data-path", type=str, required=True)
    p_run.add_argument("--output-path", type=str, required=True)
    p_run.add_argument("--num-retrieved", type=int, default=100)
    p_run.add_argument("--use-all-premises", action="store_true")
    p_run.add_argument("--num-cpus", type=int, default=32)

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    if args.cmd == "train-tokenizer":
        train_tokenizer(args.data_path, args.output_path, args.vocab_size)
    else:
        run_bm25(
            args.tokenizer_path,
            args.data_path,
            args.output_path,
            args.num_retrieved,
            args.use_all_premises,
            args.num_cpus,
        )


if __name__ == "__main__":
    main()
