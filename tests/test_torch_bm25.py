"""PyTorch port, the BM25 baseline (``retrieval/bm25.py``): Okapi scores
against the JAX package's on seeded token lists (rtol 1e-12) and on a
subset, the trained tokenizer file byte-equal, ``process_theorem``'s
retrieved lists identical (ties included), and ``run_bm25`` end to end on
the toy dataset, in one process and in a pool of 2, equal to the JAX
package's predictions and scored by the port's evaluator."""

import json
import os
import pickle

import numpy as np
import pytest

from reprover_tpu.data import Corpus as JaxCorpus
from reprover_tpu.native import BpeTokenizer as JaxBpe
from reprover_tpu.retrieval import bm25 as jbm25
from reprover_tpu_torch.data import Corpus
from reprover_tpu_torch.native import BpeTokenizer
from reprover_tpu_torch.retrieval import BM25Okapi, build_preds_map, evaluate_split
from reprover_tpu_torch.retrieval import bm25 as tbm25
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()


def _seeded_docs(seed, n_docs=60, vocab=25):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    docs = [list(rng.choice(words, size=int(rng.integers(0, 30)))) for _ in range(n_docs)]
    queries = [list(rng.choice(words + ["unseen"], size=int(rng.integers(0, 8))))
               for _ in range(10)]
    return docs, queries


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scores_match_jax(seed):
    docs, queries = _seeded_docs(seed)
    ours, theirs = BM25Okapi(docs), jbm25.BM25Okapi(docs)
    assert (ours.idf < 0).sum() == 0  # negative idfs floored, as rank_bm25 does
    for q in queries:
        np.testing.assert_allclose(ours.get_scores(q), theirs.get_scores(q), rtol=1e-12, atol=0)
    subset = np.random.default_rng(seed).permutation(len(docs))[:17]
    for q in queries:
        np.testing.assert_allclose(ours.get_batch_scores(q, subset),
                                   theirs.get_batch_scores(q, subset), rtol=1e-12, atol=0)
        np.testing.assert_array_equal(ours.get_batch_scores(q, subset), ours.get_scores(q)[subset])


@pytest.fixture()
def bench(toy_corpus_path, toy_dataset_dir, tmp_path):
    """The toy dataset as a benchmark dir: ``random/`` beside ``corpus.jsonl``."""
    data_dir = tmp_path / "random"
    data_dir.mkdir()
    for split in ("train", "val", "test"):
        os.link(os.path.join(toy_dataset_dir, f"{split}.json"), data_dir / f"{split}.json")
    os.link(toy_corpus_path, tmp_path / "corpus.jsonl")
    return str(data_dir)


def test_trained_tokenizer_file_byte_equal(bench, tmp_path):
    ours, theirs = str(tmp_path / "ours.tok"), str(tmp_path / "theirs.tok")
    tbm25.train_tokenizer(bench, ours, vocab_size=300)
    jbm25.train_tokenizer(bench, theirs, vocab_size=300)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def _names(preds):
    return [(p["file_path"], p["full_name"], p["tactic_idx"],
             [(q.path, q.full_name) for q in p["retrieved_premises"]],
             [(q.path, q.full_name) for q in p["all_pos_premises"]], p["scores"]) for p in preds]


def test_process_theorem_matches_jax_ties_included(toy_corpus_path, toy_dataset_dir):
    """Every accessible premise retrieved, so those that share no token with
    the state tie at score 0: the retrieved order (argsort of the scores,
    reversed) must still agree."""
    corpus, jcorpus = Corpus(toy_corpus_path), JaxCorpus(toy_corpus_path)
    premises = [p.serialize() for p in corpus.all_premises]
    tok, jtok = BpeTokenizer(force_python=True), JaxBpe(force_python=True)
    tok.train(premises, vocab_size=60)
    jtok.train(premises, vocab_size=60)
    bm25 = BM25Okapi([tok.encode(p) for p in premises])
    jbm = jbm25.BM25Okapi([jtok.encode(p) for p in premises])
    with open(os.path.join(toy_dataset_dir, "val.json")) as f:
        theorems = json.load(f)
    tied = 0
    for thm in theorems:
        for use_all in (False, True):
            k = len(corpus)
            got = tbm25.process_theorem(thm, k, use_all, corpus=corpus, tokenizer=tok, bm25=bm25)
            want = jbm25.process_theorem(thm, k, use_all, corpus=jcorpus, tokenizer=jtok,
                                         bm25=jbm)
            assert _names(got) == _names(want)
            tied += sum(len(p["scores"]) - len(set(p["scores"])) for p in got)
            acc = set(corpus.get_accessible_premise_indexes(thm["file_path"],
                                                            tuple(thm["start"])))
            for p in got:
                assert use_all or {corpus.premise_index(q) for q in p["retrieved_premises"]} <= acc
    assert tied > 0


@pytest.mark.parametrize("num_cpus", [1, 2])
def test_run_bm25_end_to_end_matches_jax(bench, tmp_path, num_cpus):
    tok_path = str(tmp_path / "bpe.tok")
    tbm25.train_tokenizer(bench, tok_path, vocab_size=300)
    out, jout = str(tmp_path / "preds.pickle"), str(tmp_path / "jax_preds.pickle")
    tbm25.run_bm25(tok_path, bench, out, num_retrieved=4, num_cpus=num_cpus)
    jbm25.run_bm25(tok_path, bench, jout, num_retrieved=4, num_cpus=1)
    from reprover_tpu_torch.data.interop import load_reference_pickle

    preds = load_reference_pickle(out)
    with open(jout, "rb") as f:
        jpreds = pickle.load(f)
    assert len(preds) == 9  # 3 splits x 3 tactics

    def key(p):
        return (p["file_path"], p["full_name"], p["tactic_idx"])

    assert sorted(_names(preds)) == sorted(_names(jpreds))
    uniq = {(p["file_path"], p["full_name"], tuple(p["start"]), p["tactic_idx"]): p
            for p in sorted(preds, key=key)}
    with open(os.path.join(bench, "val.json")) as f:
        data = json.load(f)
    r1, r10, mrr = evaluate_split(data, build_preds_map(list(uniq.values())))
    assert 0 <= r1 <= 100 and 0 <= r10 <= 100 and 0 < mrr <= 1
