"""PyTorch port, the standalone retrieval evaluator
(``retrieval/evaluate.py``): ``build_preds_map`` and ``evaluate_split``
equal to the JAX package's (``==`` on the floats) on the toy dataset's
predictions and on seeded ones (R@k not capped at k, tactics without
positives skipped), a duplicate prediction raising, and the CLI's printed
lines identical to the JAX CLI's on a pickle of the JAX package's premises."""

import json
import os
import pickle
import sys

import numpy as np
import pytest

from reprover_tpu.data import Corpus as JaxCorpus
from reprover_tpu.data import get_all_pos_premises as jax_pos
from reprover_tpu.retrieval import evaluate as jeval
from reprover_tpu_torch.retrieval import build_preds_map, evaluate_split
from reprover_tpu_torch.retrieval import evaluate as teval
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()


def _seeded(seed, num_theorems=30, pool=40, k=20):
    """Theorems and predictions of premise names: 0-4 tactics each, 0-6
    positives (some outside the retrieved list, some tactics with none)."""
    rng = np.random.default_rng(seed)
    names = [f"P{i}" for i in range(pool)]
    data, preds = [], []
    for t in range(num_theorems):
        thm = dict(file_path=f"f{t % 5}.lean", full_name=f"thm{t}", start=[t + 1, 1],
                   traced_tactics=[{} for _ in range(int(rng.integers(0, 5)))])
        data.append(thm)
        for i in range(len(thm["traced_tactics"])):
            pos = list(rng.choice(names, size=int(rng.integers(0, 7)), replace=False))
            preds.append(dict(file_path=thm["file_path"], full_name=thm["full_name"],
                              start=list(thm["start"]), tactic_idx=i, all_pos_premises=pos,
                              retrieved_premises=list(rng.permutation(names)[:k])))
    return data, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_predictions_equal_jax(seed):
    data, preds = _seeded(seed)
    got = evaluate_split(data, build_preds_map(preds))
    want = jeval.evaluate_split(data, jeval.build_preds_map(preds))
    assert got == want
    assert all(np.isfinite(got)) and 0 <= got[0] <= 100 and 0 <= got[2] <= 1


def test_recall_not_capped_and_empty_positives_skipped():
    """12 positives, all in the top 10 -> R@10 = 10/12; a tactic with no
    positives does not count."""
    pos = [f"P{i}" for i in range(12)]
    data = [dict(file_path="a", full_name="t", start=[1, 1], traced_tactics=[{}, {}])]
    preds = [dict(file_path="a", full_name="t", start=[1, 1], tactic_idx=0,
                  all_pos_premises=pos, retrieved_premises=pos),
             dict(file_path="a", full_name="t", start=[1, 1], tactic_idx=1,
                  all_pos_premises=[], retrieved_premises=pos)]
    r1, r10, mrr = evaluate_split(data, build_preds_map(preds))
    assert (r1, r10, mrr) == pytest.approx((100 / 12, 100 * 10 / 12, 1.0), rel=1e-15)
    assert (r1, r10, mrr) == jeval.evaluate_split(data, jeval.build_preds_map(preds))


def test_duplicate_predictions_rejected():
    rec = {"file_path": "a.lean", "full_name": "x", "start": [1, 1], "tactic_idx": 0}
    with pytest.raises(AssertionError):
        build_preds_map([rec, dict(rec)])


def _toy_preds(toy_corpus_path, toy_dataset_dir, seed=0):
    """Predictions over the toy corpus as the JAX package's ``predict``
    records them (its ``Premise`` objects): positives from the annotated
    tactic, a seeded order of the accessible premises."""
    corpus = JaxCorpus(toy_corpus_path)
    rng = np.random.default_rng(seed)
    preds = []
    with open(os.path.join(toy_dataset_dir, "val.json")) as f:
        data = json.load(f)
    for thm in data:
        acc = corpus.get_accessible_premise_indexes(thm["file_path"], tuple(thm["start"]))
        for i, tac in enumerate(thm["traced_tactics"]):
            preds.append(dict(
                file_path=thm["file_path"], full_name=thm["full_name"], start=thm["start"],
                tactic_idx=i, all_pos_premises=jax_pos(tac["annotated_tactic"], corpus),
                retrieved_premises=[corpus[j] for j in rng.permutation(acc)]))
    return data, preds


def test_toy_predictions_and_cli_lines_equal_jax(toy_corpus_path, toy_dataset_dir, tmp_path,
                                                 monkeypatch, capsys):
    data, preds = _toy_preds(toy_corpus_path, toy_dataset_dir)
    want = jeval.evaluate_split(data, jeval.build_preds_map(preds))
    path = tmp_path / "predictions.pickle"
    with open(path, "wb") as f:
        pickle.dump(preds, f)
    from reprover_tpu_torch.data.interop import load_reference_pickle

    ported = load_reference_pickle(str(path))
    assert type(ported[0]["retrieved_premises"][0]).__module__.startswith("reprover_tpu_torch")
    assert evaluate_split(data, build_preds_map(ported)) == want
    assert want[2] > 0

    argv = ["--preds-file", str(path), "--data-path", toy_dataset_dir]
    monkeypatch.setattr(sys, "argv", ["evaluate"] + argv)
    jeval.main()
    jax_lines = capsys.readouterr().out.splitlines()
    teval.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert lines == jax_lines
    assert [line.split(":")[0] for line in lines] == ["train", "val", "test"]
