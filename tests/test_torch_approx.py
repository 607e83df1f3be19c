"""PyTorch port, ``approximate=True`` retrieval (the JAX package's
``lax.approx_max_k``, which XLA computes as the exact top-k off a TPU):
the port's exact ``cosine_topk`` against the JAX function's
``approximate=True`` at [3, 4096] x 64 with tied scores and a mask (indices
equal, values within 1e-6); ``retrieval.main predict
--model.approx true`` writing the predictions of the call without it; and
``prover/evaluate.py --approx`` running a search on the replay environment
as it runs without the flag."""

import importlib
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.models import export_hf_t5
from reprover_tpu.models import t5 as jt5
from reprover_tpu.ops import topk as jtopk
from reprover_tpu_torch.ops import topk as ttopk
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cosine_topk_approximate_matches_jax():
    """Embedding entries are multiples of 1/4 in [-1, 1], so every
    similarity is exact in fp32 and many tie; a quarter of the premises are
    masked per query, one query sees fewer than k."""
    rng = np.random.default_rng(0)
    b, n, d, k = 3, 4096, 64, 100
    ctx = (rng.integers(-4, 5, (b, d)) / 4).astype(np.float32)
    prem = (rng.integers(-4, 5, (n, d)) / 4).astype(np.float32)
    prem[1::7] = prem[::7][: len(prem[1::7])]  # duplicate rows: exact ties
    mask = rng.random((b, n)) < 0.75
    mask[2, 60:] = False  # 60 accessible: the last values are -inf
    jv, ji = jtopk.cosine_topk(jnp.asarray(ctx), jnp.asarray(prem), jnp.asarray(mask), k,
                               approximate=True)
    tc, tp, tm = (torch.from_numpy(x) for x in (ctx, prem, mask))
    tv, ti = ttopk.cosine_topk(tc, tp, tm, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    assert len(np.unique(np.asarray(jv)[0])) < k  # ties among the kept values


def test_predict_with_approx_writes_the_exact_predictions(toy_corpus_path, toy_dataset_dir,
                                                          tmp_path):
    from reprover_tpu_torch.retrieval.main import main

    common = ["--device", "cpu", "--model.tiny", "true", "--model.num_retrieved", "4",
              "--data.data_path", toy_dataset_dir, "--data.corpus_path", toy_corpus_path,
              "--data.eval_batch_size", "2", "--data.max_seq_len", "256",
              "--log_dir", str(tmp_path)]
    main(["predict"] + common + ["--preds_out", "exact.pickle"])
    main(["predict"] + common + ["--preds_out", "approx.pickle", "--model.approx", "true"])
    preds = {}
    for tag in ("exact", "approx"):
        with open(tmp_path / f"{tag}.pickle", "rb") as f:
            preds[tag] = pickle.load(f)
    assert len(preds["approx"]) == len(preds["exact"]) == 9
    for got, want in zip(preds["approx"], preds["exact"]):
        assert [p.full_name for p in got["retrieved_premises"]] == [
            p.full_name for p in want["retrieved_premises"]]
        assert got["scores"] == want["scores"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A synthetic benchmark whose theorems see >= 100 premises (the
    retrieval-augmented generator retrieves 100), tiny generator and
    retriever checkpoints and the retriever's index."""
    out = str(tmp_path_factory.mktemp("approx_bench"))
    subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "scripts", "make_synthetic_benchmark.py"),
         "--out", out, "--num-files", "30", "--premises-per-file", "8", "--num-theorems", "20",
         "--min-accessible", "100"],
        check=True, cwd=REPO_ROOT, capture_output=True)
    cfg = jt5.T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=1,
                       num_decoder_layers=1)
    gen = jt5.init_params(jax.random.PRNGKey(1), cfg)
    ret = jt5.init_params(jax.random.PRNGKey(2), cfg)
    export_hf_t5(gen, cfg, os.path.join(out, "gen"))
    export_hf_t5({"shared_embedding": ret["shared_embedding"], "encoder": ret["encoder"]}, cfg,
                 os.path.join(out, "ret"), encoder_only=True)
    from reprover_tpu_torch.retrieval.indexer import main as index

    index(["--ckpt-path", os.path.join(out, "ret"), "--corpus-path",
           os.path.join(out, "corpus.jsonl"), "--output-path", os.path.join(out, "idx"),
           "--batch-size", "32", "--max-seq-len", "256", "--device", "cpu"])
    return out


def test_evaluate_with_approx_runs_on_the_replay_environment(bench, tmp_path, monkeypatch):
    from reprover_tpu_torch.prover import environment

    # The package re-exports the harness function under the module's name.
    evaluate = importlib.import_module("reprover_tpu_torch.prover.evaluate")
    with open(os.path.join(bench, "random", "val.json")) as f:
        val = json.load(f)
    monkeypatch.setattr(environment, "LeanDojoEnvironment",
                        lambda *a, **kw: environment.environment_from_dataset(val))
    monkeypatch.chdir(tmp_path)
    argv = ["--data-path", os.path.join(bench, "random"), "--gen_ckpt_path",
            os.path.join(bench, "gen"), "--ret_ckpt_path", os.path.join(bench, "ret"),
            "--indexed-corpus-path", os.path.join(bench, "idx"), "--num-theorems", "1",
            "--num-sampled-tactics", "2", "--max-expansions", "1", "--max-inp-seq-len", "512",
            "--max-oup-seq-len", "8", "--device", "cpu", "--save-results"]
    assert evaluate.build_parser().parse_args(argv + ["--approx"]).approx
    results = {}
    for tag, extra in (("exact", []), ("approx", ["--approx"])):
        pass_1 = evaluate.main(argv + ["--exp-id", tag] + extra)
        with open(tmp_path / f"{tag}_results.pickle", "rb") as f:
            (res,) = pickle.load(f)
        results[tag] = (pass_1, res.status.name, res.num_searched_nodes, res.num_total_nodes)
    assert results["approx"] == results["exact"]
    assert results["exact"][2] >= 1  # the search expanded its root
