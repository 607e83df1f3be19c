"""PyTorch port, the slice end to end on a tiny synthetic benchmark: with
the same bridged weights, the JAX and port retrievers return the same
premises, the generators the same beams, and best-first search on the
replay environment the same result. fp32 on the CPU, scores within 1e-4."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from reprover_tpu.data import Context, Pos
from reprover_tpu.generation import TacticGeneratorModel as JaxGenerator
from reprover_tpu.models import export_hf_t5
from reprover_tpu.models import t5 as jt5
from reprover_tpu.prover import BestFirstSearchProver, RepoSpec, Theorem, environment_from_dataset
from reprover_tpu.prover import tactic_generator as jtg
from reprover_tpu.retrieval.retriever import PremiseRetriever as JaxRetriever
from reprover_tpu_torch import data as tdata
from reprover_tpu_torch import prover as tprover
from reprover_tpu_torch.generation import TacticGeneratorModel
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.prover import tactic_generator as ttg
from reprover_tpu_torch.retrieval import PremiseRetriever
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jt5.T5Config(
    d_model=64, d_kv=16, d_ff=128, num_heads=4, num_encoder_layers=2, num_decoder_layers=2
)
TCFG = tt5.T5Config(
    **{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(tt5.T5Config)
       if f.name != "compute_dtype"}
)
MAX_INP, MAX_OUP, K, BEAMS = 256, 12, 3, 4


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_slice"))
    subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "scripts", "make_synthetic_benchmark.py"),
         "--out", out, "--num-files", "12", "--premises-per-file", "5",
         "--num-theorems", "30", "--min-accessible", str(K)],
        check=True, cwd=REPO_ROOT, capture_output=True,
    )
    with open(os.path.join(out, "random", "val.json")) as f:
        val = json.load(f)
    return out, val


@pytest.fixture(scope="module")
def models(bench):
    out, _ = bench
    gen_j = jt5.init_params(jax.random.PRNGKey(7), JCFG)
    full = jt5.init_params(jax.random.PRNGKey(8), JCFG)
    ret_j = {"shared_embedding": full["shared_embedding"], "encoder": full["encoder"]}
    jax_ret = JaxRetriever(ret_j, JCFG, MAX_INP)
    ours_ret = PremiseRetriever(params_from_jax(jax.tree.map(np.asarray, ret_j)), TCFG, MAX_INP)
    corpus = os.path.join(out, "corpus.jsonl")
    jax_ret.load_corpus(corpus)
    ours_ret.load_corpus(corpus)
    jax_gen = JaxGenerator(gen_j, JCFG, MAX_INP, MAX_OUP)
    ours_gen = TacticGeneratorModel(
        params_from_jax(jax.tree.map(np.asarray, jt5.fuse_mlp_params(gen_j))), TCFG, MAX_INP, MAX_OUP
    )
    return dict(jax_ret=jax_ret, ours_ret=ours_ret, jax_gen=jax_gen, ours_gen=ours_gen,
                gen_j=gen_j, ret_j=ret_j)


def _contexts(val, n, data=None):
    """Contexts of the first ``n`` theorems, as the JAX package's classes or
    as those of ``data`` (the port's copy)."""
    context, pos = (Context, Pos) if data is None else (data.Context, data.Pos)
    ctxs = []
    for thm in val[:n]:
        tac = thm["traced_tactics"][0]
        ctxs.append(context(thm["file_path"], thm["full_name"], pos.of(thm["start"]),
                            tac["state_before"]))
    return ctxs


def test_same_premises_and_beams(bench, models):
    _, val = bench
    models["jax_ret"].reindex_corpus(batch_size=16)
    models["ours_ret"].reindex_corpus(batch_size=16)
    np.testing.assert_allclose(
        models["ours_ret"].corpus_embeddings.numpy(),
        np.asarray(models["jax_ret"].corpus_embeddings), atol=1e-5, rtol=1e-4,
    )
    ctxs = _contexts(val, 4)
    jp, js = models["jax_ret"].retrieve_batch(ctxs, K)
    tp, ts = models["ours_ret"].retrieve_batch(_contexts(val, 4, tdata), K)
    assert [[p.full_name for p in row] for row in tp] == [[p.full_name for p in row] for row in jp]
    np.testing.assert_allclose(np.array(ts), np.array(js), atol=1e-4, rtol=1e-4)

    states = [c.state for c in ctxs[:3]]
    jb = models["jax_gen"].generate(states, BEAMS)
    tb = models["ours_gen"].generate(states, BEAMS)
    assert [[t for t, _ in row] for row in tb] == [[t for t, _ in row] for row in jb]
    np.testing.assert_allclose(
        np.array([[s for _, s in row] for row in tb]),
        np.array([[s for _, s in row] for row in jb]), atol=1e-4, rtol=1e-4,
    )


def test_too_few_accessible_premises_raises(models):
    with pytest.raises(ValueError, match="fewer than k"):
        models["ours_ret"].retrieve_batch(
            [tdata.Context("x.lean", "t", tdata.Pos(1, 1), "⊢ True")],
            len(models["ours_ret"].corpus) + 1,
        )


def test_best_first_search_matches_jax(bench, models, tmp_path):
    """The port's generators, loaded from checkpoint paths, drive the port's
    copy of the best-first search to the same results as the JAX package's
    generators drive its own."""
    _, val = bench
    gen_dir, ret_dir, idx_dir = (str(tmp_path / n) for n in ("gen", "ret", "idx"))
    export_hf_t5(models["gen_j"], JCFG, gen_dir)
    export_hf_t5(models["ret_j"], JCFG, ret_dir, encoder_only=True)
    models["ours_ret"].reindex_corpus(batch_size=16)
    models["ours_ret"].to_indexed_corpus().save(idx_dir)

    ours = ttg.RetrievalAugmentedTacticGenerator(
        ttg.LocalTacticGenerator(gen_dir, MAX_INP, MAX_OUP, device="cpu"),
        ret_dir, idx_dir, MAX_INP, max_num_retrieved=K, device="cpu",
    )
    ours.initialize()
    assert isinstance(ours.gen.model, TacticGeneratorModel)
    assert isinstance(ours.retriever, PremiseRetriever)
    theirs = jtg.RetrievalAugmentedTacticGenerator(
        jtg.LocalTacticGenerator(models["jax_gen"]), models["jax_ret"], max_inp_seq_len=MAX_INP,
        max_num_retrieved=K,
    )
    for thm in val[:2]:
        results = []
        for gen, pkg, pos in ((theirs, None, Pos), (ours, tprover, tdata.Pos)):
            prover_cls = BestFirstSearchProver if pkg is None else pkg.BestFirstSearchProver
            env = (environment_from_dataset if pkg is None else pkg.environment_from_dataset)(val)
            theorem = (Theorem if pkg is None else pkg.Theorem)(
                (RepoSpec if pkg is None else pkg.RepoSpec)(thm["url"], thm["commit"]),
                thm["file_path"], thm["full_name"])
            results.append(prover_cls(gen, env, timeout=120, max_expansions=3,
                                      num_sampled_tactics=BEAMS).search(theorem, pos.of(thm["start"])))
        assert results[0] is not None and results[1] is not None
        assert results[1].status.value == results[0].status.value  # two packages' enums
        assert results[1].num_searched_nodes == results[0].num_searched_nodes
        assert results[1].num_total_nodes == results[0].num_total_nodes
        assert results[1].proof == results[0].proof
