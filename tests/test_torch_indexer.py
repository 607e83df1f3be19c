"""PyTorch port, the indexer CLI on one CPU process against the JAX
package's indexer on the same tiny checkpoint (exported from seeded JAX
parameters): the same corpus and embeddings (atol 1e-5), an artifact that a
fresh retriever loads without re-embedding, and ``--device cuda`` without a
card raising. The indexer on several ranks: tests/test_torch_data_parallel.py."""

import sys

import jax
import numpy as np
import pytest

from reprover_tpu.models.hf_import import export_hf_t5
from reprover_tpu.models.t5 import T5Config, init_params
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

TINY = T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                num_decoder_layers=2)
ARGS = ["--batch-size", "4", "--max-seq-len", "128"]


@pytest.fixture(scope="module")
def tiny_hf_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hf") / "ckpt")
    export_hf_t5(init_params(jax.random.PRNGKey(0), TINY), TINY, out)
    return out


def test_indexer_matches_jax_and_reloads(tiny_hf_dir, toy_corpus_path, tmp_path, monkeypatch):
    from reprover_tpu.data import IndexedCorpus as JaxIndexedCorpus
    from reprover_tpu.retrieval import indexer as jax_indexer
    from reprover_tpu_torch.data import IndexedCorpus
    from reprover_tpu_torch.retrieval import PremiseRetriever
    from reprover_tpu_torch.retrieval.indexer import main

    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    io = ["--ckpt-path", tiny_hf_dir, "--corpus-path", toy_corpus_path]
    main(io + ["--output-path", ours, "--device", "cpu"] + ARGS)
    monkeypatch.setattr(sys, "argv", ["indexer"] + io + ["--output-path", theirs] + ARGS)
    jax_indexer.main()

    got, want = IndexedCorpus.load(ours), JaxIndexedCorpus.load(theirs)
    assert [p.full_name for p in got.corpus.all_premises] == [
        p.full_name for p in want.corpus.all_premises]
    np.testing.assert_allclose(got.embeddings, want.embeddings, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.embeddings, axis=1), 1.0, rtol=1e-3)

    retriever = PremiseRetriever.load_hf(tiny_hf_dir, 128, device="cpu")
    retriever.load_corpus(ours)
    assert not retriever.embeddings_staled
    np.testing.assert_array_equal(retriever.corpus_embeddings.numpy(), got.embeddings)


def test_indexer_on_cuda_without_a_card_raises(tiny_hf_dir, toy_corpus_path, tmp_path):
    import torch

    from reprover_tpu_torch.retrieval.indexer import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--ckpt-path", tiny_hf_dir, "--corpus-path", toy_corpus_path,
              "--output-path", str(tmp_path / "out"), "--device", "cuda"] + ARGS)
    assert not (tmp_path / "out").exists()
