"""PyTorch port, span-corruption pretraining and the HF export on the CPU:
the span corruption, window sizing and data module's train and val batches
bit-equal to the JAX package's for the same seed; ``generation_loss`` on a
pretrain batch against the JAX package's; a tiny ``main(["fit", ...])``
whose loss falls and whose export reloads in both packages; the export
against the JAX package's ``export_hf_t5`` tensor by tensor; and the port's
own ``safetensors`` reader and writer against the package, and with the
package hidden."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.models import hf_import as jhf
from reprover_tpu.models import t5 as jt5
from reprover_tpu.training import pretrain as jpre
from reprover_tpu.training import tasks as jtasks
from reprover_tpu_torch.models import hf_import as thf
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.training import pretrain as tpre
from reprover_tpu_torch.training import tasks as ttasks
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2, num_decoder_layers=1)


@pytest.fixture()
def tiny_corpus(tmp_path):
    """The JAX package's pretraining test corpus (tests/test_pretrain.py)."""
    path = tmp_path / "corpus.jsonl"
    rng = np.random.default_rng(7)
    with open(path, "w") as f:
        for i in range(20):
            prems = [{"full_name": f"P{i}_{k}", "start": [1, 1], "end": [2, 2],
                      "code": "theorem t%d_%d : a + b = b + a := by " % (i, k)
                      + "x" * int(rng.integers(50, 400))} for k in range(10)]
            f.write(json.dumps({"path": f"F{i}.lean", "imports": [], "premises": prems}) + "\n")
    return str(path)


@pytest.mark.parametrize("length, density, span", [(64, 0.15, 20.0), (200, 0.15, 20.0),
                                                   (1194, 0.15, 20.0), (300, 0.3, 3.0)])
def test_span_corrupt_matches_jax(length, density, span):
    """Same window, same seed: inputs and targets bit-equal, and the two
    generators left in the same state."""
    tokens = np.random.default_rng(length).integers(3, 259, length).astype(np.int32)
    rng_j, rng_t = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        want = jpre.span_corrupt(tokens, rng_j, density, span)
        got = tpre.span_corrupt(tokens, rng_t, density, span)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert rng_j.integers(1 << 30) == rng_t.integers(1 << 30)
    assert tpre.SENTINEL_START == jpre.SENTINEL_START


@pytest.mark.parametrize("max_inp, max_tgt, density, span", [
    (1024, 256, 0.15, 20.0), (128, 64, 0.15, 20.0), (2300, 512, 0.15, 20.0), (512, 512, 0.5, 3.0)])
def test_window_length_matches_jax(max_inp, max_tgt, density, span):
    assert (tpre.window_length_for(max_inp, max_tgt, density, span)
            == jpre.window_length_for(max_inp, max_tgt, density, span))


def _data_modules(path, **kwargs):
    return jpre.PretrainDataModule(path, **kwargs), tpre.PretrainDataModule(path, **kwargs)


def test_datamodule_batches_match_jax(tiny_corpus):
    """Train and val batches bit-equal to the JAX package's for the same
    seed; the stream, split and window too."""
    kwargs = dict(batch_size=4, max_inp_seq_len=128, max_oup_seq_len=64, val_fraction=0.1,
                  seed=3)
    jdm, tdm = _data_modules(tiny_corpus, **kwargs)
    np.testing.assert_array_equal(tdm.train_ids, jdm.train_ids)
    np.testing.assert_array_equal(tdm.val_ids, jdm.val_ids)
    assert tdm.window == jdm.window
    assert tpre.corpus_text(tiny_corpus) == jpre.corpus_text(tiny_corpus)
    jit, tit = jdm.train_dataloader(), tdm.train_dataloader()
    pairs = [(next(jit), next(tit)) for _ in range(3)] + list(zip(jdm.val_batches(2),
                                                                  tdm.val_batches(2)))
    for want, got in pairs:
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_generation_loss_on_pretrain_batch_matches_jax(tiny_corpus):
    """``generation_loss`` on a pretrain batch (sentinels at the top of the
    vocabulary, -100 past each target) and its gradients against the JAX
    package's, fp32: within 1e-5 of each leaf's max|ref|."""
    jdm, _ = _data_modules(tiny_corpus, batch_size=2, max_inp_seq_len=128, max_oup_seq_len=64,
                           val_fraction=0.1, seed=5)
    batch = next(jdm.train_dataloader())
    params = jax.tree.map(np.asarray, jt5.init_params(jax.random.PRNGKey(2),
                                                      jt5.T5Config(**TINY)))
    jcfg, tcfg = jt5.T5Config(**TINY, remat=True), tt5.T5Config(**TINY, remat=True)
    jloss, jgrads = jax.value_and_grad(jtasks.generation_loss)(
        jax.tree.map(jnp.asarray, params), jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    state = ttasks.init_train_state(params_from_jax(params), lr=1e-3, warmup_steps=0)
    loss = ttasks.generation_loss(state.params, tcfg, ttasks.numeric_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = jax.tree.leaves(jgrads)
    got = ttasks.param_leaves(state.params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("extra", [[], ["--model.remat_policy", "lite",
                                        "--model.offload_optimizer", "true"],
                                   ["--model.flash", "false"]])
def test_tiny_fit_exports_and_reloads_in_both_packages(tiny_corpus, tmp_path, extra):
    """``main(["fit", "--device", "cpu", ...])`` with the JAX package's test
    flags (tests/test_pretrain.py): the loss falls, the validation logs
    ``loss_val`` and the probe's metrics, and the export reloads in the port
    (bit-equal to the trained parameters) and in the JAX package. Also with
    remat ``lite`` and host-resident moments, and with the plain attention
    (``--model.flash false``, the JAX package's A/B switch)."""
    export_dir, log_dir = str(tmp_path / "hf_export"), str(tmp_path / "logs")
    state = tpre.main(["fit", "--device", "cpu", "--data.data_path", tiny_corpus,
                       "--data.batch_size", "2", "--data.max_inp_seq_len", "128",
                       "--data.max_oup_seq_len", "64", "--model.tiny", "true",
                       "--model.lr", "1e-3", "--model.warmup_steps", "5",
                       "--trainer.max_steps", "30", "--trainer.val_interval", "15",
                       "--trainer.log_interval", "10", "--export_dir", export_dir,
                       "--log_dir", log_dir] + extra)
    assert state.step == 30
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    val = [r for r in recs if "loss_val" in r]
    assert len(val) == 2 and {"emb_eff_rank", "cos_offdiag_std"} <= set(val[-1])

    params, cfg = thf.load_hf_t5(export_dir)
    assert (cfg.vocab_size, cfg.d_model, cfg.num_decoder_layers) == (384, 32, 1)
    trained = _flat(tt5.fuse_mlp_params(params))
    for name, t in _flat(state.params).items():
        assert torch.equal(trained[name], t.detach()), name
    jparams, jcfg = jhf.load_hf_t5(export_dir)
    assert jcfg.d_model == 32
    for name, t in _flat(params).items():
        np.testing.assert_array_equal(np.asarray(_flat(jparams)[name]), t.numpy(), err_msg=name)


def _read_export(out_dir):
    with open(os.path.join(out_dir, "config.json")) as f:
        cfg = json.load(f)
    return cfg, thf.load_safetensors(os.path.join(out_dir, "model.safetensors"))


@pytest.mark.parametrize("fused, encoder_only, tied", [(False, False, False), (True, False, False),
                                                       (True, True, False), (False, False, True)])
def test_export_matches_jax_tensor_by_tensor(tmp_path, fused, encoder_only, tied):
    """The same parameters through both packages' ``export_hf_t5``: the same
    ``config.json`` and the same tensors, name by name, bit for bit."""
    jcfg = jt5.T5Config(**TINY, tie_word_embeddings=tied)
    params = jt5.init_params(jax.random.PRNGKey(3), jcfg)
    if fused:
        params = jt5.fuse_mlp_params(params)
    params = jax.tree.map(np.asarray, params)
    jhf.export_hf_t5(params, jcfg, str(tmp_path / "jax"), encoder_only=encoder_only)
    thf.export_hf_t5(params_from_jax(params), tt5.T5Config(**TINY, tie_word_embeddings=tied),
                     str(tmp_path / "port"), encoder_only=encoder_only)
    want_cfg, want = _read_export(tmp_path / "jax")
    got_cfg, got = _read_export(tmp_path / "port")
    assert got_cfg == want_cfg
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == torch.float32 and torch.equal(got[name], t), name


def test_safetensors_reader_and_writer_match_the_package(tmp_path):
    """The port's reader on a file the package wrote, and the package's on a
    file the port wrote (every dtype an export or a HF checkpoint uses)."""
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as load_torch

    rng = np.random.default_rng(0)
    arrays = {"a.weight": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.integers(-9, 9, (7,)).astype(np.int64),
              "c": rng.normal(size=(2, 3)).astype(np.float16),
              "empty": np.zeros((0, 4), np.float32), "scalar": np.array(2.5, np.float32)}
    save_file(arrays, str(tmp_path / "np.safetensors"))
    got = thf.load_safetensors(str(tmp_path / "np.safetensors"))
    assert set(got) == set(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(got[name].numpy(), a, err_msg=name)

    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tensors["bf16"] = torch.randn(4, 3, generator=torch.Generator().manual_seed(1)).bfloat16()
    thf.save_safetensors(tensors, str(tmp_path / "port.safetensors"), {"format": "pt"})
    back = load_torch(str(tmp_path / "port.safetensors"))
    assert set(back) == set(tensors)
    for name, t in tensors.items():
        assert torch.equal(back[name], t), name
    assert set(load_file(str(tmp_path / "port.safetensors"))) == set(arrays) | {"bf16"}


def test_export_and_load_without_the_safetensors_package(tmp_path, monkeypatch):
    """With ``safetensors`` unimportable, ``export_hf_t5`` writes and
    ``load_hf_t5`` reads ``model.safetensors`` back bit for bit."""
    for name in [m for m in sys.modules if m == "safetensors" or m.startswith("safetensors.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    cfg = tt5.T5Config(**TINY)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(4))
    thf.export_hf_t5(params, cfg, str(tmp_path / "out"))
    loaded, loaded_cfg = thf.load_hf_t5(str(tmp_path / "out"))
    assert loaded_cfg == cfg
    for name, t in _flat(params).items():
        assert torch.equal(_flat(loaded)[name], t), name
