"""PyTorch port, T5: encode and incremental decode against the JAX package
with the same (bridged) weights, in the split and fused MLP layouts, and
HF checkpoint import against the JAX importer. fp32 on the CPU, tol 1e-4."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.models import load_hf_t5 as jax_load_hf_t5
from reprover_tpu.models import t5 as jt5
from reprover_tpu_torch.models import hf_import as thf
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax

JCFG = jt5.T5Config(
    d_model=64, d_kv=16, d_ff=128, num_heads=4, num_encoder_layers=3, num_decoder_layers=2
)
TCFG = tt5.T5Config(
    **{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(tt5.T5Config)
       if f.name != "compute_dtype"}
)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jparams():
    return jt5.init_params(jax.random.PRNGKey(1), JCFG)


def _batch(L, B=3, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 259, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L * 2 // 3 :] = 0
    mask[B - 1, 5:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _both(jparams, fused):
    jp = jt5.fuse_mlp_params(jparams) if fused else jparams
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("fused", [False, True])
def test_encode_matches_jax(jparams, fused):
    """Naive JAX encode at a ragged length (valid rows), and the Pallas
    path (interpret mode) at L=128 (all rows: both give a padding query 0
    attention output)."""
    jp, tp = _both(jparams, fused)
    ids, mask = _batch(37)
    naive = np.asarray(jt5.encode(jp, JCFG, jnp.asarray(ids), jnp.asarray(mask)))
    ours = tt5.encode(tp, TCFG, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(ours[valid], naive[valid], **TOL)

    ids, mask = _batch(128, seed=1)
    flash_cfg = dataclasses.replace(JCFG, flash_encoder=True)
    flash = np.asarray(jt5.encode(jp, flash_cfg, jnp.asarray(ids), jnp.asarray(mask)))
    ours = tt5.encode(tp, TCFG, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(ours, flash, **TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_decode_steps_match_jax(jparams, fused):
    """init_decode_state + 6 decode_step logits, one beam per row (the JAX
    package's row layout), same tokens fed to both."""
    jp, tp = _both(jparams, fused)
    ids, mask = _batch(23, seed=2)
    enc_j = jt5.encode(jp, JCFG, jnp.asarray(ids), jnp.asarray(mask))
    enc_t = tt5.encode(tp, TCFG, torch.from_numpy(ids), torch.from_numpy(mask))
    sj = jt5.init_decode_state(jp, JCFG, enc_j, jnp.asarray(mask), 8)
    st = tt5.init_decode_state(tp, TCFG, enc_t, torch.from_numpy(mask), 8)
    tokens = np.random.default_rng(3).integers(3, 259, (6, ids.shape[0])).astype(np.int32)
    tokens[0] = JCFG.decoder_start_token_id
    for step in range(6):
        lj, sj = jt5.decode_step(jp, JCFG, sj, jnp.asarray(tokens[step]))
        lt, st = tt5.decode_step(tp, TCFG, st, torch.from_numpy(tokens[step]).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert st.step == 6


def test_grouped_beams_read_cross_cache_per_source(jparams):
    """num_beams=K decode over B sources equals one-beam decode over the
    K-fold tiled rows (the JAX package's layout)."""
    _, tp = _both(jparams, True)
    ids, mask = _batch(19, B=2, seed=4)
    ids_t, mask_t = torch.from_numpy(ids), torch.from_numpy(mask)
    enc = tt5.encode(tp, TCFG, ids_t, mask_t)
    K = 3
    grouped = tt5.init_decode_state(tp, TCFG, enc, mask_t, 5, num_beams=K)
    tiled = tt5.init_decode_state(
        tp, TCFG, enc.repeat_interleave(K, 0), mask_t.repeat_interleave(K, 0), 5
    )
    tok = torch.tensor([0, 7, 9, 0, 4, 4])
    for _ in range(3):
        lg, grouped = tt5.decode_step(tp, TCFG, grouped, tok)
        lt, tiled = tt5.decode_step(tp, TCFG, tiled, tok)
        np.testing.assert_allclose(lg.numpy(), lt.numpy(), atol=1e-5, rtol=1e-5)
        tok = lg.argmax(-1)


def test_bridge_rejects_foreign_tree():
    with pytest.raises(KeyError):
        params_from_jax({"encoder": {}, "optimizer": {}})


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    from transformers import T5Config as HFT5Config
    from transformers import T5EncoderModel, T5ForConditionalGeneration

    torch.manual_seed(0)
    cfg = HFT5Config(
        vocab_size=384, d_model=64, d_kv=16, d_ff=128, num_layers=3, num_decoder_layers=2,
        num_heads=4, feed_forward_proj="gated-gelu", tie_word_embeddings=False,
        decoder_start_token_id=0,
    )
    model = T5ForConditionalGeneration(cfg).eval()
    root = tmp_path_factory.mktemp("hf_t5_torch")
    full, enc_only, bin_dir = root / "full", root / "encoder", root / "bin"
    model.save_pretrained(full, safe_serialization=True)
    model.save_pretrained(bin_dir, safe_serialization=False)
    enc = T5EncoderModel(cfg).eval()
    enc.load_state_dict(model.state_dict(), strict=False)
    enc.save_pretrained(enc_only, safe_serialization=True)
    return str(full), str(enc_only), str(bin_dir)


def _assert_same_tree(tp, jp):
    flat_t = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat_t[prefix + (k,)] = v

    walk(tp, ())
    jflat = {tuple(p.key for p in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert set(flat_t) == set(jflat)
    for key, leaf in jflat.items():
        np.testing.assert_array_equal(flat_t[key].numpy(), np.asarray(leaf), err_msg=str(key))


def test_hf_import_equals_jax_import(hf_dirs):
    """Full, encoder-only and pytorch_model.bin checkpoints: the port's
    importer gives exactly the JAX importer's tree, bridged."""
    full, enc_only, bin_dir = hf_dirs
    for path, encoder_only in ((full, False), (full, True), (enc_only, True), (bin_dir, False)):
        tp, tcfg = thf.load_hf_t5(path, encoder_only=encoder_only)
        jp, jcfg = jax_load_hf_t5(path, encoder_only=encoder_only)
        _assert_same_tree(tp, jp)
        assert tcfg.num_encoder_layers == jcfg.num_encoder_layers == 3
        assert tcfg.tie_word_embeddings is False
        _assert_same_tree(params_from_jax(jax.tree.map(np.asarray, jp)), jp)


def test_hf_encoder_matches_transformers(hf_dirs):
    import transformers

    full, _, _ = hf_dirs
    tp, tcfg = thf.load_hf_t5(full)
    ids, mask = _batch(17, seed=6)
    ours = tt5.encode(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    model = transformers.T5ForConditionalGeneration.from_pretrained(full).eval()
    with torch.no_grad():
        theirs = model.encoder(
            input_ids=torch.from_numpy(ids).long(), attention_mask=torch.from_numpy(mask).long()
        ).last_hidden_state.numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(ours[valid], theirs[valid], atol=1e-4, rtol=1e-4)


def test_safetensors_without_package_says_so(hf_dirs, monkeypatch, tmp_path):
    """A model.safetensors with no safetensors package (the card's machine
    has none): the port reads it with its own reader, and the parameters
    equal those loaded through the package. (It used to raise an
    ImportError naming the package.)"""
    import shutil
    import sys

    from safetensors.torch import load_file

    _, enc_only, _ = hf_dirs
    d = tmp_path / "ckpt"
    shutil.copytree(enc_only, d)
    cfg = thf.load_hf_t5(str(d), encoder_only=True)[1]
    want = thf.params_from_torch_state_dict(load_file(str(d / "model.safetensors")), cfg,
                                            encoder_only=True)
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    got, _ = thf.load_hf_t5(str(d), encoder_only=True)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}/{k}").items()}
        return {prefix: tree}

    assert flat(got).keys() == flat(want).keys()
    for name, t in flat(want).items():
        assert torch.equal(flat(got)[name], t), name


def test_decoder_only_checkpoint_is_refused(tmp_path):
    """A decoder-only checkpoint is no longer refused: it is told apart from
    a T5 one and routed to the causal generator."""
    from reprover_tpu_torch.models.hf_import_causal import is_causal_lm_checkpoint

    causal, t5 = tmp_path / "causal", tmp_path / "t5"
    for d, cfg in ((causal, {"architectures": ["LlamaForCausalLM"], "model_type": "llama"}),
                   (t5, {"architectures": ["T5ForConditionalGeneration"], "model_type": "t5"})):
        d.mkdir()
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cfg, f)
    assert is_causal_lm_checkpoint(str(causal))
    assert not is_causal_lm_checkpoint(str(t5))
