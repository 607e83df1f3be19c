"""PyTorch port: decoder-only fine-tuning (``models/causal_lm.py``'s
``causal_lm_loss`` and ``forward_logits(flash_attention=True)``,
``ops/flash_attention.scaled_causal_flash_attention``,
``generation/{causal_datamodule,preprocess,validate}.py``) against the JAX
package on the CPU.

The same numpy weights (JAX init, carried over by the bridge) and inputs, a
tiny config with grouped-query attention (4 heads, 2 KV heads, head width
32), fp32. The JAX side runs its Pallas kernels in interpret mode. Logits
on real rows within 2e-4, loss and every gradient within 5e-4 (the JAX
package's own flash-vs-naive tolerances): the two compute the same products
in another order. A left-padded query row has no valid key; there the
port's attention gives 0 and the Pallas kernel other values, which reach
only that row's own logits, whose labels are -100 in every batch here, so
logits are compared on real rows and the loss and gradients in full."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reprover_tpu.models import causal_lm as jcl
from reprover_tpu.ops import flash_attention as jfa
from reprover_tpu_torch.models import causal_lm as tcl
from reprover_tpu_torch.models.bridge import causal_params_from_jax
from reprover_tpu_torch.ops import flash_attention as tfa
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

GEO = dict(vocab_size=64, d_model=128, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=128)


@pytest.fixture(scope="module")
def weights():
    jparams = jcl.init_params(jax.random.PRNGKey(3), jcl.CausalLMConfig(**GEO))
    return jparams, jax.tree.map(np.asarray, jparams)


def _padded_batch(t: int, seed: int):
    """Three rows: full, right-padded, left-padded. Labels are the ids where
    a token and the one before it are real (-100 elsewhere), so no label is
    predicted from a padded position."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, GEO["vocab_size"], (3, t)).astype(np.int32)
    mask = np.ones((3, t), np.int32)
    mask[1, t - 37:] = 0
    mask[2, :29] = 0
    ids[mask == 0] = 0
    prev_real = np.concatenate([np.zeros((3, 1), np.int32), mask[:, :-1]], axis=1)
    labels = np.where((mask == 1) & (prev_real == 1), ids, -100).astype(np.int32)
    return ids, mask, labels


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("t", [128, 256])
@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_loss_logits_and_grads_match_jax(weights, flash, t):
    jparams, nparams = weights
    jcfg = jcl.CausalLMConfig(**GEO, flash_attention=flash)
    cfg = tcl.CausalLMConfig(**GEO, flash_attention=flash)
    ids, mask, labels = _padded_batch(t, seed=t)
    jargs = (jnp.asarray(ids), jnp.asarray(mask))
    targs = (torch.from_numpy(ids), torch.from_numpy(mask))

    want = np.asarray(jcl.forward_logits(jparams, jcfg, *jargs))
    params = causal_params_from_jax(nparams)
    with torch.no_grad():
        got = tcl.forward_logits(params, cfg, *targs).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=2e-4, rtol=2e-4)

    jloss, jgrads = jax.value_and_grad(
        lambda p: jcl.causal_lm_loss(p, jcfg, *jargs, jnp.asarray(labels)))(jparams)
    for leaf in _flat(params).values():
        leaf.requires_grad_(True)
    loss = tcl.causal_lm_loss(params, cfg, *targs, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=5e-4, rtol=5e-4)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    for name, leaf in _flat(params).items():
        np.testing.assert_allclose(leaf.grad.numpy(), jflat[name], atol=5e-4, rtol=5e-4,
                                   err_msg=name)


def test_flash_and_plain_agree_in_the_port(weights):
    """On the port alone the two attentions give the same loss and gradients
    (the JAX test's flash-vs-naive check), at T = 256."""
    _, nparams = weights
    ids, mask, labels = (torch.from_numpy(x) for x in _padded_batch(256, seed=5))
    out = {}
    for flash in (False, True):
        params = causal_params_from_jax(nparams)
        for leaf in _flat(params).values():
            leaf.requires_grad_(True)
        loss = tcl.causal_lm_loss(params, tcl.CausalLMConfig(**GEO, flash_attention=flash), ids,
                                  mask, labels)
        loss.backward()
        out[flash] = (loss.item(), {k: v.grad for k, v in _flat(params).items()})
    assert abs(out[True][0] - out[False][0]) <= 5e-4
    for name, g in out[True][1].items():
        torch.testing.assert_close(g, out[False][1][name], atol=5e-4, rtol=5e-4)


def test_flash_needs_a_multiple_of_128(weights, monkeypatch):
    """At T % 128 != 0 ``flash_attention=True`` takes the plain path in both
    packages (the JAX rule): the same logits as JAX's, and the fused
    attention is never called."""
    jparams, nparams = weights
    ids, mask, _ = _padded_batch(100, seed=1)
    want = np.asarray(jcl.forward_logits(jparams, jcl.CausalLMConfig(**GEO, flash_attention=True),
                                         jnp.asarray(ids), jnp.asarray(mask)))

    def refuse(*args, **kwargs):
        raise AssertionError("the fused attention was called at T % 128 != 0")

    monkeypatch.setattr(tcl, "scaled_causal_flash_attention", refuse)
    with torch.no_grad():
        got = tcl.forward_logits(causal_params_from_jax(nparams),
                                 tcl.CausalLMConfig(**GEO, flash_attention=True),
                                 torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=2e-4, rtol=2e-4)


# (B, T, H, d, block_kv, right-pad start of row 1, left padding of row 0)
ATTENTION_CASES = [
    (2, 256, 4, 32, 0, 200, 0),
    (2, 256, 4, 32, 0, 256, 40),
    (2, 384, 4, 8, 128, 300, 0),  # tests/test_flash_attention.py's blockwise geometry
]


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=["right", "left", "blockwise"])
def test_scaled_causal_plain_matches_jax(case):
    """The port's CPU path of ``scaled_causal_flash_attention`` (the plain
    version; with ``block_kv`` the long route's tiled plain versions)
    against the JAX function in interpret mode: outputs on rows with a valid
    key within 2e-5, and the gradients of a loss over those rows within
    5e-5; then the LSE and step-by-step backward plain versions against the
    JAX package's naive softmax and the same gradients."""
    b, t, h, d, block_kv, right, left = case
    rng = np.random.default_rng(43)
    q, k, v, dout = (rng.normal(size=(b, t, h * d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, t), np.int32)
    mask[1, right:] = 0
    mask[0, :left] = 0
    scale = d ** -0.5
    seen = np.cumsum(mask, axis=1) > 0  # rows with at least one valid key
    dout = dout * seen[..., None]

    def jfn(q_, k_, v_):
        return jfa.scaled_causal_flash_attention(q_, k_, v_, jnp.asarray(mask), num_heads=h,
                                                 scale=scale, block_q=128, block_kv=block_kv,
                                                 interpret=True)

    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tfa.scaled_causal_flash_attention(*leaves, torch.from_numpy(mask), h, scale,
                                            block_kv=block_kv)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy()[seen], np.asarray(jout)[seen], atol=2e-5,
                               rtol=1e-5)
    assert not out.detach().numpy()[~seen].any()  # no valid key: 0
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=5e-5, err_msg=name)

    # The kernels' plain versions, on the scaled q.
    qs = tfa.scale_queries(torch.from_numpy(q), scale)
    tk, tv, tmask = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(mask)
    lse = tfa.scaled_causal_attention_lse_reference(qs, tk, tmask, h)
    scores = np.einsum("bqhd,bkhd->bhqk", np.asarray(qs).reshape(b, t, h, d),
                       k.reshape(b, t, h, d))
    ok = (np.arange(t)[None, :] <= np.arange(t)[:, None])[None, None] & (mask[:, None, None,
                                                                                :] == 1)
    want_lse = np.asarray(jax.nn.logsumexp(jnp.where(ok, scores, -jnp.inf), axis=-1))
    rows = np.isfinite(want_lse)
    np.testing.assert_allclose(lse.numpy()[rows], want_lse[rows], atol=1e-5, rtol=1e-5)
    assert np.isinf(lse.numpy()[~rows]).all()
    plain = tfa.scaled_causal_attention_reference(torch.from_numpy(q), tk, tv, tmask, h, scale)
    dq, dk, dv = tfa.scaled_causal_attention_backward_reference(
        qs, tk, tv, tmask, plain, lse, torch.from_numpy(dout), h)
    for name, g, w in zip(("dq", "dk", "dv"), (dq * scale, dk, dv), jgrads):
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=5e-5, err_msg=name)


def _bpe_pair():
    """The same BPE vocabulary trained by both packages' tokenizers."""
    from reprover_tpu.generation.bpe_tokenizer import train_tactic_tokenizer as jtrain
    from reprover_tpu_torch.generation.bpe_tokenizer import train_tactic_tokenizer as ttrain

    texts = []
    with open(os.path.join(os.path.dirname(__file__), "conftest.py")) as f:
        texts.append(f.read())
    texts += ["[GOAL]\nn : Nat\n⊢ n + 0 = n\n[PROOFSTEP]\n", "rw [Nat.add_zero]", "simp"] * 4
    return jtrain(texts, vocab_size=400), ttrain(texts, vocab_size=400)


@pytest.fixture(scope="module")
def causal_dms(toy_dataset_dir, toy_corpus_path):
    from reprover_tpu.generation.causal_datamodule import CausalGeneratorDataModule as JDM
    from reprover_tpu_torch.generation import CausalGeneratorDataModule as TDM

    jtok, ttok = _bpe_pair()
    # A max_seq_len below the longest prompt: left truncation is exercised.
    kw = dict(batch_size=1, eval_batch_size=2, max_seq_len=96, p_drop=0.5,
              corpus_path=toy_corpus_path, bucket_multiple=32, seed=5)
    ours, theirs = TDM(toy_dataset_dir, ttok, **kw), JDM(toy_dataset_dir, jtok, **kw)
    ours.setup(None)
    theirs.setup(None)
    return ours, theirs, ttok, jtok


def test_causal_datamodule_batches_bit_equal(causal_dms):
    ours, theirs, ttok, jtok = causal_dms
    text = "[GOAL]\nx y : Nat\n⊢ x + y = y + x\n[PROOFSTEP]\n"
    assert ttok(text)["input_ids"] == jtok(text)["input_ids"]
    n = 0
    for name in ("train_dataloader", "val_dataloader"):
        for a, b in zip(getattr(ours, name)(), getattr(theirs, name)()):
            assert a.keys() == b.keys()
            for key in ("input_ids", "attention_mask", "labels"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            assert a["state"] == b["state"] and a["tactic"] == b["tactic"]
            n += 1
    assert n >= 4
    assert any((batch["labels"] != -100).sum() > 0 for batch in ours.train_dataloader())


def test_causal_validation_metrics_match_jax(causal_dms):
    from reprover_tpu.generation.causal_generator import CausalTacticGeneratorModel as JGen
    from reprover_tpu.generation.validate import causal_validation_metrics as jmetrics
    from reprover_tpu_torch.generation.causal_generator import CausalTacticGeneratorModel
    from reprover_tpu_torch.generation.validate import causal_validation_metrics

    ours, theirs, ttok, jtok = causal_dms
    vocab = (ttok.vocab_size + 127) // 128 * 128
    geo = dict(GEO, vocab_size=vocab, d_model=64, d_ff=64)
    jcfg = jcl.CausalLMConfig(**geo)
    jparams = jcl.init_params(jax.random.PRNGKey(1), jcfg)
    params = causal_params_from_jax(jax.tree.map(np.asarray, jparams))
    model = CausalTacticGeneratorModel(params, tcl.CausalLMConfig(**geo), ttok,
                                       max_inp_seq_len=96, max_oup_seq_len=6)
    jmodel = JGen(jparams, jcfg, jtok, max_inp_seq_len=96, max_oup_seq_len=6)
    got = causal_validation_metrics(model, ours.val_dataloader(), num_beams=2, limit_batches=2)
    want = jmetrics(jmodel, theirs.val_dataloader(), num_beams=2, limit_batches=2)
    assert got.keys() == want.keys() == {"loss_val", "top1_acc_val", "top2_acc_val"}
    assert abs(got["loss_val"] - want["loss_val"]) <= 1e-4
    assert got["top1_acc_val"] == want["top1_acc_val"]
    assert got["top2_acc_val"] == want["top2_acc_val"]


def test_preprocess_split_writes_the_same_json(toy_dataset_dir, tmp_path):
    from reprover_tpu.generation.preprocess import preprocess_split as jsplit
    from reprover_tpu_torch.generation.preprocess import TEMPLATE, preprocess_split

    src = os.path.join(toy_dataset_dir, "train.json")
    n = preprocess_split(src, str(tmp_path / "ours.json"), seed=3)
    assert n == jsplit(src, str(tmp_path / "theirs.json"), seed=3) > 0
    with open(tmp_path / "ours.json") as f:
        ours = json.load(f)
    with open(tmp_path / "theirs.json") as f:
        assert ours == json.load(f)
    assert all(r["instruction"].startswith("[GOAL]\n") for r in ours)
    from reprover_tpu_torch.generation.causal_generator import GOAL_TEMPLATE

    assert GOAL_TEMPLATE is TEMPLATE


def test_finetune_step_script_on_cpu():
    """The fine-tuning step script at a tiny size on the CPU: one row per
    attention, the same first loss (same weights and batch), falling."""
    from reprover_tpu_torch.benchmarks import causal_finetune_step as cfs

    rows = cfs.main(["--device", "cpu", "--batch", "2", "--seq", "128", "--steps", "3",
                     "--layers", "1", "--ragged"])
    assert [r["flash"] for r in rows] == [False, True]
    for r in rows:
        assert "error" not in r and r["losses"][-1] < r["losses"][0]
    assert abs(rows[0]["losses"][0] - rows[1]["losses"][0]) <= 1e-4 * abs(rows[0]["losses"][0])

