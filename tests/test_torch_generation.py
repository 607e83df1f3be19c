"""PyTorch port, tactic-generator training on the CPU against the JAX package
at the tiny geometry, fp32: teacher-forced ``decode`` logits (the JAX
package with ``flash_decoder`` off, its naive path, and on, its Pallas
kernels in interpret mode), ``decode`` with a ``decoder_mask``,
``forward_loss`` and every parameter gradient against ``jax.grad``, the last
teacher-forced logit against ``decode_step``, and ``generation.main fit`` /
``validate --ckpt_dir`` on the toy dataset, whose first loss equals the JAX
package's for the same weights and batch. Tolerances: logits and losses
1e-4, gradients 1e-4 of max(1, max|ref|)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.generation.datamodule import GeneratorDataModule as JaxGeneratorDataModule
from reprover_tpu.models import t5 as jt5
from reprover_tpu.training import tasks as jtasks
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.ops import flash_attention as tfa
from reprover_tpu_torch.training.tasks import generation_loss
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
            num_decoder_layers=2)
B, S, T = 2, 256, 128  # the JAX flash decoder takes multiples of 128 only
TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jcfg = jt5.T5Config(**TINY)
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _batch(seed, t=T):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 259, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, S // 3 :] = 0  # a padded source
    labels = rng.integers(3, 259, (B, t)).astype(np.int32)
    labels[0, t // 2 :] = -100  # a padded target
    return ids, mask, labels


def _flat_grads(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}


def test_shift_right_matches_jax(weights):
    jcfg, _, _ = weights
    labels = _batch(0)[2]
    want = np.asarray(jt5.shift_right(jnp.asarray(labels), jcfg))
    got = tt5.shift_right(torch.from_numpy(labels), tt5.T5Config(**TINY)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flash_decoder", [False, True])
def test_decode_logits_match_jax(weights, flash_decoder):
    """The port's teacher-forced decode (plain causal and cross attention on
    the CPU) against JAX's naive path and its Pallas kernels."""
    jcfg, jparams, tparams = weights
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(B, S, TINY["d_model"])).astype(np.float32)
    _, mask, labels = _batch(1)
    dec_in = np.array(jt5.shift_right(jnp.asarray(labels), jcfg))
    want = jt5.decode(jparams, dataclasses.replace(jcfg, flash_decoder=flash_decoder),
                      jnp.asarray(enc), jnp.asarray(mask), jnp.asarray(dec_in))
    before = dict(tfa.KERNEL_LAUNCHES)
    got = tt5.decode(tparams, tt5.T5Config(**TINY), torch.from_numpy(enc),
                     torch.from_numpy(mask), torch.from_numpy(dec_in).long())
    assert tfa.KERNEL_LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_decode_with_decoder_mask_matches_jax(weights):
    """A ``decoder_mask`` takes the naive path on both sides."""
    jcfg, jparams, tparams = weights
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(B, S, TINY["d_model"])).astype(np.float32)
    _, mask, labels = _batch(2)
    dec_in = np.array(jt5.shift_right(jnp.asarray(labels), jcfg))
    dec_mask = (labels != -100).astype(np.int32)
    dec_mask[:, 0] = 1
    want = jt5.decode(jparams, jcfg, jnp.asarray(enc), jnp.asarray(mask), jnp.asarray(dec_in),
                      jnp.asarray(dec_mask))
    got = tt5.decode(tparams, tt5.T5Config(**TINY), torch.from_numpy(enc),
                     torch.from_numpy(mask), torch.from_numpy(dec_in).long(),
                     torch.from_numpy(dec_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("flash_decoder, remat", [(False, False), (True, True)])
def test_forward_loss_and_gradients_match_jax(weights, flash_decoder, remat):
    """``forward_loss`` and the gradient of every parameter against
    ``jax.grad`` of the JAX package's ``forward_loss``."""
    jcfg, jparams, tparams = weights
    ids, mask, labels = _batch(3)
    jc = dataclasses.replace(jcfg, flash_decoder=flash_decoder, remat=remat)
    args = (jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels))
    want_loss, want = jax.value_and_grad(lambda p: jt5.forward_loss(p, jc, *args))(jparams)

    params = {k: v for k, v in tparams.items()}
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), params)
    loss = tt5.forward_loss(params, tt5.T5Config(**TINY, remat=remat),
                            *(torch.from_numpy(x).long() for x in (ids, mask, labels)))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= TOL
    want = _flat_grads(want)
    got = _flat_grads(jax.tree.map(lambda t: t.grad.numpy(), params))
    assert got.keys() == want.keys()
    for name in want:
        scale = max(1.0, np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], atol=TOL * scale, rtol=0, err_msg=name)


def test_last_teacher_forced_logit_equals_decode_step(weights):
    """Position t of the teacher-forced logits equals the incremental
    decoder's logits after it has been fed the first t + 1 tokens."""
    _, _, tparams = weights
    cfg = tt5.T5Config(**TINY)
    ids, mask, labels = _batch(4, t=24)
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    dec_in = tt5.shift_right(torch.from_numpy(labels).long(), cfg)
    with torch.no_grad():
        enc = tt5.encode(tparams, cfg, ids, mask)
        full = tt5.decode(tparams, cfg, enc, mask, dec_in)
        state = tt5.init_decode_state(tparams, cfg, enc, mask, dec_in.shape[1])
        for i in range(dec_in.shape[1]):
            step_logits, state = tt5.decode_step(tparams, cfg, state, dec_in[:, i])
    np.testing.assert_allclose(step_logits.numpy(), full[:, -1].numpy(), atol=TOL, rtol=TOL)


def _cli_args(data_dir, tmp_path):
    return [
        "--device", "cpu",
        "--model.tiny", "true",
        "--model.num_beams", "2",
        "--data.data_path", data_dir,
        "--data.batch_size", "2",
        "--data.eval_batch_size", "2",
        "--data.max_inp_seq_len", "256",
        "--data.max_oup_seq_len", "64",
        "--trainer.max_steps", "2",
        "--trainer.val_interval", "2",
        "--trainer.log_interval", "1",
        "--trainer.monitor", "loss_val",
        "--trainer.monitor_mode", "min",
        "--trainer.patience", "99",
        "--trainer.ckpt_dir", str(tmp_path / "ckpts"),
        "--log_dir", str(tmp_path / "logs"),
    ]


def test_generation_cli_fit_validate_matches_jax(toy_dataset_dir, tmp_path):
    """``fit`` trains, validates and checkpoints; its first loss equals the
    JAX package's ``generation_loss`` on the same first batch and weights;
    ``validate --ckpt_dir`` restores the trained parameters bit for bit."""
    from reprover_tpu_torch.generation.main import GenerationConfig, _build, main
    from reprover_tpu_torch.utils.config import parse_config

    args = _cli_args(toy_dataset_dir, tmp_path)
    _, cfg = parse_config(GenerationConfig, args)
    dm, model, _ = _build(cfg)  # the weights fit starts from (seeded)
    start = {k: v.detach().numpy().copy() for k, v in _flat_torch(model.params).items()}
    dm.setup("fit")
    batch = next(iter(dm.train_dataloader()))

    state = main(["fit"] + args)
    assert state.step == 2
    with open(tmp_path / "logs" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert any("top2_acc_val" in r for r in recs)

    jdm = JaxGeneratorDataModule(toy_dataset_dir, 2, 2, 256, 64, 0.5, seed=cfg.seed)
    jdm.setup("fit")
    jbatch = next(iter(jdm.train_dataloader()))
    for key in ("state_ids", "state_mask", "tactic_ids"):
        np.testing.assert_array_equal(batch[key], jbatch[key])
    jparams = jax.tree.map(jnp.asarray, _unflatten(start))
    jcfg = jt5.T5Config(**dict(TINY, num_decoder_layers=1), remat=True)
    want = jtasks.generation_loss(jparams, jcfg, {k: jnp.asarray(jbatch[k]) for k in
                                                  ("state_ids", "state_mask", "tactic_ids")})
    assert abs(losses[0] - float(want)) <= TOL

    _, restored = main(["validate"] + args + ["--ckpt_dir", str(tmp_path / "ckpts")])
    trained = _flat_torch(state.params)
    for name, t in _flat_torch(restored.params).items():
        assert torch.equal(t.detach(), trained[name].detach()), name


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat_torch(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _unflatten(flat):
    out = {}
    for path, value in flat.items():
        node = out
        keys = path.strip("/").split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return out


def test_generation_loss_batch_keys(weights):
    """``generation_loss`` reads state ids/mask and -100-padded tactic ids."""
    jcfg, jparams, tparams = weights
    ids, mask, labels = _batch(5)
    batch = {"state_ids": ids, "state_mask": mask, "tactic_ids": labels}
    want = jtasks.generation_loss(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got = generation_loss(tparams, tt5.T5Config(**TINY),
                          {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert abs(got.item() - float(want)) <= TOL
