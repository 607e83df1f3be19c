"""PyTorch port, rematerialization policies and host-resident Adam moments
on the CPU: ``forward_loss`` and ``retrieval_loss`` and their parameter
gradients under no remat and the ``full``, ``lite`` and ``offload`` policies
against the JAX package's under the same policy (fp32, weights bridged with
``params_from_jax``), also at full byt5-small width; the plain attention's
forward calls per step under each policy; the optimizer with its moments in
host memory against the on-device one and optax; and the CLIs running each
new option."""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.models import t5 as jt5
from reprover_tpu.training import optim as joptim
from reprover_tpu.training import tasks as jtasks
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.ops import flash_attention as tfa
from reprover_tpu_torch.training import optim as toptim
from reprover_tpu_torch.training import tasks as ttasks
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2, num_decoder_layers=1)
# Full byt5-small width (d_model 1472, 6 x 64 heads, d_ff 3584), cut to 2
# encoder layers and 1 decoder layer.
BYT5_WIDTH = dict(num_encoder_layers=2, num_decoder_layers=1)
POLICIES = [None, "full", "lite", "offload"]
TOL = 1e-5  # fp32: relative to each leaf's max|ref|


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _cfgs(policy, **geometry):
    remat = dict(remat=policy is not None, remat_policy=policy or "full")
    return jt5.T5Config(**geometry, **remat), tt5.T5Config(**geometry, **remat)


def _seq2seq_batch(b, src, tgt, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 259, (b, src)).astype(np.int32)
    mask = np.ones((b, src), np.int32)
    mask[0, src * 3 // 4:] = 0
    labels = rng.integers(3, 259, (b, tgt)).astype(np.int32)
    labels[1, tgt // 2:] = -100
    return dict(state_ids=ids * mask, state_mask=mask, tactic_ids=labels)


def _retrieval_batch(seed, b=3, n=2, length=32):
    rng = np.random.default_rng(seed)

    def ids_mask(rows):
        ids = rng.integers(3, 259, (rows, length)).astype(np.int32)
        mask = np.ones((rows, length), np.int32)
        for r in range(rows):
            mask[r, rng.integers(length // 2, length + 1):] = 0
        return ids * mask, mask

    ctx_ids, ctx_mask = ids_mask(b)
    prem_ids, prem_mask = ids_mask(b * (1 + n))
    label = np.zeros((b, b * (1 + n)), np.float32)
    label[np.arange(b), np.arange(b)] = 1.0
    return dict(context_ids=ctx_ids, context_mask=ctx_mask, premise_ids=prem_ids,
                premise_mask=prem_mask, label=label)


def _compare(loss_name, policy, geometry, batch, params):
    jcfg, tcfg = _cfgs(policy, **geometry)
    jloss, jgrads = jax.value_and_grad(getattr(jtasks, loss_name))(
        jax.tree.map(jnp.asarray, params), jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    state = ttasks.init_train_state(params_from_jax(params), lr=1e-3, warmup_steps=0)
    loss = getattr(ttasks, loss_name)(state.params, tcfg, ttasks.numeric_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    want = _flat(jgrads)
    got = {k: v.grad for k, v in _flat(state.params).items()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL * np.abs(w).max(),
                                   err_msg=f"{policy} {name}")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("loss_name", ["generation_loss", "retrieval_loss"])
def test_policy_matches_jax(loss_name, policy):
    """The loss and every parameter gradient under each policy against the
    JAX package's under the same policy (its naive attention path, which
    tags the same names): within 1e-5 of each leaf's max|ref|."""
    params = jax.tree.map(np.asarray, jt5.init_params(jax.random.PRNGKey(1),
                                                      jt5.T5Config(**TINY)))
    if loss_name == "generation_loss":
        batch = _seq2seq_batch(2, 48, 16, seed=2)
    else:
        params = {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}
        batch = _retrieval_batch(seed=3)
    _compare(loss_name, policy, TINY, batch, params)


def test_lite_matches_jax_at_byt5_width():
    """``forward_loss`` and its gradients under ``lite`` at full byt5-small
    width (d_model 1472, 6 x 64 heads, d_ff 3584), 2 encoder and 1 decoder
    layers, [2, 64] -> [2, 16], against the JAX package's ``lite``."""
    geometry = dict(BYT5_WIDTH)
    params = jax.tree.map(np.asarray, jt5.init_params(jax.random.PRNGKey(5),
                                                      jt5.T5Config(**geometry)))
    _compare("generation_loss", "lite", geometry, _seq2seq_batch(2, 64, 16, seed=6), params)


def _counting(monkeypatch, names):
    counts = {name: 0 for name in names}
    for name in names:
        fn = getattr(tfa, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tfa, name, wrapped)
    return counts


@pytest.mark.parametrize("policy, per_layer", [(None, 1), ("full", 2), ("lite", 1),
                                               ("offload", 1)])
def test_plain_forward_calls_per_layer(monkeypatch, policy, per_layer):
    """One step of ``forward_loss``: each attention's plain forward (the CPU
    implementation of the forward operator) runs once per layer under
    ``lite`` and ``offload``, as without remat, and twice under ``full``
    (its recompute); the backward is the plain backward steps, never the
    forward. The same on the long route (kernel 2's plain version)."""
    counts = _counting(monkeypatch, ["encoder_attention_reference", "causal_attention_reference",
                                     "cross_attention_reference", "long_attention_reference"])
    _, tcfg = _cfgs(policy, **TINY)
    batch = ttasks.numeric_batch(_seq2seq_batch(2, 40, 12, seed=4))
    params = tt5.init_params(tcfg, torch.Generator().manual_seed(0))
    state = ttasks.init_train_state(params, lr=1e-3, warmup_steps=0)
    ttasks.generation_loss(state.params, tcfg, batch).backward()
    enc, dec = TINY["num_encoder_layers"], TINY["num_decoder_layers"]
    assert counts == {"encoder_attention_reference": per_layer * enc,
                      "causal_attention_reference": per_layer * dec,
                      "cross_attention_reference": per_layer * dec,
                      "long_attention_reference": 0}

    for name in counts:
        counts[name] = 0
    long_cfg = dataclasses.replace(tcfg, flash_block_kv=64)
    state.optimizer.zero_grad()
    ttasks.generation_loss(state.params, long_cfg, batch).backward()
    assert counts["long_attention_reference"] == per_layer * enc
    assert counts["encoder_attention_reference"] == 0


def test_unknown_policy_raises():
    _, tcfg = _cfgs("lite", **TINY)
    with pytest.raises(ValueError, match="remat_policy"):
        tt5.check_remat_policy(dataclasses.replace(tcfg, remat_policy="selective"))


# ------------------------------------------------------------------ #
# Adam moments in host memory
# ------------------------------------------------------------------ #


def _tiny_retrieval_state(offload):
    params = jax.tree.map(np.asarray, jt5.init_params(jax.random.PRNGKey(0),
                                                      jt5.T5Config(**TINY)))
    params = {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}
    state = ttasks.init_train_state(params_from_jax(params), lr=1e-3, warmup_steps=2)
    if offload:
        state = ttasks.offload_opt_state(state)
    return params, state


def test_offload_opt_steps_equal_on_device_and_jax():
    """Three steps of ``make_train_step(offload_opt=True)`` on an offloaded
    state: the parameters are bit-equal to the on-device optimizer's and
    within 1e-6 of the JAX package's step. (The JAX package's own offload
    step streams between memory kinds, which its CPU backend cannot run, so
    its on-device step, which its offload test holds it to, stands in.)"""
    tcfg = tt5.T5Config(**TINY)
    batches = [ttasks.numeric_batch(_retrieval_batch(seed=s)) for s in range(3)]
    params, dev = _tiny_retrieval_state(offload=False)
    _, host = _tiny_retrieval_state(offload=True)
    dev_step = ttasks.make_train_step(ttasks.retrieval_loss, tcfg)
    host_step = ttasks.make_train_step(ttasks.retrieval_loss, tcfg, offload_opt=True)
    for batch in batches:
        dev, loss_dev = dev_step(dev, batch)
        host, loss_host = host_step(host, batch)
        assert torch.equal(loss_dev, loss_host)
    for name, t in _flat(dev.params).items():
        assert torch.equal(_flat(host.params)[name], t), name
    assert host.optimizer.offload_moments and not dev.optimizer.offload_moments

    tx = joptim.make_optimizer(1e-3, 2)
    jstate = jtasks.init_train_state(jax.tree.map(jnp.asarray, params), tx)
    jstep = jtasks.make_train_step(jtasks.retrieval_loss, jt5.T5Config(**TINY), tx)
    for batch in batches:
        jstate, _ = jstep(jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    want = _flat(jax.tree.map(np.asarray, jstate.params))
    for name, t in _flat(host.params).items():
        np.testing.assert_allclose(t.detach().numpy(), want[name], rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_offload_opt_state_dict_round_trips():
    """``state_dict`` of an offloaded optimizer loads into an on-device one
    and back, and the next steps stay bit-equal; a step that asks for
    offloaded moments on an on-device state raises."""
    tcfg = tt5.T5Config(**TINY)
    batch = ttasks.numeric_batch(_retrieval_batch(seed=7))
    _, host = _tiny_retrieval_state(offload=True)
    host, _ = ttasks.make_train_step(ttasks.retrieval_loss, tcfg, offload_opt=True)(host, batch)
    saved = host.optimizer.state_dict()
    _, dev = _tiny_retrieval_state(offload=False)
    for t, s in zip(ttasks.param_leaves(dev.params), ttasks.param_leaves(host.params)):
        t.data.copy_(s.detach())
    # As from a checkpoint on disk: each load gets its own tensors (a state
    # dict holds the optimizer's own, which a CPU load would share).
    dev.optimizer.load_state_dict(copy.deepcopy(saved))
    host.optimizer.load_state_dict(copy.deepcopy(saved))
    for state, offload in ((dev, False), (host, True)):
        ttasks.make_train_step(ttasks.retrieval_loss, tcfg, offload_opt=offload)(state, batch)
    for t, s in zip(ttasks.param_leaves(dev.params), ttasks.param_leaves(host.params)):
        assert torch.equal(t, s)
    moments = {key for s in host.optimizer.adamw.state.values() for key in s}
    assert set(toptim.MOMENTS) <= moments
    with pytest.raises(ValueError, match="offload_opt"):
        ttasks.make_train_step(ttasks.retrieval_loss, tcfg, offload_opt=True)(dev, batch)
    with pytest.raises(NotImplementedError):
        ttasks.offload_opt_state(dev, mesh=object())


def test_eval_step_records_no_graph():
    tcfg = tt5.T5Config(**TINY)
    _, state = _tiny_retrieval_state(offload=False)
    batch = ttasks.numeric_batch(_retrieval_batch(seed=8))
    loss = ttasks.make_eval_step(ttasks.retrieval_loss, tcfg)(state.params, batch)
    assert loss.grad_fn is None and not loss.requires_grad
    assert torch.equal(loss, ttasks.retrieval_loss(state.params, tcfg, batch).detach())
    with pytest.raises(NotImplementedError):
        ttasks.make_eval_step(ttasks.retrieval_loss, tcfg, mesh=object())


# ------------------------------------------------------------------ #
# The CLIs with the new options
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("cli, argv_extra", [
    ("retrieval", ["--model.remat_policy", "lite"]),
    ("retrieval", ["--model.remat_policy", "offload"]),
    ("retrieval", ["--model.offload_optimizer", "true"]),
    ("generation", ["--model.remat_policy", "lite", "--model.offload_optimizer", "true"]),
])
def test_cli_runs_option(toy_corpus_path, toy_dataset_dir, tmp_path, cli, argv_extra):
    """Each option that used to raise runs 2 steps on the CPU with finite
    losses (these replace the three rejection cases that
    ``test_cli_rejects_unported_options`` had for them)."""
    common = ["--device", "cpu", "--model.tiny", "true", "--data.data_path", toy_dataset_dir,
              "--data.batch_size", "2", "--data.eval_batch_size", "2",
              "--trainer.max_steps", "2", "--trainer.val_interval", "2",
              "--trainer.log_interval", "1", "--trainer.patience", "99",
              "--log_dir", str(tmp_path / "logs")]
    if cli == "retrieval":
        from reprover_tpu_torch.retrieval.main import main

        argv = common + ["--model.num_retrieved", "4", "--data.corpus_path", toy_corpus_path,
                         "--data.max_seq_len", "256", "--data.num_negatives", "2",
                         "--data.num_in_file_negatives", "1"]
    else:
        from reprover_tpu_torch.generation.main import main

        argv = common + ["--model.num_beams", "1", "--data.max_inp_seq_len", "256",
                         "--data.max_oup_seq_len", "64", "--trainer.monitor", "loss_val",
                         "--trainer.monitor_mode", "min"]
    state = main(["fit"] + argv + argv_extra)
    assert state.step == 2
    assert state.optimizer.offload_moments == ("true" in argv_extra)
    with open(os.path.join(tmp_path, "logs", "metrics.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
