"""PyTorch port, retriever training on the CPU: the retrieval losses and
their parameter gradients against the JAX package (weights bridged with
``params_from_jax``, fp32), the optimizer against optax, the trainer loop
and checkpoints against the JAX loop's semantics, the config depth-2
override, the CLI's fit -> validate -> predict on the toy dataset, and the
port's validation metrics with JAX made unimportable."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from reprover_tpu.models import t5 as jt5
from reprover_tpu.training import optim as joptim
from reprover_tpu.training import tasks as jtasks
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.training import optim as toptim
from reprover_tpu_torch.training import tasks as ttasks
from reprover_tpu_torch.training.loop import Trainer, TrainerConfig
from reprover_tpu_torch.utils.checkpoint import CheckpointManager
from reprover_tpu_torch.utils.config import parse_config
from reprover_tpu_torch.utils.metrics import MetricWriter
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2, num_decoder_layers=1)


def _tiny_params():
    """The JAX package's tiny encoder params (fused MLP), as numpy."""
    cfg = jt5.T5Config(**TINY)
    full = jt5.fuse_mlp_params(jt5.init_params(jax.random.PRNGKey(0), cfg))
    return jax.tree.map(np.asarray, {"shared_embedding": full["shared_embedding"],
                                     "encoder": full["encoder"]})


def _batch(ctx_len, prem_len, b=3, n=2, seed=0):
    rng = np.random.default_rng(seed)

    def ids_mask(rows, length):
        ids = rng.integers(3, 259, (rows, length)).astype(np.int32)
        mask = np.ones((rows, length), np.int32)
        for r in range(rows):
            mask[r, rng.integers(length // 2, length + 1):] = 0
        return ids * mask, mask

    ctx_ids, ctx_mask = ids_mask(b, ctx_len)
    prem_ids, prem_mask = ids_mask(b * (1 + n), prem_len)
    label = np.zeros((b, b * (1 + n)), np.float32)
    label[np.arange(b), np.arange(b)] = 1.0
    label[0, b + 1] = 1.0  # a second positive
    return dict(context_ids=ctx_ids, context_mask=ctx_mask, premise_ids=prem_ids,
                premise_mask=prem_mask, label=label)


def _flat(tree, prefix=""):
    """``{"/a/b": leaf}`` of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("loss_name", ["retrieval_loss", "retrieval_infonce_loss"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("ctx_len, prem_len", [(32, 32), (48, 32)])
def test_loss_and_grads_match_jax(loss_name, remat, ctx_len, prem_len):
    """Loss value and every parameter gradient, fused MLP, remat on and off,
    one encode (equal lengths) and two encodes: rtol 1e-4."""
    params = _tiny_params()
    batch = _batch(ctx_len, prem_len)
    jcfg = jt5.T5Config(**TINY, remat=remat)
    jloss, jgrads = jax.value_and_grad(getattr(jtasks, loss_name))(
        jax.tree.map(jnp.asarray, params), jcfg, {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = tt5.T5Config(**TINY, remat=remat)
    state = ttasks.init_train_state(params_from_jax(params), lr=1e-3, warmup_steps=0)
    loss = getattr(ttasks, loss_name)(state.params, tcfg, ttasks.numeric_batch(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = _flat(jgrads)
    got = {k: v.grad for k, v in _flat(state.params).items()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("steps, warmup, grad_scale, weight_decay", [
    (1, 4, 1.0, 0.0),  # warmup: the first update runs at lr 0
    (3, 2, 1.0, 0.0),
    (3, 0, 50.0, 0.0),  # global norm far above 1: every step clipped
    (3, 2, 50.0, 0.01),
])
def test_optimizer_matches_optax(steps, warmup, grad_scale, weight_decay):
    """clip_by_global_norm(1) -> adamw(constant warmup) against optax, one
    and three steps: params within 1e-6."""
    rng = np.random.default_rng(steps + warmup)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: (grad_scale * rng.normal(size=x.shape)).astype(np.float32),
                          params) for _ in range(steps)]

    tx = joptim.make_optimizer(1e-2, warmup, weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    state = ttasks.init_train_state(params_from_jax_like(params), 1e-2, warmup,
                                    weight_decay=weight_decay)
    leaves = ttasks.param_leaves(state.params)
    for g in grads:
        for t, gv in zip(leaves, ttasks.param_leaves(params_from_jax_like(g))):
            t.grad = gv.clone()
        state.optimizer.step()
    assert state.optimizer.count == steps
    want = _flat(jp)
    for name, t in _flat(state.params).items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[name]), atol=1e-6, rtol=0,
                                   err_msg=name)
    if warmup:
        assert toptim.constant_warmup_schedule(1e-2, warmup)(0) == 0.0


def params_from_jax_like(tree):
    if isinstance(tree, dict):
        return {k: params_from_jax_like(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=torch.float32)


def test_clip_has_no_epsilon():
    g = [torch.tensor([3.0, 4.0])]
    norm = toptim.clip_by_global_norm_(g, 1.0)
    assert norm.item() == 5.0
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) * (1.0 / 5.0))
    small = [torch.tensor([0.3, 0.4])]
    toptim.clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.tensor([0.3, 0.4]))


# ------------------------------------------------------------------ #
# Trainer and checkpoints
# ------------------------------------------------------------------ #


class _Recorder(MetricWriter):
    def __init__(self):
        self.records = []

    def write(self, step, scalars):
        self.records.append((step, dict(scalars)))


def _trainer(tmp_path, patience=2, max_steps=50, metric_seq=None, monitor="metric",
             time_limit_s: Optional[float] = None):
    def step_fn(state, batch):
        with torch.no_grad():
            state.params["w"].mul_(0.9)
        state.step += 1
        return state, state.params["w"].abs().sum()

    seq = iter(metric_seq or [])
    writer = _Recorder()
    trainer = Trainer(
        TrainerConfig(max_steps=max_steps, val_interval=5, log_interval=5, monitor=monitor,
                      monitor_mode="max", patience=patience, ckpt_dir=str(tmp_path / "ckpts"),
                      time_limit_s=time_limit_s),
        step_fn, writer, validate_fn=lambda state, step: {"metric": next(seq, 0.0)},
        device="cpu")
    state = ttasks.TrainState(0, {"w": torch.ones(4)})
    loader = [{"x": np.zeros((2, 2), np.float32)}] * 100
    return trainer, state, loader, writer


@pytest.mark.parametrize("case", ["max_steps", "early_stop", "time_limit", "monitor_absent"])
def test_trainer_matches_jax_loop(tmp_path, case):
    """The JAX loop's tests (tests/test_training_loop.py::TestTrainer) on
    the port's Trainer."""
    if case == "max_steps":
        trainer, state, loader, writer = _trainer(tmp_path, 99, 12, [1, 2, 3, 4, 5])
        assert trainer.fit(state, loader).step == 12
        assert [s for s, r in writer.records if "loss" in r] == [5, 10]
        assert all("steps_per_sec" in r for s, r in writer.records if "loss" in r)
    elif case == "early_stop":
        # improvement at step 5, flat at 10 and 15 -> stop after patience=2
        trainer, state, loader, _ = _trainer(tmp_path, 2, 1000, [5, 5, 5, 5, 5, 5])
        assert trainer.fit(state, loader).step == 15
    elif case == "time_limit":
        trainer, state, loader, _ = _trainer(tmp_path, 99, 1000, [1, 2, 3], time_limit_s=0.0)
        assert trainer.fit(state, loader).step == 1
        assert trainer.ckpt.latest_step() == 1  # the final validation + save ran
    else:
        trainer, state, loader, _ = _trainer(tmp_path, 99, 12, [1, 2, 3],
                                             monitor="not_a_metric_we_emit")
        assert trainer.fit(state, loader).step == 12
        assert trainer.ckpt.latest_step() == 12
        assert CheckpointManager(str(tmp_path / "ckpts")).latest_step() == 12


def test_checkpoint_best_latest_and_exact_restore(tmp_path):
    params = {"w": torch.randn(3, 4), "x": {"y": torch.randn(5)}}
    state = ttasks.init_train_state(params, lr=1e-3, warmup_steps=0)
    for t in ttasks.param_leaves(state.params):
        t.grad = torch.randn_like(t)
    state.optimizer.step()
    mgr = CheckpointManager(str(tmp_path / "b"), monitor="m", mode="max")
    mgr.save(1, state, {"m": 0.1})
    mgr.save(2, state, {"m": 0.9})
    saved = {k: v.detach().clone() for k, v in _flat(state.params).items()}
    moments = [s["exp_avg"].clone() for s in state.optimizer.adamw.state.values()]
    mgr.save(3, state, {"m": 0.4})
    mgr.save(4, state, {})  # no monitored key: kept as latest, never best
    assert mgr.best_step() == 2 and mgr.latest_step() == 4
    assert sorted(int(d) for d in os.listdir(tmp_path / "b")) == [2, 4]

    fresh = ttasks.init_train_state({"w": torch.zeros(3, 4), "x": {"y": torch.zeros(5)}},
                                    lr=1e-3, warmup_steps=0)
    restored = CheckpointManager(str(tmp_path / "b")).restore(fresh, step=2)
    assert restored.step == 0 and restored.optimizer.count == 1
    for name, t in _flat(restored.params).items():
        assert torch.equal(t.detach(), saved[name]), name
    for m, s in zip(moments, restored.optimizer.adamw.state.values()):
        assert torch.equal(m, s["exp_avg"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


def test_config_depth2_override_keeps_customized_grandchild():
    """A depth-2 override keeps a parent's customized grandchild defaults
    (the JAX package's copy resets them)."""

    @dataclasses.dataclass
    class Leaf:
        a: int = 1
        b: int = 2

    @dataclasses.dataclass
    class Mid:
        leaf: Leaf = dataclasses.field(default_factory=Leaf)
        x: int = 0

    @dataclasses.dataclass
    class Top:
        mid: Mid = dataclasses.field(default_factory=lambda: Mid(leaf=Leaf(a=10), x=7))

    _, cfg = parse_config(Top, ["--mid.leaf.b", "5"])
    assert (cfg.mid.leaf.a, cfg.mid.leaf.b, cfg.mid.x) == (10, 5, 7)
    _, cfg = parse_config(Top, ["--mid.x", "3"])
    assert (cfg.mid.leaf.a, cfg.mid.x) == (10, 3)
    with pytest.raises(ValueError, match="unknown config key"):
        parse_config(Top, ["--mid.leaf.nope", "1"])


@pytest.mark.parametrize("argv_extra, error", [
    (["--model.approx", "true"], NotImplementedError),
    (["--model.loss", "hinge"], ValueError),
])
def test_cli_rejects_unported_options(toy_corpus_path, toy_dataset_dir, argv_extra, error):
    from reprover_tpu_torch.retrieval.main import main

    with pytest.raises(error):
        main(["fit", "--device", "cpu", "--model.tiny", "true",
              "--data.data_path", toy_dataset_dir, "--data.corpus_path", toy_corpus_path]
             + argv_extra)
    with pytest.raises(NotImplementedError):
        ttasks.make_train_step(ttasks.retrieval_loss, tt5.T5Config(**TINY), mesh=object())


def test_cli_fit_validate_predict(toy_corpus_path, toy_dataset_dir, tmp_path):
    """The JAX CLI smoke's flags (tests/test_training_loop.py) with
    --device cpu: fit logs loss and Recall@4_val and saves; validate restores
    the saved parameters bit for bit; predict writes 9 records."""
    from reprover_tpu_torch.retrieval.main import main

    log_dir = str(tmp_path / "logs")
    ckpt = str(tmp_path / "ck")
    common = [
        "--device", "cpu",
        "--model.tiny", "true",
        "--model.num_retrieved", "4",
        "--data.data_path", toy_dataset_dir,
        "--data.corpus_path", toy_corpus_path,
        "--data.batch_size", "2",
        "--data.eval_batch_size", "2",
        "--data.max_seq_len", "256",
        "--data.num_negatives", "2",
        "--data.num_in_file_negatives", "1",
        "--trainer.max_steps", "2",
        "--trainer.val_interval", "2",
        "--trainer.log_interval", "1",
        "--trainer.patience", "99",
        "--log_dir", log_dir,
    ]
    t0 = time.perf_counter()
    final = main(["fit"] + common + ["--trainer.ckpt_dir", ckpt, "--model.loss", "infonce"])
    assert final.step == 2
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    val = [r for r in recs if "Recall@4_val" in r]
    assert val and {"MRR", "emb_eff_rank", "cos_offdiag_std"} <= set(val[0])

    metrics, retriever = main(["validate"] + common + ["--ckpt_dir", ckpt])
    assert "Recall@4_val" in metrics
    saved = torch.load(os.path.join(ckpt, "2", "state.pt"), weights_only=True)["params"]
    for name, t in _flat(retriever.params).items():
        assert torch.equal(t.detach(), _flat(saved)[name]), name

    outputs = main(["predict"] + common + ["--ckpt_dir", ckpt, "--preds_out", "p.pickle"])
    with open(os.path.join(log_dir, "p.pickle"), "rb") as f:
        preds = pickle.load(f)
    assert len(preds) == len(outputs) == 9  # 3 splits x 3 tactics
    assert time.perf_counter() - t0 < 120


def test_validation_metrics_without_jax(toy_corpus_path, toy_dataset_dir):
    """The port's validation metrics, on the port's own data module, run with
    JAX and the JAX package unimportable (the JAX package's version imports
    its training package, which imports JAX)."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["reprover_tpu"] = None
import torch
from reprover_tpu_torch.retrieval.datamodule import RetrievalDataModule
from reprover_tpu_torch.models.t5 import T5Config, init_params, place_master_params
from reprover_tpu_torch.retrieval import PremiseRetriever, validation_metrics
cfg = T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
               num_decoder_layers=1)
params = place_master_params(init_params(cfg, torch.Generator().manual_seed(0)), "cpu")
dm = RetrievalDataModule({toy_dataset_dir!r}, {toy_corpus_path!r}, 2, 1, 2, 2, 256)
dm.setup("validate")
retriever = PremiseRetriever(params, cfg, max_seq_len=256, num_retrieved=4)
retriever.load_corpus(dm.corpus)
metrics = validation_metrics(retriever, dm.val_dataloader(), 4)
assert {{"Recall@4_val", "MRR", "emb_eff_rank", "cos_offdiag_mean"}} <= set(metrics), metrics
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items() if v is not None)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
