"""PyTorch port, data-parallel training on the CPU: four spawned gloo ranks
(one rendezvous file under ``tmp_path``, torch capped at one thread each)
train three steps of ``make_train_step(mesh)`` on the MSE, InfoNCE and
generation losses, held against three one-process steps on the global
batch and against the JAX package's sharded step (``make_mesh(data=4)``
on four virtual devices); their moments are ZeRO shards, on the host after
``offload_opt_state``; ``reindex_corpus`` under the mesh equals the one-rank
index and the indexer CLI in the ranks' group writes one artifact, the
one-process one; ``retrieval.main fit`` on two ranks started with torchrun's
environment writes the one-rank fit's checkpoint; an indivisible
tensor-parallel degree, a mesh without process groups and
``remat_policy='offload'`` under a mesh raise.

The spawned ranks import this module, so JAX is imported inside the tests
only."""

import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from reprover_tpu_torch.parallel.sharding import shard_axis, zero_partition_specs
from reprover_tpu_torch.training import tasks as ttasks
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2, num_decoder_layers=1)
RANKS, ROWS, STEPS, LR = 4, 2, 3, 1e-4  # global batch RANKS * ROWS
LOSSES = ("retrieval_loss", "retrieval_infonce_loss", "generation_loss")
RTOL = 2e-4  # loss and parameters (atol: RTOL x the leaf's largest magnitude)
INDEXER_ARGS = ["--batch-size", "2", "--max-seq-len", "256", "--device", "cpu"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _unflat(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.strip("/").split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def _batches(loss_name):
    """``STEPS`` global batches. Retrieval: each context's positive is a
    premise of another rank's chunk (local negatives alone would give
    another loss), one context has none. Generation: the ranks' rows hold
    unequal counts of valid target tokens."""
    rng = np.random.default_rng(LOSSES.index(loss_name))
    b = RANKS * ROWS
    out = []
    for _ in range(STEPS):
        if loss_name == "generation_loss":
            tactic = rng.integers(3, 259, (b, 12))
            for r, keep in enumerate([12, 11, 10, 9, 5, 4, 2, 1]):
                tactic[r, keep:] = -100
            state_mask = np.ones((b, 20), np.int32)
            state_mask[1::2, 14:] = 0
            out.append(dict(state_ids=rng.integers(3, 259, (b, 20)) * state_mask,
                            state_mask=state_mask, tactic_ids=tactic))
            continue
        prem_mask = np.ones((2 * b, 16), np.int32)
        prem_mask[::3, 10:] = 0
        label = np.zeros((b, 2 * b), np.float32)
        label[np.arange(b - 1), (np.arange(b - 1) + 3) % b] = 1.0
        label[2, b + 5] = 1.0  # a second positive, in the negatives' block
        out.append(dict(context_ids=rng.integers(3, 259, (b, 16)),
                        context_mask=np.ones((b, 16), np.int32),
                        premise_ids=rng.integers(3, 259, (2 * b, 16)) * prem_mask,
                        premise_mask=prem_mask, label=label))
    return out


def _jax_params(loss_name):
    """The JAX package's tiny params (fused MLP) as numpy; encoder-only for
    the retrieval losses."""
    import jax

    from reprover_tpu.models import t5 as jt5

    full = jt5.fuse_mlp_params(jt5.init_params(jax.random.PRNGKey(7), jt5.T5Config(**TINY)))
    if loss_name != "generation_loss":
        full = {"shared_embedding": full["shared_embedding"], "encoder": full["encoder"]}
    return jax.tree.map(np.asarray, full)


def _train(params_np, loss_name, batches, mesh=None):
    """``STEPS`` port steps -> (losses, final state)."""
    state = ttasks.init_train_state(params_from_jax(params_np), lr=LR, warmup_steps=0)
    step = ttasks.make_train_step(getattr(ttasks, loss_name), tt5.T5Config(**TINY), mesh=mesh)
    losses = []
    for batch in batches:
        state, loss = step(state, ttasks.numeric_batch(batch))
        losses.append(float(loss))
    return losses, state


def _worker(rank, init_file, work):
    """One of ``RANKS`` gloo ranks: the three losses' steps, the moments'
    shapes, offloading, a sharded re-index, the indexer CLI (each rank names
    its own output) and a 2x2 mesh's coordinates."""
    from reprover_tpu_torch.retrieval.indexer import main as index
    from reprover_tpu_torch.retrieval.retriever import PremiseRetriever
    from reprover_tpu_torch.utils.profiling import counters

    cap_cpu_threads()
    init_distributed("cpu", init_method=f"file://{init_file}", rank=rank, world_size=RANKS)
    mesh = make_mesh(data=RANKS)
    out = {"coords": mesh.coords}
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    for name in LOSSES:
        losses, state = _train(inputs[name]["params"], name, inputs[name]["batches"], mesh)
        moments = {path: tuple(state.optimizer.adamw.state[t]["exp_avg"].shape)
                   for path, t in zip(_flat(state.params), state.optimizer.targets)}
        state = ttasks.offload_opt_state(state, mesh)
        on_host = all(state.optimizer.adamw.state[t][k].device.type == "cpu"
                      for t in state.optimizer.targets for k in ("exp_avg", "exp_avg_sq"))
        out[name] = dict(losses=losses, moments=moments, on_host=on_host,
                         offloaded=state.optimizer.offload_moments,
                         moment_bytes=state.optimizer.moment_bytes(),
                         params={k: v.detach().clone() for k, v in _flat(state.params).items()})
    retriever = PremiseRetriever(params_from_jax(inputs["retrieval_loss"]["params"]),
                                 tt5.T5Config(**TINY), max_seq_len=256, bucket_multiple=32,
                                 mesh=mesh)
    retriever.load_corpus(inputs["corpus"])
    before = counters()
    retriever.reindex_corpus(batch_size=2)
    out["counted"] = {k: v - before.get(k, 0) for k, v in counters().items()
                      if k.startswith("retriever.")}
    out["index"] = retriever.corpus_embeddings.clone()
    index(["--ckpt-path", inputs["hf_ckpt"], "--corpus-path", inputs["corpus"],
           "--output-path", os.path.join(work, f"indexed{rank}")] + INDEXER_ARGS)
    out["mesh22"] = make_mesh(data=2, model=2).coords
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, toy_corpus_path):
    """Spawn the ``RANKS`` ranks once and, while they run, take the
    one-process and the JAX package's sharded steps -> (inputs, each rank's
    outputs, {loss: (one-process losses, params, JAX losses, params)})."""
    work = str(tmp_path_factory.mktemp("dp"))
    inputs = {name: dict(params=_jax_params(name), batches=_batches(name)) for name in LOSSES}
    inputs["corpus"] = toy_corpus_path
    inputs["hf_ckpt"] = _export_hf_retriever(work)
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    spawned = mp.spawn(_worker, args=(os.path.join(work, "rendezvous"), work), nprocs=RANKS,
                       join=False)
    refs = {}
    for name in LOSSES:
        params_np, batches = inputs[name]["params"], inputs[name]["batches"]
        losses, state = _train(params_np, name, batches)
        one = _unflat({k: v.detach() for k, v in _flat(state.params).items()})
        refs[name] = (losses, one) + _jax_mesh_steps(params_np, name, batches)
    while not spawned.join():
        pass
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(RANKS)]
    return inputs, outs, refs


def _export_hf_retriever(work):
    """A tiny encoder-only HF checkpoint of seeded JAX parameters."""
    import jax

    from reprover_tpu.models.hf_import import export_hf_t5
    from reprover_tpu.models import t5 as jt5

    cfg = jt5.T5Config(**TINY)
    full = jt5.init_params(jax.random.PRNGKey(9), cfg)
    out = os.path.join(work, "hf_retriever")
    export_hf_t5({"shared_embedding": full["shared_embedding"], "encoder": full["encoder"]}, cfg,
                 out, encoder_only=True)
    return out


def _jax_mesh_steps(params_np, loss_name, batches):
    """The JAX package's sharded step (``make_mesh(data=4)``)."""
    import jax
    import jax.numpy as jnp

    from reprover_tpu.models import t5 as jt5
    from reprover_tpu.parallel import make_mesh as jax_make_mesh
    from reprover_tpu.training import optim as joptim
    from reprover_tpu.training import tasks as jtasks

    tx = joptim.make_optimizer(LR, 0)
    state = jtasks.init_train_state(jax.tree.map(jnp.asarray, params_np), tx)
    step = jtasks.make_train_step(getattr(jtasks, loss_name), jt5.T5Config(**TINY), tx,
                                  mesh=jax_make_mesh(data=RANKS))
    losses = []
    for batch in batches:
        state, loss = step(state, {k: jnp.asarray(v, jnp.int32 if v.dtype.kind in "iu" else None)
                                   for k, v in batch.items()})
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def _close_params(got, want, what):
    for name, w in _flat(want).items():
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=f"{what} {name}")


@pytest.mark.parametrize("loss_name", LOSSES)
def test_data_parallel_step_matches_one_process_and_jax_mesh(ranks, loss_name):
    """Loss at each of three steps and the final parameters: every rank
    equals the one-process step on the global batch and the JAX package's
    sharded step (rel 2e-4), the ranks equal each other exactly."""
    _, outs, refs = ranks
    want_losses, one, jax_losses, jax_params = refs[loss_name]
    for r, out in enumerate(outs):
        got = out[loss_name]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=RTOL, err_msg=f"rank {r}")
        _close_params(got["params"], one, f"rank {r} vs one process:")
        _close_params(got["params"], jax_params, f"rank {r} vs JAX mesh:")
        for name, t in got["params"].items():
            assert torch.equal(t, outs[0][loss_name]["params"][name]), (r, name)


def test_negatives_gathered_and_tokens_weighted(ranks):
    """The global batch's loss is not the mean of per-rank losses: local
    negatives alone (each rank's own premises and label columns) and the
    per-rank token means both give other values than the data-parallel
    step's first loss."""
    inputs, outs, _ = ranks
    cfg = tt5.T5Config(**TINY)
    for name in LOSSES:
        params = params_from_jax(inputs[name]["params"])
        batch = ttasks.numeric_batch(inputs[name]["batches"][0])
        per_rank = []
        for r in range(RANKS):
            rows = {k: v[r * v.shape[0] // RANKS:(r + 1) * v.shape[0] // RANKS]
                    for k, v in batch.items()}
            if name != "generation_loss":
                p = batch["premise_ids"].shape[0] // RANKS
                rows["label"] = rows["label"][:, r * p:(r + 1) * p]
            with torch.no_grad():
                per_rank.append(float(getattr(ttasks, name)(params, cfg, rows)))
        got = outs[0][name]["losses"][0]
        assert abs(np.mean(per_rank) - got) > 1e-3 * abs(got), (name, per_rank, got)


def test_moments_are_zero_shards_and_offload_to_host(ranks):
    """Each rank holds a quarter of every leaf along the axis
    ``zero_partition_specs`` names (leaves with none whole), about a quarter
    of the one-rank bytes; ``offload_opt_state(state, mesh)`` moves them to
    the host."""
    inputs, outs, _ = ranks
    for name in LOSSES:
        params = _flat(params_from_jax(inputs[name]["params"]))
        specs = _flat(zero_partition_specs(_unflat(params), Mesh(RANKS)))
        whole = 4 * sum(t.numel() for t in params.values()) * 2
        sharded = 0
        for path, t in params.items():
            axis = shard_axis(specs[path])
            want = list(t.shape)
            if axis is not None:
                want[axis] //= RANKS
                sharded += 1
            for out in outs:
                assert out[name]["moments"][path] == tuple(want), (name, path)
        assert sharded >= len(params) // 2
        for out in outs:
            assert out[name]["on_host"] and out[name]["offloaded"]
            assert out[name]["moment_bytes"] < 0.3 * whole


def test_sharded_reindex_and_mesh_coordinates(ranks, toy_corpus_path):
    """``reindex_corpus`` on four ranks equals the one-rank index (atol
    1e-5) on every rank; a 2x2 mesh puts ``model`` innermost. Each rank
    serialises the whole corpus, counts the batches it embedded and times one
    gather; the ranks' counts add up to the one-rank re-index's."""
    from reprover_tpu_torch.retrieval.retriever import PremiseRetriever
    from reprover_tpu_torch.utils.profiling import counters

    inputs, outs, _ = ranks
    one = PremiseRetriever(params_from_jax(inputs["retrieval_loss"]["params"]),
                           tt5.T5Config(**TINY), max_seq_len=256, bucket_multiple=32)
    one.load_corpus(toy_corpus_path)
    before = counters()
    one.reindex_corpus(batch_size=2)
    whole = {k: v - before.get(k, 0) for k, v in counters().items()}
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["index"].numpy(), one.corpus_embeddings.numpy(),
                                   atol=1e-5, err_msg=f"rank {r}")
        assert out["coords"] == (r, 0)
        assert out["mesh22"] == (r // 2, r % 2)
        assert out["counted"]["retriever.gather.calls"] == 1
        assert out["counted"]["retriever.premises_prepared"] == len(one.corpus.all_premises)
    for key in ("retriever.premises", "retriever.batches", "retriever.tokens_real",
                "retriever.tokens_padded"):
        assert sum(out["counted"][key] for out in outs) == whole[key], key
    assert whole.get("retriever.gather.calls", 0) == 0


def test_indexer_on_ranks_writes_the_one_process_artifact(ranks, tmp_path):
    """``retrieval.indexer`` run by each of the ranks in their group: only
    the first rank's output exists, and it equals the indexer's on one
    process (corpus order, embeddings within 1e-5)."""
    from reprover_tpu_torch.data import IndexedCorpus
    from reprover_tpu_torch.retrieval.indexer import main as index

    inputs, outs, _ = ranks
    work = os.path.dirname(inputs["hf_ckpt"])
    written = sorted(n for n in os.listdir(work) if n.startswith("indexed"))
    assert written == ["indexed0"], written
    one = str(tmp_path / "one")
    index(["--ckpt-path", inputs["hf_ckpt"], "--corpus-path", inputs["corpus"],
           "--output-path", one] + INDEXER_ARGS)
    got, want = IndexedCorpus.load(os.path.join(work, "indexed0")), IndexedCorpus.load(one)
    assert [p.full_name for p in got.corpus.all_premises] == [
        p.full_name for p in want.corpus.all_premises]
    np.testing.assert_allclose(got.embeddings, want.embeddings, atol=1e-5, rtol=0)


def test_tensor_parallel_and_offload_remat_raise_under_a_mesh():
    """A ``model`` degree that does not divide the heads (TINY's 4 over 3)
    raises ValueError; a ``Mesh(2, 2)`` built without process groups raises
    the mesh's error, with or without the JAX package's
    ``model_parallel=True``; ``remat_policy='offload'`` under a mesh raises
    ValueError, as in the JAX package. Tensor-parallel steps themselves:
    tests/test_torch_tensor_parallel_training.py."""
    cfg = tt5.T5Config(**TINY)
    for mesh in (Mesh(1, 3), Mesh(4, 3)):
        with pytest.raises(ValueError, match="must divide num_heads=4"):
            ttasks.make_train_step(ttasks.retrieval_loss, cfg, mesh=mesh, model_parallel=True)
    with pytest.raises(ValueError, match="must divide num_heads=4"):
        ttasks.make_eval_step(ttasks.retrieval_loss, cfg, mesh=Mesh(1, 3))
    with pytest.raises(RuntimeError, match="no process group"):
        ttasks.make_train_step(ttasks.retrieval_loss, cfg, mesh=Mesh(2, 2))
    with pytest.raises(RuntimeError, match="no process group"):
        ttasks.make_train_step(ttasks.retrieval_loss, cfg, mesh=Mesh(2, 2), model_parallel=True)
    with pytest.raises(RuntimeError, match="no process group"):
        ttasks.make_eval_step(ttasks.retrieval_loss, cfg, mesh=Mesh(2, 2))
    offload = tt5.T5Config(**TINY, remat=True, remat_policy="offload")
    with pytest.raises(ValueError, match="single-device"):
        ttasks.make_train_step(ttasks.retrieval_loss, offload, mesh=Mesh(4))
    state = ttasks.init_train_state(tt5.init_params(cfg, torch.Generator().manual_seed(0)),
                                    1e-3, 0)
    with pytest.raises(RuntimeError, match="no process group"):
        ttasks.offload_opt_state(state, Mesh(2, 2))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fit_rank(rank, world, port, argv):
    """A rank started as torchrun starts one: the environment names the
    group; ``retrieval.main fit`` joins it."""
    from reprover_tpu_torch.retrieval.main import main

    cap_cpu_threads()
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    main(["fit"] + argv)


def test_cli_fit_on_two_ranks_writes_the_one_rank_checkpoint(tmp_path, toy_corpus_path,
                                                              toy_dataset_dir):
    """``retrieval.main fit --device cpu --model.tiny true`` on two ranks
    (torchrun-style environment, gloo): the first rank's checkpoint equals
    the one-rank fit's (parameters and moments, rel 2e-4, moments in the
    one-card layout), its logged losses too, and ``validate`` reads it."""
    from reprover_tpu_torch.retrieval.main import main

    def argv(tag):
        return ["--device", "cpu", "--model.tiny", "true", "--model.num_retrieved", "4",
                "--data.data_path", toy_dataset_dir, "--data.corpus_path", toy_corpus_path,
                "--data.batch_size", "2", "--data.eval_batch_size", "2",
                "--data.max_seq_len", "256", "--data.num_negatives", "2",
                "--data.num_in_file_negatives", "1", "--model.lr", "1e-4",
                "--model.warmup_steps", "0", "--trainer.max_steps", "2",
                "--trainer.val_interval", "2", "--trainer.log_interval", "1",
                "--trainer.patience", "99", "--log_dir", str(tmp_path / tag / "logs"),
                "--trainer.ckpt_dir", str(tmp_path / tag / "ck")]

    mp.spawn(_fit_rank, args=(2, _free_port(), argv("dp")), nprocs=2, join=True)
    main(["fit"] + argv("one"))
    states = {tag: torch.load(str(tmp_path / tag / "ck" / "2" / "state.pt"), weights_only=True)
              for tag in ("dp", "one")}
    _close_params(_flat(states["dp"]["params"]), states["one"]["params"], "dp fit:")
    dp_opt, one_opt = (states[t]["optimizer"]["adamw"]["state"] for t in ("dp", "one"))
    assert set(dp_opt) == set(one_opt)
    for i in one_opt:
        for key in ("exp_avg", "exp_avg_sq"):
            want = one_opt[i][key].numpy()
            np.testing.assert_allclose(dp_opt[i][key].numpy(), want, rtol=RTOL,
                                       atol=RTOL * np.abs(want).max(), err_msg=f"{i} {key}")
    logs = {}
    for tag in ("dp", "one"):
        with open(tmp_path / tag / "logs" / "metrics.jsonl") as f:
            logs[tag] = [json.loads(line) for line in f]
    losses = {t: [r["loss"] for r in recs if "loss" in r] for t, recs in logs.items()}
    np.testing.assert_allclose(losses["dp"], losses["one"], rtol=RTOL)
    assert any("Recall@4_val" in r for r in logs["dp"])
    metrics, retriever = main(["validate"] + argv("dp")[:-2]
                              + ["--ckpt_dir", str(tmp_path / "dp" / "ck")])
    assert "Recall@4_val" in metrics
    for name, t in _flat(retriever.params).items():
        assert torch.equal(t.detach(), _flat(states["dp"]["params"])[name]), name
