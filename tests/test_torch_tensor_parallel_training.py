"""PyTorch port, tensor-parallel training on the CPU: four spawned gloo
ranks on a ``(data=2, model=2)`` mesh (one rendezvous file under
``tmp_path``, torch capped at one thread each) train three steps of
``make_train_step(model_parallel=True)`` on the MSE, InfoNCE, generation and
causal LM losses. Each is held against three one-process steps on the global
batch and against the JAX package's tensor-parallel step on the same numpy
weights (``make_mesh(data=4, model=2)`` on eight virtual devices; for the
causal family the JAX dry run's step over ``causal_param_partition_specs``);
the replicated leaves are bit-equal across ranks, ``rel_bias``'s gradient is
one process's, the moments keep their ``model`` split and add ``data``, and
the checkpoint, written in the one-card layout, reloads on one rank.

The spawned ranks import this module, so JAX is imported inside the tests
only."""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from reprover_tpu_torch.models import causal_lm as tcl
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import causal_params_from_jax, params_from_jax
from reprover_tpu_torch.parallel.mesh import Mesh, init_distributed, is_first_rank, make_mesh
from reprover_tpu_torch.parallel.sharding import FUSED_BLOCKS, model_part, shard_axis
from reprover_tpu_torch.training import tasks as ttasks
from reprover_tpu_torch.utils.checkpoint import CheckpointManager
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2, num_decoder_layers=1)
CAUSAL = dict(vocab_size=96, d_model=64, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=128)
RANKS, DATA, MODEL, ROWS, STEPS, LR = 4, 2, 2, 4, 3, 1e-4  # global batch DATA * ROWS
LOSSES = ("retrieval_loss", "retrieval_infonce_loss", "generation_loss", "causal_loss")
RTOL = 2e-4  # loss and parameters, as tests/test_training.py:225


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _cfg(loss_name):
    if loss_name == "causal_loss":
        return tcl.CausalLMConfig(**CAUSAL)
    return tt5.T5Config(**TINY)


def _batches(loss_name):
    """``STEPS`` global batches of ``DATA * ROWS`` rows (unequal valid-token
    counts across the ranks' rows; retrieval positives across ranks)."""
    rng = np.random.default_rng(LOSSES.index(loss_name))
    b = DATA * ROWS
    out = []
    for _ in range(STEPS):
        if loss_name == "causal_loss":
            mask = np.ones((b, 16), np.int32)
            for r in range(1, b):
                mask[r, 16 - r:] = 0
            out.append(dict(input_ids=rng.integers(3, CAUSAL["vocab_size"], (b, 16)),
                            attention_mask=mask))
        elif loss_name == "generation_loss":
            tactic = rng.integers(3, 259, (b, 12))
            for r, keep in enumerate([12, 11, 10, 9, 5, 4, 2, 1]):
                tactic[r, keep:] = -100
            state_mask = np.ones((b, 20), np.int32)
            state_mask[1::2, 14:] = 0
            out.append(dict(state_ids=rng.integers(3, 259, (b, 20)) * state_mask,
                            state_mask=state_mask, tactic_ids=tactic))
        else:
            prem_mask = np.ones((2 * b, 16), np.int32)
            prem_mask[::3, 10:] = 0
            label = np.zeros((b, 2 * b), np.float32)
            label[np.arange(b - 1), (np.arange(b - 1) + 3) % b] = 1.0
            label[2, b + 5] = 1.0
            out.append(dict(context_ids=rng.integers(3, 259, (b, 16)),
                            context_mask=np.ones((b, 16), np.int32),
                            premise_ids=rng.integers(3, 259, (2 * b, 16)) * prem_mask,
                            premise_mask=prem_mask, label=label))
    return out


def _jax_params(loss_name):
    """The JAX package's tiny params as numpy (T5 with a fused MLP,
    encoder-only for the retrieval losses; or the causal LM)."""
    import jax

    if loss_name == "causal_loss":
        from reprover_tpu.models import causal_lm as jcl

        return jax.tree.map(np.asarray, jcl.init_params(jax.random.PRNGKey(9),
                                                        jcl.CausalLMConfig(**CAUSAL)))
    from reprover_tpu.models import t5 as jt5

    full = jt5.fuse_mlp_params(jt5.init_params(jax.random.PRNGKey(7), jt5.T5Config(**TINY)))
    if loss_name != "generation_loss":
        full = {"shared_embedding": full["shared_embedding"], "encoder": full["encoder"]}
    return jax.tree.map(np.asarray, full)


def _port_params(params_np, loss_name):
    if loss_name == "causal_loss":
        return causal_params_from_jax(params_np)
    return params_from_jax(params_np)


def _train(params_np, loss_name, batches, mesh=None, after_first=None):
    """``STEPS`` port steps -> (losses, state); ``after_first(state)`` runs
    after the first step (its gradients still in ``.grad``)."""
    state = ttasks.init_train_state(_port_params(params_np, loss_name), lr=LR, warmup_steps=0)
    step = ttasks.make_train_step(getattr(ttasks, loss_name), _cfg(loss_name), mesh=mesh,
                                  model_parallel=mesh is not None)
    losses = []
    for i, batch in enumerate(batches):
        state, loss = step(state, ttasks.numeric_batch(batch))
        losses.append(float(loss))
        if i == 0 and after_first is not None:
            after_first(state)
    return losses, state


def _worker(rank, init_file, work):
    """One of ``RANKS`` gloo ranks of the 2x2 mesh: each loss's three steps,
    the first step's gradients, the moments' shapes, an eval step, and a
    checkpoint in the one-card layout."""
    cap_cpu_threads()
    init_distributed("cpu", init_method=f"file://{init_file}", rank=rank, world_size=RANKS)
    mesh = make_mesh(data=DATA, model=MODEL)
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {"coords": mesh.coords}
    for name in LOSSES:
        grads = {}

        def keep_grads(state):
            grads.update({k: v.grad.clone() for k, v in _flat(state.params).items()})

        losses, state = _train(inputs[name]["params"], name, inputs[name]["batches"], mesh,
                               keep_grads)
        opt = state.optimizer
        eval_loss = ttasks.make_eval_step(getattr(ttasks, name), _cfg(name), mesh=mesh)(
            state.params, ttasks.numeric_batch(inputs[name]["batches"][0]))
        ckpt = CheckpointManager(os.path.join(work, f"ckpt_{name}"),
                                 writer=is_first_rank(mesh))
        ckpt.save(STEPS, state, {"loss": losses[-1]})
        out[name] = dict(
            losses=losses, eval_loss=float(eval_loss), grads=grads,
            params={k: v.detach().clone() for k, v in _flat(state.params).items()},
            specs=_flat(state.param_specs),
            moments={path: tuple(opt.adamw.state[t]["exp_avg"].shape)
                     for path, t in zip(_flat(state.params), opt.targets)},
            shard_axes=list(opt.shard_axes), model_axes=list(opt.model_axes))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the ranks once and, while they run, take the one-process and
    the JAX package's tensor-parallel steps -> (inputs, each rank's outputs,
    {loss: (one-process losses, state, first gradients, JAX losses)})."""
    work = str(tmp_path_factory.mktemp("tp_train"))
    inputs = {name: dict(params=_jax_params(name), batches=_batches(name)) for name in LOSSES}
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    spawned = mp.spawn(_worker, args=(os.path.join(work, "rendezvous"), work), nprocs=RANKS,
                       join=False)
    refs = {}
    for name in LOSSES:
        params_np, batches = inputs[name]["params"], inputs[name]["batches"]
        grads = {}
        losses, state = _train(params_np, name, batches, after_first=lambda s: grads.update(
            {k: v.grad.clone() for k, v in _flat(s.params).items()}))
        refs[name] = (losses, state, grads, _jax_tp_losses(params_np, name, batches))
    while not spawned.join():
        pass
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(RANKS)]
    return work, inputs, outs, refs


def _jax_tp_losses(params_np, loss_name, batches):
    """The JAX package's tensor-parallel steps on ``make_mesh(data=4,
    model=2)``: ``make_train_step(model_parallel=True)`` for the T5 losses,
    the dry run's sharded causal step (``__graft_entry__.py``) for the
    causal one."""
    import jax
    import jax.numpy as jnp
    import optax

    from reprover_tpu.parallel import make_mesh as jax_make_mesh
    from reprover_tpu.training import optim as joptim

    tx = joptim.make_optimizer(LR, 0)
    mesh = jax_make_mesh(data=4, model=2)
    as_jax = [{k: jnp.asarray(v, jnp.int32 if v.dtype.kind in "iu" else None)
               for k, v in b.items()} for b in batches]
    losses = []
    if loss_name == "causal_loss":
        from jax.sharding import NamedSharding, PartitionSpec as P

        from reprover_tpu.models import causal_lm as jcl
        from reprover_tpu.parallel import causal_param_partition_specs, shard_pytree

        cfg = jcl.CausalLMConfig(**CAUSAL)
        params = shard_pytree(jax.tree.map(jnp.asarray, params_np),
                              causal_param_partition_specs(params_np, model_parallel=True), mesh)
        opt = tx.init(params)

        def loss_fn(p, ids, mask):
            labels = jnp.where(mask > 0, ids, -100)
            return jcl.causal_lm_loss(p, cfg, ids, mask, labels)

        @jax.jit
        def step(p, o, ids, mask):
            loss, g = jax.value_and_grad(loss_fn)(p, ids, mask)
            updates, o2 = tx.update(g, o, p)
            return optax.apply_updates(p, updates), o2, loss

        rows = NamedSharding(mesh, P("data", None))
        for b in as_jax:
            params, opt, loss = step(params, opt, jax.device_put(b["input_ids"], rows),
                                     jax.device_put(b["attention_mask"], rows))
            losses.append(float(loss))
        return losses
    from reprover_tpu.models import t5 as jt5
    from reprover_tpu.training import tasks as jtasks

    state = jtasks.init_train_state(jax.tree.map(jnp.asarray, params_np), tx)
    step = jtasks.make_train_step(getattr(jtasks, loss_name), jt5.T5Config(**TINY), tx,
                                  mesh=mesh, model_parallel=True)
    for b in as_jax:
        state, loss = step(state, b)
        losses.append(float(loss))
    return losses


def _replicated(path, spec):
    return shard_axis(spec, "model") is None


@pytest.mark.parametrize("loss_name", LOSSES)
def test_tensor_parallel_step_matches_one_process_and_jax(ranks, loss_name):
    """Loss at each of three steps on every rank: the one-process step's
    and the JAX package's tensor-parallel step's (rel 2e-4); the eval step
    under the mesh gives the first batch's loss at the final weights."""
    _, inputs, outs, refs = ranks
    want, one, _, jax_losses = refs[loss_name]
    with torch.no_grad():
        eval_want = float(getattr(ttasks, loss_name)(
            one.params, _cfg(loss_name), ttasks.numeric_batch(inputs[loss_name]["batches"][0])))
    for r, out in enumerate(outs):
        got = out[loss_name]
        np.testing.assert_allclose(got["losses"], want, rtol=RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=RTOL, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["eval_loss"], eval_want, rtol=RTOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("loss_name", LOSSES)
def test_replicated_leaves_bit_equal_and_shards_match_one_process(ranks, loss_name):
    """Replicated leaves (norms, embeddings, ``rel_bias``) are bit-equal on
    every rank; each split leaf is the one-process parameter's slice on its
    ``model`` coordinate (of each half of a fused gate|up ``wi``; rel 2e-4
    of the leaf's largest magnitude)."""
    _, _, outs, refs = ranks
    one = _flat(refs[loss_name][1].params)
    specs = outs[0][loss_name]["specs"]
    assert any(not _replicated(p, s) for p, s in specs.items())
    for r, out in enumerate(outs):
        got = out[loss_name]["params"]
        for path, t in got.items():
            want = one[path].detach()
            axis = shard_axis(specs[path], "model")
            if axis is None:
                assert torch.equal(t, outs[0][loss_name]["params"][path]), (r, path)
            else:
                want = model_part(want, axis, Mesh(DATA, MODEL, out["coords"]),
                                  FUSED_BLOCKS.get(path.rsplit("/", 1)[-1], 1))
            np.testing.assert_allclose(t.numpy(), want.numpy(), rtol=RTOL,
                                       atol=RTOL * float(want.abs().max()), err_msg=path)


def test_rel_bias_gradient_equals_one_process(ranks):
    """``rel_bias`` is replicated, each rank reads its heads' columns: its
    first-step gradient, summed over ``model`` (and ``data``) and clipped,
    is the one-process step's on every rank (the encoder's and the
    decoder's)."""
    _, _, outs, refs = ranks
    for name in ("generation_loss", "retrieval_loss"):
        want = refs[name][2]
        paths = [p for p in want if p.endswith("rel_bias")]
        assert paths
        for out in outs:
            for path in paths:
                w = want[path].numpy()
                np.testing.assert_allclose(out[name]["grads"][path].numpy(), w, rtol=RTOL,
                                           atol=RTOL * np.abs(w).max(), err_msg=path)


def test_moments_keep_model_split_and_add_data(ranks):
    """Each rank's moments are its ``model`` shard of the leaf, further cut
    over ``data`` on another axis: the optimizer's data axis never is the
    leaf's model axis, and most leaves hold half their shard."""
    _, _, outs, _ = ranks
    for name in LOSSES:
        for out in outs:
            res = out[name]
            split_data = 0
            for (path, shape), data_axis, model_axis in zip(
                    res["moments"].items(), res["shard_axes"], res["model_axes"]):
                local = list(res["params"][path].shape)
                assert model_axis == shard_axis(res["specs"][path], "model"), path
                if data_axis is not None:
                    assert data_axis != model_axis, path
                    local[data_axis] //= DATA
                    split_data += 1
                assert shape == tuple(local), (name, path)
            assert split_data >= len(res["moments"]) // 2
            assert any(a is not None for a in res["model_axes"])


@pytest.mark.parametrize("loss_name", ["generation_loss", "causal_loss"])
def test_tensor_parallel_checkpoint_reloads_on_one_rank(ranks, loss_name):
    """The first rank's checkpoint holds whole leaves and moments (the
    one-card layout): it restores into a one-process state, whose parameters
    equal the one-process run's after the same steps (rel 2e-4) and whose
    optimizer keeps the saved update count."""
    work, inputs, _, refs = ranks
    one = refs[loss_name][1]
    fresh = ttasks.init_train_state(_port_params(inputs[loss_name]["params"], loss_name),
                                    lr=LR, warmup_steps=0)
    CheckpointManager(os.path.join(work, f"ckpt_{loss_name}")).restore(fresh)
    assert fresh.step == STEPS and fresh.optimizer.count == STEPS
    want = _flat(one.params)
    for path, t in _flat(fresh.params).items():
        w = want[path].detach().numpy()
        np.testing.assert_allclose(t.detach().numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=path)
    for p, st in zip(fresh.optimizer.params, fresh.optimizer.adamw.state.values()):
        assert st["exp_avg"].shape == p.shape
