"""PyTorch port, sequence parallelism on the CPU: the mirror of
``tests/test_ring_attention.py``. Four spawned gloo ranks (one rendezvous
file under ``tmp_path``, torch capped at one thread each) form a ``seq``
axis of 4, two of 2 (``make_mesh(data=2, seq=2)``: ranks 0-1 and 2-3) and
one of 3, and run the ring attention, ``encode_sequence_parallel``, their
gradient, ``ring_shift`` and the multichip dry run's sequence-parallel part
on them. While they run, the test process takes the references: the JAX
package's ``ring_encoder_attention`` and ``encode_sequence_parallel`` on 2-
and 4-device CPU meshes (fp32 atol/rtol 2e-5, JAX's own limit), and the
port's one-process ``encode``, its plain attention and their autograd
(gradients within 1e-4 of each leaf's largest magnitude). Inputs are
seeded numpy; weights cross over with ``models/bridge.params_from_jax``
and the fused MLP. A row whose keys are all padding gives 0 from the ring
(the port's convention; the JAX ring's finite ``NEG_INF`` gives the mean
of ``v``), so the JAX comparisons cover the rows with a valid key.

Without ranks: a ``seq`` axis of one rank is the plain attention, an
indivisible length raises, the WandB writer drives a stub ``wandb`` as the
JAX package's does and ``make_writer`` warns without the package; the dry
run's peer-to-peer probe (its own child processes) runs every op over gloo
on the CPU.

The spawned ranks import this module, so JAX is imported inside the tests
only."""

import json
import logging
import os
import sys
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.ops.flash_attention import encoder_attention_reference
from reprover_tpu_torch.ops.ring_attention import ring_encoder_attention
from reprover_tpu_torch.parallel.collectives import (
    RING_TRANSPORT,
    gather_axis,
    reduce_gradients_,
    ring_shift,
)
from reprover_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

RANKS = 4
TOL = 2e-5  # fp32, the JAX ring test's limit
GRAD_RTOL = 1e-4  # of each leaf's largest gradient magnitude
SEQS = (2, 4)
# The JAX ring test's three cases: (B, H, L, d, seed, masked, max_distance).
RING_CASES = {
    "unmasked": (2, 4, 64, 8, 0, False, 128),
    "masked": (2, 4, 64, 8, 0, True, 128),
    "long_distance": (1, 2, 256, 8, 1, False, 32),
}
T5 = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2, num_decoder_layers=1)
ENC_SHAPE = (2, 64)
RAGGED_SHAPE = (3, 64)  # on seq 4: row 1 ends inside shard 0, row 2 is all padding


def _ring_inputs(case):
    b, h, length, d, seed, masked, _ = RING_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, length, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, length), np.int32)
    if masked:
        mask = (rng.random((b, length)) > 0.3).astype(np.int32)
        mask[:, :2] = 1
    rel = rng.normal(size=(32, h)).astype(np.float32)
    return q, k, v, mask, rel


def _enc_inputs(ragged=False):
    b, length = RAGGED_SHAPE if ragged else ENC_SHAPE
    rng = np.random.default_rng(2 if ragged else 0)
    ids = rng.integers(3, 384, (b, length)).astype(np.int32)
    mask = (rng.random((b, length)) > 0.2).astype(np.int32)
    mask[:, :2] = 1
    if ragged:
        mask[0] = 1
        mask[1, 10:] = 0
        mask[2] = 0
    return ids, mask


def _ragged_attention_inputs():
    rng = np.random.default_rng(5)
    b, length = RAGGED_SHAPE
    q, k, v = (rng.normal(size=(b, 4, length, 8)).astype(np.float32) for _ in range(3))
    return q, k, v, _enc_inputs(ragged=True)[1], rng.normal(size=(32, 4)).astype(np.float32)


def _grad_weights():
    b, length = ENC_SHAPE
    return np.random.default_rng(7).normal(size=(b, length, T5["d_model"])).astype(np.float32)


def _jax_params():
    import jax

    from reprover_tpu.models import t5 as jt5

    cfg = jt5.T5Config(**T5)
    return jax.tree.map(np.asarray, jt5.fuse_mlp_params(jt5.init_params(jax.random.PRNGKey(0),
                                                                        cfg)))


def _port(params_np):
    return params_from_jax(params_np), tt5.T5Config(**T5, compute_dtype=torch.float32)


def _shard(x, mesh, dim):
    n, r = mesh.shape["seq"], mesh.coord("seq")
    s = x.shape[dim] // n
    return x.narrow(dim, r * s, s)


def _ring(mesh, q, k, v, mask, rel, max_distance=128):
    """This rank's ring attention on the whole inputs' shards, gathered."""
    t = [torch.from_numpy(np.asarray(x)) for x in (q, k, v)]
    out = ring_encoder_attention(*(_shard(x, mesh, 2) for x in t),
                                 _shard(torch.from_numpy(mask), mesh, 1), torch.from_numpy(rel),
                                 mesh, max_distance=max_distance)
    return gather_axis(out, 2, mesh, "seq")


def _flat_grads(params):
    leaves = {"shared_embedding": params["shared_embedding"],
              "rel_bias": params["encoder"]["rel_bias"],
              "final_norm": params["encoder"]["final_norm"]}
    for block, tree in params["encoder"]["layers"].items():
        if isinstance(tree, dict):
            leaves.update({f"{block}/{k}": w for k, w in tree.items()})
        else:
            leaves[block] = tree
    return leaves


def _grad_run(params, cfg, mesh=None):
    """Gradients of ``sum(encode * w)`` over the encoder's leaves: one
    process, or this rank's share through the ring made whole over
    ``seq``."""
    leaves = _flat_grads(params)
    for t in leaves.values():
        t.requires_grad_(True)
    ids, mask = (torch.from_numpy(x).long() for x in _enc_inputs())
    w = torch.from_numpy(_grad_weights())
    if mesh is None:
        loss = (tt5.encode(params, cfg, ids, mask) * w).sum()
    else:
        loss = (tt5.encode_sequence_parallel(params, cfg, ids, mask, mesh)
                * _shard(w, mesh, 1)).sum()
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    if mesh is not None:
        reduce_gradients_(list(grads.values()), mesh, "seq")
    return grads


def _worker(rank, init_file, work):
    cap_cpu_threads()
    init_distributed("cpu", init_method=f"file://{init_file}", rank=rank, world_size=RANKS)
    from reprover_tpu_torch.benchmarks import multichip_dryrun

    meshes = {4: make_mesh(data=1, seq=4), 2: make_mesh(data=2, seq=2)}
    try:
        meshes[3] = make_mesh(data=1, seq=3, devices=[0, 1, 2])
    except ValueError:  # rank 3 is outside the 3-rank ring
        pass
    params, cfg = _port(torch.load(os.path.join(work, "params.pt"), weights_only=False))
    out = {}
    with torch.no_grad():
        for n in SEQS:
            mesh = meshes[n]
            for case, spec in RING_CASES.items():
                out[f"ring/{case}/{n}"] = _ring(mesh, *_ring_inputs(case), max_distance=spec[6])
            ids, mask = (torch.from_numpy(x).long() for x in _enc_inputs())
            h = tt5.encode_sequence_parallel(params, cfg, ids, mask, mesh)
            out[f"encode/{n}"] = gather_axis(h, 1, mesh, "seq")
        ragged = _ragged_attention_inputs()
        out["ragged/ring"] = _ring(meshes[4], *ragged)
        ids, mask = (torch.from_numpy(x).long() for x in _enc_inputs(ragged=True))
        out["ragged/encode"] = gather_axis(
            tt5.encode_sequence_parallel(params, cfg, ids, mask, meshes[4]), 1, meshes[4], "seq")
        out["dryrun"] = multichip_dryrun.sequence_parallel(meshes[4], torch.device("cpu"))
    out["grads"] = _grad_run(params, cfg, meshes[2])
    if 3 in meshes:  # ring_shift on 3 ranks: next != previous
        mesh = meshes[3]
        x = torch.full((2, 5), float(rank + 1), requires_grad=True)
        y = ring_shift(x, mesh)
        (y * (10.0 * (rank + 1))).sum().backward()
        z, handle = ring_shift(x.detach() * 2, mesh, async_op=True)
        handle.wait()
        out["shift"] = dict(forward=y.detach(), grad=x.grad, async_forward=z)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def _jax_refs(params_np):
    """The JAX package's ring and sequence-parallel encoder on 2- and
    4-device meshes, and its one-device encoder on the ragged batch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from reprover_tpu.models import t5 as jt5
    from reprover_tpu.ops.ring_attention import ring_encoder_attention as jax_ring

    cfg = jt5.T5Config(**T5)
    params = jax.tree.map(jnp.asarray, params_np)
    refs = {}
    for n in SEQS:
        mesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
        for case, spec in RING_CASES.items():
            q, k, v, mask, rel = (jnp.asarray(x) for x in _ring_inputs(case))
            refs[f"ring/{case}/{n}"] = np.asarray(jax_ring(q, k, v, mask, rel, mesh,
                                                           max_distance=spec[6]))
        ids, mask = (jnp.asarray(x) for x in _enc_inputs())
        refs[f"encode/{n}"] = np.asarray(jt5.encode_sequence_parallel(params, cfg, ids, mask, mesh))
    ids, mask = (jnp.asarray(x) for x in _enc_inputs(ragged=True))
    refs["ragged/encode"] = np.asarray(jt5.encode(params, cfg, ids, mask))
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the ranks once and, while they run, take the references ->
    (each rank's outputs, the JAX package's, the port's one-process
    gradients)."""
    work = str(tmp_path_factory.mktemp("ring"))
    params_np = _jax_params()
    torch.save(params_np, os.path.join(work, "params.pt"))
    spawned = mp.spawn(_worker, args=(os.path.join(work, "rendezvous"), work), nprocs=RANKS,
                       join=False)
    refs = _jax_refs(params_np)
    grads = _grad_run(*_port(params_np))
    while not spawned.join():
        pass
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(RANKS)]
    return outs, refs, grads


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=what)


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_matches_jax_ring(ranks, case, seq):
    """The ring over ``seq`` ranks against the JAX ring on as many devices:
    unmasked, masked (``[:, :2] = 1``), and ``L = 256`` at ``max_distance
    = 32`` (the log buckets across shards); every rank gathers the same."""
    outs, refs, _ = ranks
    key = f"ring/{case}/{seq}"
    for rank, out in enumerate(outs):
        _close(out[key], refs[key], f"{key} rank {rank}")


@pytest.mark.parametrize("seq", SEQS)
def test_encode_sequence_parallel_matches_jax_and_encode(ranks, seq):
    """``encode_sequence_parallel`` (fused MLP, masked rows) against the JAX
    package's on as many devices and against the port's one-process
    ``encode`` with its plain attention."""
    outs, refs, _ = ranks
    key = f"encode/{seq}"
    params, cfg = _port(_jax_params())
    ids, mask = (torch.from_numpy(x).long() for x in _enc_inputs())
    with torch.no_grad():
        one = tt5.encode(params, cfg, ids, mask)
    for rank, out in enumerate(outs):
        _close(out[key], refs[key], f"{key} rank {rank} vs JAX")
        _close(out[key], one, f"{key} rank {rank} vs encode")


def test_ring_fully_padded_shard(ranks):
    """A ragged batch on 4 ranks: row 1's keys end inside shard 0 (shards
    1-3 all padding), row 2 has none. The ring is finite everywhere, equals
    the plain attention on rows with a valid key and gives 0 on row 2."""
    outs, _, _ = ranks
    q, k, v, mask, rel = _ragged_attention_inputs()
    b, h, length, d = q.shape

    def flat(x):
        return torch.from_numpy(x).transpose(1, 2).reshape(b, length, h * d)

    want = encoder_attention_reference(flat(q), flat(k), flat(v), torch.from_numpy(mask),
                                       torch.from_numpy(rel), h)
    want = want.reshape(b, length, h, d).transpose(1, 2)
    for rank, out in enumerate(outs):
        got = out["ragged/ring"]
        assert torch.isfinite(got).all(), rank
        _close(got[:2], want[:2], f"ragged ring rank {rank}")
        assert torch.equal(got[2], torch.zeros_like(got[2])), rank


def test_encode_sequence_parallel_fully_padded_shard(ranks):
    """``encode_sequence_parallel`` on the ragged batch: finite, equal to the
    port's one-process ``encode`` on every row (both give row 2's attention
    0) and to the JAX package's ``encode`` on the rows with a valid key."""
    outs, refs, _ = ranks
    params, cfg = _port(_jax_params())
    ids, mask = (torch.from_numpy(x).long() for x in _enc_inputs(ragged=True))
    with torch.no_grad():
        one = tt5.encode(params, cfg, ids, mask)
    for rank, out in enumerate(outs):
        got = out["ragged/encode"]
        assert torch.isfinite(got).all(), rank
        _close(got, one, f"ragged encode rank {rank} vs encode")
        _close(got[:2], refs["ragged/encode"][:2], f"ragged encode rank {rank} vs JAX")


def test_ring_gradient_matches_one_process(ranks):
    """The gradient of a seeded scalar of the encoder's output with respect
    to every encoder leaf, ``rel_bias`` included, through the ring on 2
    ranks (each rank's share summed over ``seq``), against autograd of the
    one-process ``encode``; both 2-rank rings give it."""
    outs, _, want = ranks
    for rank, out in enumerate(outs):
        for name, g in want.items():
            scale = max(float(g.abs().max()), 1e-30)
            err = float((out["grads"][name] - g).abs().max()) / scale
            assert err <= GRAD_RTOL, (rank, name, err)


def test_ring_shift_and_its_transpose(ranks):
    """``ring_shift`` on 3 ranks (next != previous): rank ``r`` receives rank
    ``r - 1``'s tensor, forward and async; the gradient of rank ``r``'s
    input is what rank ``r + 1`` multiplied its output by (``ppermute``'s
    transpose, ``i -> i - 1``); the fourth rank is outside the ring."""
    outs, _, _ = ranks
    assert "shift" not in outs[3]
    for r in range(3):
        got = outs[r]["shift"]
        prev, nxt = (r - 1) % 3, (r + 1) % 3
        assert torch.equal(got["forward"], torch.full((2, 5), float(prev + 1)))
        assert torch.equal(got["async_forward"], torch.full((2, 5), 2.0 * (prev + 1)))
        assert torch.equal(got["grad"], torch.full((2, 5), 10.0 * (nxt + 1)))


def test_dryrun_sequence_parallel_part(ranks):
    """The multichip dry run's sequence-parallel part on 4 ranks: ``L = 64``
    against one rank's ``encode`` within the JAX dry run's 2e-4, over the
    ring's transport."""
    outs, _, _ = ranks
    for out in outs:
        d = out["dryrun"]
        assert d["ok"] and d["seq"] == 4 and d["length"] == 64, d
        assert d["transport"] == RING_TRANSPORT == "all_to_all_single"
        assert d["max_abs_gap"] <= 2e-4


def test_one_rank_seq_axis_is_plain_attention():
    """On a ``seq`` axis of one rank the ring is the plain attention and
    ``encode_sequence_parallel`` is ``encode``; an indivisible length or
    mismatched shards raise ``ValueError`` before any collective."""
    q, k, v, mask, rel = _ring_inputs("masked")
    b, h, length, d = q.shape
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = ring_encoder_attention(*t, torch.from_numpy(mask), torch.from_numpy(rel), Mesh(1))

    def flat(x):
        return x.transpose(1, 2).reshape(b, length, h * d)

    want = encoder_attention_reference(*(flat(x) for x in t), torch.from_numpy(mask),
                                       torch.from_numpy(rel), h)
    _close(flat(got), want, "one-rank ring")
    params, cfg = _port(_jax_params())
    ids, emask = (torch.from_numpy(x).long() for x in _enc_inputs())
    with torch.no_grad():
        _close(tt5.encode_sequence_parallel(params, cfg, ids, emask, Mesh(1)),
               tt5.encode(params, cfg, ids, emask), "one-rank encode")
    two = Mesh(1, seq=2, seq_coord=1)
    with pytest.raises(ValueError, match="not divisible by seq=2"):
        tt5.encode_sequence_parallel(params, cfg, ids[:, :63], emask[:, :63], two)
    with pytest.raises(ValueError, match="one shard"):
        ring_encoder_attention(*t, torch.from_numpy(mask)[:, :32], torch.from_numpy(rel), two)


def test_seq_mesh_shape_without_groups():
    """A ``seq`` axis beside ``(data, model)``: its size and coordinate, the
    pair ``coords`` unchanged, and a mesh of several ranks outside a process
    group refused."""
    mesh = Mesh(2, 1, (1, 0), seq=2, seq_coord=1)
    assert mesh.shape == {"data": 2, "seq": 2, "model": 1}
    assert (mesh.coord("seq"), mesh.coords, mesh.size) == (1, (1, 0), 4)
    assert not mesh.is_leader and Mesh(1, seq=2).is_leader
    with pytest.raises(RuntimeError, match="1x2x1 mesh needs an initialized process group"):
        make_mesh(data=1, seq=2, devices=[0, 1])


class _StubWandb(types.ModuleType):
    """What ``WandbWriter`` calls of ``wandb``, recorded."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []
        stub = self

        class Table:
            def __init__(self, columns, data):
                self.columns, self.data = columns, data

        class Config:
            def update(self, hparams, allow_val_change=False):
                stub.calls.append(("config", hparams, allow_val_change))

        self.Table = Table
        self.run = types.SimpleNamespace(config=Config())

    def init(self, project, name=None):
        self.calls.append(("init", project, name))
        return self.run

    def log(self, data, step=None):
        self.calls.append(("log", data, step))

    def finish(self):
        self.calls.append(("finish",))


def test_wandb_writer_drives_wandb(monkeypatch, tmp_path):
    """``make_writer(wandb_project=...)`` with a ``wandb`` module: init with
    the project, scalars and text tables logged at their step, hparams into
    the run's config, finish on close; the stdout and JSONL writers kept."""
    from reprover_tpu_torch.utils import metrics

    stub = _StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    writer = metrics.make_writer(str(tmp_path), wandb_project="reprover", stdout_every=1)
    kinds = [type(w).__name__ for w in writer.writers]
    assert kinds == ["StdoutWriter", "JsonlWriter", "WandbWriter"]
    writer.write(3, {"loss": 1.5})
    writer.write_text(3, "samples", [{"state": "a", "tactic": "simp"}, {"state": "b"}])
    writer.write_text(4, "empty", [])
    writer.write_hparams({"lr": 1e-4})
    writer.close()
    assert stub.calls[0] == ("init", "reprover", None)
    assert stub.calls[1] == ("log", {"loss": 1.5}, 3)
    _, table, step = stub.calls[2]
    assert step == 3 and table["samples"].columns == ["state", "tactic"]
    assert table["samples"].data == [["a", "simp"], ["b", ""]]
    assert stub.calls[3:] == [("config", {"lr": 1e-4}, True), ("finish",)]
    records = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert records[0]["loss"] == 1.5 and records[-1] == {"hparams": {"lr": 1e-4}}


def test_make_writer_without_wandb_warns(monkeypatch, tmp_path, caplog):
    """Without the ``wandb`` package ``make_writer(wandb_project=...)`` logs a
    warning and returns the stdout and JSONL writers, as the JAX package's
    factory does; existing callers (no project) are unchanged."""
    from reprover_tpu_torch.utils import metrics

    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    with caplog.at_level(logging.WARNING, logger=metrics.logger.name):
        writer = metrics.make_writer(str(tmp_path), wandb_project="reprover")
    assert "wandb not installed" in caplog.text
    assert [type(w).__name__ for w in writer.writers] == ["StdoutWriter", "JsonlWriter"]
    plain = metrics.make_writer(None, stdout_every=7)
    assert [type(w).__name__ for w in plain.writers] == ["StdoutWriter"]
    assert plain.writers[0].every == 7


def test_p2p_probe_on_cpu_gloo():
    """The dry run's peer-to-peer probe: each op in two child processes of
    its own over gloo, which runs all three on CPU tensors (on CUDA tensors
    it runs none: the probe names the error, or how a rank died, instead of
    taking the dry run down)."""
    from reprover_tpu_torch.benchmarks import multichip_dryrun

    got = multichip_dryrun.probe_p2p("cpu", "gloo")
    assert got == {op: "ok" for op in multichip_dryrun.P2P}, got
