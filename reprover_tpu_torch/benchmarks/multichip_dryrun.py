"""Data-, tensor- and sequence-parallel dry run on ``n`` ranks: the
counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``.

    python -m reprover_tpu_torch.benchmarks.multichip_dryrun [--ranks N] [--model M]
        [--device cuda|cpu] [--backend nccl|gloo]

Spawns ``--ranks`` ranks (default: one per card) in a process group of its
own (NCCL on cards, gloo on the CPU, unless ``--backend`` names one; ranks
beyond the cards share them, which only gloo allows) and runs, on each, one
train step of ``make_train_step(mesh=make_mesh(data=N))`` for

- the generation task (encoder, decoder and token-weighted cross-entropy,
  the ranks' rows holding unequal counts of valid tokens),
- the retrieval task (MSE against the label matrix, the in-batch negatives
  gathered across ranks),
- the decoder-only causal LM (next-token cross-entropy),

each with ZeRO-sharded moments, on the JAX dry run's tiny geometries (T5
heads widened to 64, the kernels' width) in float32 with seeded random
weights, and holds each against the same step on
one rank (every rank also runs it alone on the global batch): the loss
within ``RTOL`` and every parameter within ``RTOL`` of its leaf's largest
magnitude (a tensor-parallel rank's shard against the one-rank leaf's
slice), each rank's moments a ``1/N`` shard. With ``--model M`` (default 2
on an even count of ranks) the same three steps run again on the ``(N / M,
M)`` mesh, tensor-parallel (the JAX dry run's ``(data, model)``
causal step), and the T5 streaming engine runs sharded over ``model``
(the JAX dry run's tensor-parallel serving: one wave of two slots, the
first rank leading the others), held against the one-rank engine: the
same beams, the largest score gap printed. On a mesh whose ``seq`` axis
spans the ``n`` ranks it runs the JAX dry run's sequence-parallel encoder:
``encode_sequence_parallel`` at ``L = 16 n``, two rows, an all-ones mask,
gathered and held to one rank's ``encode`` within ``SP_RTOL`` (rtol and
atol, the JAX dry run's). It also reports which collectives the group's
backend runs on the ranks' device, and which peer-to-peer ops it runs
there (each in two child processes of its own: gloo can abort a process
whose blocking ``send`` meets a CUDA tensor), beside the transport the ring's
shift uses. Each rank prints one JSON line; the run exits non-zero if any
step, engine or encoder disagrees.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from reprover_tpu_torch.models import causal_lm
from reprover_tpu_torch.models.t5 import T5Config, encode, encode_sequence_parallel, init_params
from reprover_tpu_torch.parallel.collectives import RING_TRANSPORT, gather_axis
from reprover_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from reprover_tpu_torch.parallel.sharding import FUSED_BLOCKS, model_part, shard_axis
from reprover_tpu_torch.training.tasks import (
    causal_loss,
    generation_loss,
    init_train_state,
    make_train_step,
    retrieval_loss,
)

RTOL = 1e-4  # float32 on both sides; the sums run in another order
SP_RTOL = 2e-4  # the JAX dry run's limit for its sequence-parallel encoder
LR = 1e-4
# The tensor-parallel engine's wave (the JAX dry run's: 2 slots x 4 beams,
# sources of 16, decode 8, chunks of 4).
ENGINE = dict(num_slots=2, num_beams=4, src=16, dec=8, chunk=4)
COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_gather", "all_to_all_single", "barrier")
P2P = ("send_recv", "isend_irecv", "batch_isend_irecv")
P2P_TIMEOUT_S = 60


def t5_config() -> T5Config:
    """The JAX dry run's tiny T5, float32, with heads of width 64, the
    width the card's attention kernels take (the JAX dry run's are 16)."""
    return T5Config(vocab_size=384, d_model=64, d_kv=64, d_ff=128, num_heads=2,
                    num_encoder_layers=2, num_decoder_layers=2, compute_dtype=torch.float32)


def causal_config() -> causal_lm.CausalLMConfig:
    return causal_lm.CausalLMConfig(vocab_size=96, d_model=64, num_layers=2, num_heads=4,
                                    num_kv_heads=2, d_ff=128, compute_dtype=torch.float32)


def tasks(n: int, device: torch.device) -> Dict[str, Dict[str, Any]]:
    """The three tasks' (loss, config, params maker, global batch), from
    seeds; the batch has ``2 n`` rows."""
    rng = np.random.default_rng(0)
    b = 2 * n

    def ids(vocab: int, *shape: int) -> torch.Tensor:
        return torch.from_numpy(rng.integers(3, vocab, shape)).to(device)

    tcfg, ccfg = t5_config(), causal_config()
    tactic = ids(tcfg.vocab_size, b, 8)
    for r in range(b):  # unequal valid-token counts across the ranks' rows
        tactic[r, 8 - (r * 7) // max(b - 1, 1):] = -100
    label = torch.zeros((b, 2 * b), device=device)
    label[:, :b] = torch.eye(b, device=device)
    cmask = torch.ones((b, 16), dtype=torch.long, device=device)
    for r in range(1, b):
        cmask[r, 16 - 2 * r:] = 0
    return {
        "generation": dict(loss=generation_loss, cfg=tcfg, params=lambda: init_params(
            tcfg, torch.Generator().manual_seed(0)), batch={
                "state_ids": ids(tcfg.vocab_size, b, 16),
                "state_mask": torch.ones((b, 16), dtype=torch.long, device=device),
                "tactic_ids": tactic}),
        "retrieval": dict(loss=retrieval_loss, cfg=tcfg, params=lambda: _encoder_only(
            init_params(tcfg, torch.Generator().manual_seed(1))), batch={
                "context_ids": ids(tcfg.vocab_size, b, 16),
                "context_mask": torch.ones((b, 16), dtype=torch.long, device=device),
                "premise_ids": ids(tcfg.vocab_size, 2 * b, 16),
                "premise_mask": torch.ones((2 * b, 16), dtype=torch.long, device=device),
                "label": label}),
        "causal": dict(loss=causal_loss, cfg=ccfg, params=lambda: causal_lm.init_params(
            ccfg, torch.Generator().manual_seed(2)), batch={
                "input_ids": ids(ccfg.vocab_size, b, 16), "attention_mask": cmask}),
    }


def _encoder_only(params: Dict[str, Any]) -> Dict[str, Any]:
    return {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}


def _to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _flat(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def one_step(task: Dict[str, Any], device: torch.device, mesh: Optional[Mesh]) -> Dict[str, Any]:
    """One train step of ``task`` (on one rank with ``mesh=None``; tensor
    parallel when the mesh's ``model`` axis spans ranks) -> loss,
    parameters after the step (this rank's shards), their specs and this
    rank's moment bytes."""
    state = init_train_state(_to(task["params"](), device), lr=LR, warmup_steps=0)
    step: Callable = make_train_step(task["loss"], task["cfg"], mesh=mesh)
    state, loss = step(state, task["batch"])
    params = {k: v.detach().clone() for k, v in _flat(state.params).items()}
    return dict(loss=float(loss), params=params, moment_bytes=state.optimizer.moment_bytes(),
                specs=_flat(state.param_specs) if state.param_specs is not None else None,
                param_bytes=sum(t.numel() * t.element_size() for t in params.values()))


def _one_rank_part(w: torch.Tensor, path: str, dp: Dict[str, Any], mesh: Mesh) -> torch.Tensor:
    """The one-rank leaf ``w``'s part that this rank holds under ``dp``'s
    tensor-parallel specs (``w`` itself off tensor parallelism)."""
    axis = None if dp["specs"] is None else shard_axis(dp["specs"][path], "model")
    if axis is None:
        return w
    return model_part(w, axis, mesh, FUSED_BLOCKS.get(path.rsplit("/", 1)[-1], 1))


def compare(dp: Dict[str, Any], one: Dict[str, Any], n: int,
            mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The data- (or tensor-) parallel step against one rank's: loss and
    parameter gaps relative to ``RTOL``, and whether the moments are a
    ``1/n`` shard."""
    loss_gap = abs(dp["loss"] - one["loss"]) / max(abs(one["loss"]), 1e-30)
    param_gap = max(
        float((dp["params"][k] - _one_rank_part(w, k, dp, mesh)).abs().max())
        / max(float(w.abs().max()), 1e-30) for k, w in one["params"].items())
    sharded = dp["moment_bytes"] < one["moment_bytes"] * (1.5 / n if n > 1 else 1.01)
    return dict(loss=dp["loss"], loss_one_rank=one["loss"], loss_rel_gap=loss_gap,
                param_rel_gap=param_gap, moment_bytes=dp["moment_bytes"],
                moment_bytes_one_rank=one["moment_bytes"], sharded=sharded,
                ok=bool(loss_gap <= RTOL and param_gap <= RTOL and sharded))


def probe_collectives(mesh: Mesh, device: torch.device) -> Dict[str, str]:
    """Which collectives the group's backend runs on ``device`` tensors:
    ``ok`` or the error's first line (each raises on every rank alike)."""
    import torch.distributed as dist

    n, group = mesh.shape["data"], mesh.group("data")
    x = torch.ones(4 * n, device=device)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0, group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * n * n, device=device), x, group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=device), x, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x,
                                              group=group),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x,
                                                            group=group),
        "barrier": lambda: dist.barrier(group=group),
    }
    out = {}
    for name in COLLECTIVES:
        try:
            calls[name]()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = str(e).strip().splitlines()[0][:160]
    return out


def _p2p_rank(rank: int, op: str, init_method: str, device: str, backend: str,
              out_dir: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(device, backend=backend, init_method=init_method, rank=rank, world_size=2)
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device("cpu")
    x = torch.full((1024,), float(rank + 1), device=dev)
    y = torch.zeros_like(x)
    peer = 1 - rank
    try:
        # Rank 0 sends first and rank 1 receives first: NCCL runs ungrouped
        # point-to-point ops in order, so two sends first would wait forever.
        if op == "send_recv":
            for send in (rank == 0, rank != 0):
                dist.send(x, peer) if send else dist.recv(y, peer)
        elif op == "isend_irecv":
            works = [dist.isend(x, peer) if send else dist.irecv(y, peer)
                     for send in (rank == 0, rank != 0)]
            for work in works:
                work.wait()
        else:
            for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                                dist.P2POp(dist.irecv, y, peer)]):
                work.wait()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        result = "ok" if bool((y == peer + 1).all()) else "wrong values"
    except (RuntimeError, ValueError, NotImplementedError) as e:
        result = str(e).strip().splitlines()[0][:160]
    with open(os.path.join(out_dir, f"{op}{rank}"), "w") as f:
        f.write(result)
    dist.destroy_process_group()


def probe_p2p(device: str, backend: str) -> Dict[str, str]:
    """Which peer-to-peer ops ``backend`` runs on ``device`` tensors between
    two ranks: ``ok``, the first error line of rank 0 (or 1), or how a rank
    died. Each op runs in a process group of two child processes of its own,
    all ops at once, so an op that aborts a process or leaves its group's
    connections closed touches nothing else."""
    import torch.multiprocessing as mp

    out = {}
    with tempfile.TemporaryDirectory(prefix="reprover_p2p_") as tmp:
        runs = {op: mp.start_processes(
            _p2p_rank, args=(op, "file://" + os.path.join(tmp, f"{op}.store"), device, backend,
                             tmp), nprocs=2, join=False, start_method="spawn") for op in P2P}
        deadline = time.monotonic() + P2P_TIMEOUT_S
        for op, ctx in runs.items():
            try:  # join returns as each process ends: wait for both or the deadline
                while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                    if time.monotonic() >= deadline:
                        break
            except Exception as e:  # a rank that died: its signal or exit code
                out[op] = "crashed: " + str(e).strip().splitlines()[0][:160]
                continue
            if any(proc.is_alive() for proc in ctx.processes):
                for proc in ctx.processes:
                    proc.kill()
                out[op] = f"hung for {P2P_TIMEOUT_S} s"
                continue
            results = [open(os.path.join(tmp, f"{op}{r}")).read() for r in range(2)]
            out[op] = next((r for r in results if r != "ok"), "ok")
    return out


def sequence_parallel(mesh: Mesh, device: torch.device) -> Dict[str, Any]:
    """The JAX dry run's sequence-parallel encoder on ``mesh``'s ``seq``
    axis: ``encode_sequence_parallel`` of two rows of ``L = 16 n`` seeded
    ids under an all-ones mask, gathered, against one rank's ``encode`` of
    the same rows (on a card its attention kernel)."""
    n = mesh.shape["seq"]
    cfg = t5_config()
    params = _to(init_params(cfg, torch.Generator().manual_seed(3)), device)
    length = 16 * n
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (2, length))).to(device)
    mask = torch.ones((2, length), dtype=torch.long, device=device)
    with torch.no_grad():
        ref = encode(params, cfg, ids, mask)
        got = gather_axis(encode_sequence_parallel(params, cfg, ids, mask, mesh), 1, mesh, "seq")
    return dict(seq=n, length=length, max_abs_gap=float((got - ref).abs().max()),
                transport=RING_TRANSPORT,
                ok=bool(torch.allclose(got, ref, rtol=SP_RTOL, atol=SP_RTOL)))


def tp_engine(mesh: Mesh, device: torch.device) -> Optional[Dict[str, Any]]:
    """The T5 streaming engine sharded over ``model`` (the first rank leads,
    the others follow) against the one-rank engine on the same weights and
    wave: on the leader, whether every slot's beams are the same tokens and
    the largest score gap; None on the others."""
    from reprover_tpu_torch.generation.engine import StepwiseBeamEngine

    cfg, e = t5_config(), ENGINE
    params = _to(init_params(cfg, torch.Generator().manual_seed(4)), device)
    rng = np.random.default_rng(4)
    ids = rng.integers(3, cfg.vocab_size, (e["num_slots"], e["src"]))
    mask = np.ones_like(ids)
    mask[1, e["src"] // 2:] = 0

    def beams(engine: Any) -> Dict[int, Any]:
        engine.admit_batch_tokens(list(range(e["num_slots"])), ids, mask)
        out = {}
        while engine.has_active():
            engine.run_chunk()
            for slot in engine.finished_slots():
                out[slot] = engine.finalize(slot)
        return out

    def build(m: Optional[Mesh]) -> Any:
        return StepwiseBeamEngine(params, cfg, e["num_slots"], e["num_beams"], e["src"], e["dec"],
                                  chunk_size=e["chunk"], mesh=m)

    engine = build(mesh)
    if not mesh.is_leader:
        engine.follow()
        return None
    try:
        got = beams(engine)
    finally:
        engine.release_followers()
    want = beams(build(None))
    same = all(np.array_equal(got[s][0], want[s][0]) for s in want) and set(got) == set(want)
    gap = max(float(np.abs(got[s][1] - want[s][1]).max()) for s in want) if same else None
    return dict(same_tokens=bool(same), score_gap=gap, local_heads=engine.state.self_k.shape[3],
                ok=bool(same and gap is not None and gap <= RTOL * 10))


def run_rank(mesh: Mesh, device: torch.device, seq_mesh: Optional[Mesh] = None
             ) -> Dict[str, Any]:
    """This rank's dry run: every task's data-parallel step, or on a mesh
    whose ``model`` axis spans ranks its tensor-parallel step and the
    tensor-parallel engine, against the one-rank step; the collectives
    probe; with a ``seq_mesh`` the sequence-parallel encoder on it."""
    n, tensor_parallel = mesh.shape["data"], mesh.spans("model")
    report: Dict[str, Any] = {"rank": mesh.coord("data"), "ranks": n, "model": mesh.model,
                              "coords": list(mesh.coords), "device": str(device)}
    for name, task in tasks(n, device).items():
        one = one_step(task, device, None)
        report[name] = compare(one_step(task, device, mesh), one, mesh.size, mesh)
    checks = ["generation", "retrieval", "causal"]
    if tensor_parallel:
        report["engine"] = tp_engine(mesh, device)
        if report["engine"] is not None:
            checks.append("engine")
    else:
        report["collectives"] = probe_collectives(mesh, device)
    if seq_mesh is not None:
        report["sequence_parallel"] = sequence_parallel(seq_mesh, device)
        checks.append("sequence_parallel")
    report["ok"] = all(report[name]["ok"] for name in checks)
    return report


def _rank_main(rank: int, n: int, init_method: str, device: str, backend: Optional[str],
               out_dir: str, model: int) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(device, backend=backend, init_method=init_method, rank=rank, world_size=n)
    import torch.distributed as dist

    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
            torch.device("cpu")
        report = run_rank(make_mesh(data=n), dev, make_mesh(data=1, seq=n))
        if model > 1:
            report["tensor_parallel"] = run_rank(make_mesh(data=n // model, model=model), dev)
            report["ok"] = report["ok"] and report["tensor_parallel"]["ok"]
        print(json.dumps(report), flush=True)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run(n: int, device: str = "cuda", backend: Optional[str] = None,
        model: int = 1) -> List[Dict[str, Any]]:
    """Spawn ``n`` ranks and run the dry run on each (with ``model`` > 1 the
    tensor-parallel one too) -> their reports."""
    import torch.multiprocessing as mp

    if n < 2:
        raise ValueError(f"a data-parallel dry run needs at least 2 ranks, got {n}")
    if n % model:
        raise ValueError(f"--model {model} must divide the {n} ranks")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
    p2p = probe_p2p(device, backend or ("nccl" if device == "cuda" else "gloo"))
    with tempfile.TemporaryDirectory(prefix="reprover_dryrun_") as tmp:
        mp.spawn(_rank_main, args=(n, "file://" + os.path.join(tmp, "store"), device, backend,
                                   tmp, model), nprocs=n, join=True)
        reports = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(dict(json.load(f), p2p=p2p))
    return reports


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (default: one per card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on cards, gloo on the CPU")
    ap.add_argument("--model", type=int, default=None,
                    help="tensor-parallel degree of the second mesh (default 2 on an even "
                         "count of ranks; 1 skips it)")
    args = ap.parse_args(argv)
    n = args.ranks if args.ranks is not None else (
        torch.cuda.device_count() if args.device == "cuda" else 2)
    model = args.model if args.model is not None else (2 if n % 2 == 0 else 1)
    reports = run(n, args.device, args.backend, model)
    for r in reports:
        tp = r.get("tensor_parallel")
        if tp is not None:
            gaps = {k: (tp[k]["loss_rel_gap"], tp[k]["param_rel_gap"])
                    for k in ("generation", "retrieval", "causal")}
            print(f"[dryrun] rank {tp['coords']} of ({tp['ranks']}, {tp['model']}): loss and "
                  f"parameter gaps against one rank {json.dumps(gaps)}; engine "
                  f"{json.dumps(tp.get('engine'))}")
    sp = reports[0]["sequence_parallel"]
    print(f"[dryrun] sequence parallel over {sp['seq']} ranks at L {sp['length']}: largest gap "
          f"{sp['max_abs_gap']:.3g} against one rank (limit {SP_RTOL}); the ring's transport "
          f"{sp['transport']}; peer-to-peer ops on {args.device}: {json.dumps(reports[0]['p2p'])}")
    ok = all(r["ok"] for r in reports)
    print(f"[dryrun] {n} ranks: {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
