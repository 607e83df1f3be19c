"""Data-parallel dry run on ``n`` ranks: the counterpart of the data-parallel
parts of the JAX package's ``__graft_entry__.py::dryrun_multichip``, at
``model = 1``.

    python -m reprover_tpu_torch.benchmarks.multichip_dryrun [--ranks N]
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
magnitude, each rank's moments a ``1/N`` shard. It also reports which
collectives the group's backend runs on the ranks' device. The JAX dry
run's tensor-parallel serving and sequence-parallel encoder are not ported
(ROADMAP.md Queue 1 item 4): they are listed as waiting and not run. Each
rank prints one JSON line; the run exits non-zero if any step disagrees.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from reprover_tpu_torch.models import causal_lm
from reprover_tpu_torch.models.t5 import T5Config, init_params
from reprover_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from reprover_tpu_torch.training.tasks import (
    Batch,
    generation_loss,
    init_train_state,
    make_train_step,
    retrieval_loss,
    token_share,
)

RTOL = 1e-4  # float32 on both sides; the sums run in another order
LR = 1e-4
WAITING = (
    "tensor-parallel serving (StepwiseBeamEngine over the model axis): not ported, "
    "ROADMAP.md Queue 1 item 4",
    "sequence-parallel encoder (ring attention over a seq axis): not ported, "
    "ROADMAP.md Queue 1 item 4",
)
COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_gather", "all_to_all_single", "barrier")


def t5_config() -> T5Config:
    """The JAX dry run's tiny T5, float32, with heads of width 64, the
    width the card's attention kernels take (the JAX dry run's are 16)."""
    return T5Config(vocab_size=384, d_model=64, d_kv=64, d_ff=128, num_heads=2,
                    num_encoder_layers=2, num_decoder_layers=2, compute_dtype=torch.float32)


def causal_config() -> causal_lm.CausalLMConfig:
    return causal_lm.CausalLMConfig(vocab_size=96, d_model=64, num_layers=2, num_heads=4,
                                    num_kv_heads=2, d_ff=128, compute_dtype=torch.float32)


def causal_loss(params: Any, cfg: causal_lm.CausalLMConfig, batch: Batch,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Next-token cross-entropy over ``input_ids``/``attention_mask``
    (labels the ids, -100 on padding); under a mesh, this rank's share of
    the global token mean."""
    labels = torch.where(batch["attention_mask"] > 0, batch["input_ids"], -100)
    loss = causal_lm.causal_lm_loss(params, cfg, batch["input_ids"], batch["attention_mask"],
                                    labels)
    return token_share(loss, (labels[:, 1:] != -100).sum(), mesh)


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
    """One train step of ``task`` (on one rank with ``mesh=None``) -> loss,
    parameters after the step and this rank's moment bytes."""
    state = init_train_state(_to(task["params"](), device), lr=LR, warmup_steps=0)
    step: Callable = make_train_step(task["loss"], task["cfg"], mesh=mesh)
    state, loss = step(state, task["batch"])
    params = {k: v.detach().clone() for k, v in _flat(state.params).items()}
    return dict(loss=float(loss), params=params, moment_bytes=state.optimizer.moment_bytes(),
                param_bytes=sum(t.numel() * t.element_size() for t in params.values()))


def compare(dp: Dict[str, Any], one: Dict[str, Any], n: int) -> Dict[str, Any]:
    """The data-parallel step against one rank's: loss and parameter gaps
    relative to ``RTOL``, and whether the moments are a ``1/n`` shard."""
    loss_gap = abs(dp["loss"] - one["loss"]) / max(abs(one["loss"]), 1e-30)
    param_gap = max(float((dp["params"][k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                    for k, w in one["params"].items())
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


def run_rank(mesh: Mesh, device: torch.device) -> Dict[str, Any]:
    """This rank's dry run: every task's data-parallel step against its
    one-rank step, and the collectives probe."""
    n = mesh.shape["data"]
    report: Dict[str, Any] = {"rank": mesh.coord("data"), "ranks": n, "device": str(device)}
    for name, task in tasks(n, device).items():
        one = one_step(task, device, None)
        report[name] = compare(one_step(task, device, mesh), one, n)
    report["collectives"] = probe_collectives(mesh, device)
    report["waiting"] = list(WAITING)
    report["ok"] = all(report[name]["ok"] for name in ("generation", "retrieval", "causal"))
    return report


def _rank_main(rank: int, n: int, init_method: str, device: str, backend: Optional[str],
               out_dir: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(device, backend=backend, init_method=init_method, rank=rank, world_size=n)
    import torch.distributed as dist

    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
            torch.device("cpu")
        report = run_rank(make_mesh(data=n), dev)
        print(json.dumps(report), flush=True)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run(n: int, device: str = "cuda", backend: Optional[str] = None) -> List[Dict[str, Any]]:
    """Spawn ``n`` ranks and run the dry run on each -> their reports."""
    import torch.multiprocessing as mp

    if n < 2:
        raise ValueError(f"a data-parallel dry run needs at least 2 ranks, got {n}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
    with tempfile.TemporaryDirectory(prefix="reprover_dryrun_") as tmp:
        mp.spawn(_rank_main, args=(n, "file://" + os.path.join(tmp, "store"), device, backend,
                                   tmp), nprocs=n, join=True)
        reports = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    return reports


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (default: one per card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on cards, gloo on the CPU")
    args = ap.parse_args(argv)
    n = args.ranks if args.ranks is not None else (
        torch.cuda.device_count() if args.device == "cuda" else 2)
    reports = run(n, args.device, args.backend)
    for line in WAITING:
        print(f"[dryrun] waiting: {line}")
    ok = all(r["ok"] for r in reports)
    print(f"[dryrun] {n} ranks: {'ok' if ok else 'FAILED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
