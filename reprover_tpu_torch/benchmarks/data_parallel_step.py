"""Data- and tensor-parallel train step by part, on 1, 2 or 4 ranks.

    python -m reprover_tpu_torch.benchmarks.data_parallel_step
        [--task retriever|generator|causal] [--ranks 1 2 4] [--model 1]
        [--steps 8] [--batch B --seq S --layers L] [--backend nccl|gloo] [--device cuda]

For each count in ``--ranks`` it spawns that many ranks (one per card;
ranks beyond the cards share them, gloo only) on a ``(ranks / model,
model)`` mesh and times ``--steps`` steps of the port's step on one fixed
random global batch, from one seed, bf16 products over float32 masters: the
retriever's InfoNCE step on the synthetic benchmark's batch (8 contexts and
32 premises, 128 bytes) or the generator's at the reference cap ([8, 2304]
sources, [8, 512] targets, ragged), both at byt5-small width with remat
``full`` as the CLIs train; or the decoder-only fine-tuning step at
LLaMA-7B width (``--layers`` of 32, fused attention, ``--batch`` x
``--seq`` tokens, ragged). With ``--model`` > 1 each rank holds its
tensor-parallel part (the cut of ``make_train_step``'s first step).
Each part is split by CUDA events on every rank: forward, backward, the
gradients' reduction over ``data``, the update (clip and AdamW on this
rank's shards) and the shards' gather; ``model_reduce`` is the part of
forward and backward spent in the all-reduces over ``model``
(each between two CUDA events, :func:`timed_model_reductions`). Rank 0 prints one JSON line per
count: medians over the steps after the first two, the step's ms, each
rank's moment and parameter bytes, peak device memory, the losses, and the
card's name and power limit (``nvidia-smi``). One rank runs the one-card
step (no collectives).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from reprover_tpu_torch.models.t5 import byt5_small, fuse_mlp_params, init_params
from reprover_tpu_torch.parallel import collectives
from reprover_tpu_torch.parallel.mesh import init_distributed, make_mesh
from reprover_tpu_torch.training.tasks import (
    causal_loss,
    generation_loss,
    init_train_state,
    rank_loss,
    retrieval_infonce_loss,
    shard_train_state,
)

PARTS = ("forward", "backward", "reduce", "update", "gather")
SEED = 0
# The causal task's default batch: the fine-tuning step's [4, 2048].
CAUSAL = dict(batch=4, seq=2048, layers=32)


def global_batch(task: str, device: torch.device, batch: int = CAUSAL["batch"],
                 seq: int = CAUSAL["seq"]) -> Dict[str, torch.Tensor]:
    """The fixed random global batch of ``task`` (module docstring)."""
    rng = np.random.default_rng(SEED)
    if task == "causal":
        lens = rng.integers(seq // 2, seq + 1, batch)
        lens[0] = seq
        mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
        out = {"input_ids": rng.integers(3, 32000, (batch, seq)) * mask, "attention_mask": mask}
        return {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    if task == "retriever":
        b, n, length = 8, 3, 128
        label = np.zeros((b, b * (1 + n)), np.float32)
        label[np.arange(b), np.arange(b)] = 1.0
        batch = {"context_ids": rng.integers(3, 259, (b, length)),
                 "context_mask": np.ones((b, length), np.int64),
                 "premise_ids": rng.integers(3, 259, (b * (1 + n), length)),
                 "premise_mask": np.ones((b * (1 + n), length), np.int64), "label": label}
    else:
        b, src, tgt = 8, 2304, 512
        src_len = rng.integers(src // 2, 2300 + 1, b)
        tgt_len = rng.integers(tgt // 8, tgt + 1, b)
        mask = (np.arange(src)[None, :] < src_len[:, None]).astype(np.int64)
        tactic = rng.integers(3, 259, (b, tgt))
        tactic[np.arange(tgt)[None, :] >= tgt_len[:, None]] = -100
        batch = {"state_ids": rng.integers(3, 259, (b, src)) * mask, "state_mask": mask,
                 "tactic_ids": tactic}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def task_config(task: str, cuda: bool, layers: int = CAUSAL["layers"]) -> Any:
    """The step's model config (bf16 products on a card, float32 on the CPU)."""
    dtype = torch.bfloat16 if cuda else torch.float32
    if task == "causal":
        from reprover_tpu_torch.models.causal_lm import CausalLMConfig

        return CausalLMConfig(num_layers=layers, compute_dtype=dtype, flash_attention=True)
    return byt5_small(compute_dtype=dtype, remat=True)


def _params(task: str, device: torch.device, cfg: Any = None) -> Dict[str, Any]:
    if task == "causal":  # float32 masters made on the device
        from reprover_tpu_torch.models.causal_lm import init_params as causal_init

        return causal_init(cfg, torch.Generator(device=device).manual_seed(SEED))
    params = init_params(byt5_small(), torch.Generator().manual_seed(SEED))
    if task == "retriever":
        params = {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}

    def place(tree: Any) -> Any:
        if isinstance(tree, dict):
            return {k: place(v) for k, v in tree.items()}
        return tree.to(device=device, dtype=torch.float32).contiguous()

    return place(fuse_mlp_params(params))


def timed_steps(task: str, steps: int, device: torch.device, mesh: Any,
                batch: int = CAUSAL["batch"], seq: int = CAUSAL["seq"],
                layers: int = CAUSAL["layers"]) -> Dict[str, Any]:
    """``steps`` steps of the data- (and tensor-) parallel step, each part
    between CUDA events (the host clock on the CPU) -> this rank's report."""
    cuda = device.type == "cuda"
    cfg = task_config(task, cuda, layers)
    loss_fn = {"retriever": retrieval_infonce_loss, "generator": generation_loss,
               "causal": causal_loss}[task]
    tensor_parallel = mesh.spans("model")
    local_loss = rank_loss(loss_fn, cfg, mesh if mesh.spans("data") or tensor_parallel
                           else None)
    state = init_train_state(_params(task, device, cfg), lr=1e-4, warmup_steps=0)
    if tensor_parallel:
        shard_train_state(state, cfg, mesh)
    if cuda:
        torch.cuda.empty_cache()
    opt = state.optimizer
    opt.shard(mesh)
    batch = global_batch(task, device, batch, seq)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def mark() -> Any:
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(a: Any, b: Any) -> float:
        return a.elapsed_time(b) if cuda else 1e3 * (b - a)

    times: List[List[float]] = []
    model_ms: List[float] = []
    losses = []
    events: List[Any] = []
    untimed = collectives._all_reduce_
    if tensor_parallel and cuda:
        collectives._all_reduce_ = timed_model_reductions(untimed, events)
    try:
        for _ in range(steps):
            events.clear()
            marks = [mark()]
            opt.zero_grad()
            loss = local_loss(state.params, batch)
            marks.append(mark())
            loss.backward()
            marks.append(mark())
            opt.reduce_gradients()
            marks.append(mark())
            opt.update()
            marks.append(mark())
            opt.gather_shards()
            marks.append(mark())
            if cuda:
                torch.cuda.synchronize(device)
            times.append([ms(a, b) for a, b in zip(marks, marks[1:])])
            model_ms.append(sum(a.elapsed_time(b) for a, b in events))
            losses.append(loss.item())
    finally:
        collectives._all_reduce_ = untimed
    warm = times[2:] or times
    parts = {p: statistics.median(t[i] for t in warm) for i, p in enumerate(PARTS)}
    if tensor_parallel and cuda:
        parts["model_reduce"] = statistics.median(model_ms[2:] or model_ms)
    return dict(parts_ms=parts, step_ms=statistics.median(sum(t) for t in warm),
                mesh=[mesh.data, mesh.model], moment_bytes=opt.moment_bytes(),
                grad_bytes=sum(p.numel() * p.element_size() for p in opt.params),
                peak_GiB=torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
                local_losses=losses)


def timed_model_reductions(all_reduce: Any, events: List[Any]) -> Any:
    """``collectives._all_reduce_`` with each all-reduce over ``model`` on a
    card between two recorded CUDA events, appended to ``events`` (the
    tensor-parallel reductions inside a step's forward and backward)."""

    def timed(t: torch.Tensor, mesh: Any, axis: str = "data") -> torch.Tensor:
        if axis != "model" or not t.is_cuda:
            return all_reduce(t, mesh, axis)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        all_reduce(t, mesh, axis)
        end.record()
        events.append((start, end))
        return t

    return timed


def card_name() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _rank_main(rank: int, n: int, init_method: str, device: str, backend: Optional[str],
               task: str, steps: int, out_dir: str, model: int, shape: Dict[str, int]) -> None:
    init_distributed(device, backend=backend, init_method=init_method, rank=rank, world_size=n)
    import torch.distributed as dist

    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
               else torch.device("cpu"))
        report = timed_steps(task, steps, dev, make_mesh(data=n // model, model=model), **shape)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run(task: str, n: int, steps: int, device: str = "cuda",
        backend: Optional[str] = None, model: int = 1,
        shape: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Spawn ``n`` ranks on a ``(n / model, model)`` mesh, time the step on
    each -> rank 0's report with every rank's moment bytes."""
    import torch.multiprocessing as mp

    if n % model:
        raise ValueError(f"--model {model} must divide the {n} ranks")
    with tempfile.TemporaryDirectory(prefix="reprover_dp_step_") as tmp:
        mp.spawn(_rank_main, args=(n, "file://" + os.path.join(tmp, "store"), device, backend,
                                   task, steps, tmp, model, shape or {}), nprocs=n, join=True)
        reports = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    out = dict(task=task, ranks=n, **reports[0])
    out["moment_bytes_per_rank"] = [r["moment_bytes"] for r in reports]
    out["step_ms_per_rank"] = [r["step_ms"] for r in reports]
    out["peak_GiB_per_rank"] = [r["peak_GiB"] for r in reports]
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="retriever", choices=("retriever", "generator", "causal"))
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel degree (the mesh's model axis)")
    ap.add_argument("--batch", type=int, default=CAUSAL["batch"], help="causal task only")
    ap.add_argument("--seq", type=int, default=CAUSAL["seq"], help="causal task only")
    ap.add_argument("--layers", type=int, default=CAUSAL["layers"], help="causal task only")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
    card = card_name() if args.device == "cuda" else None
    shape = dict(batch=args.batch, seq=args.seq, layers=args.layers)
    for n in args.ranks:
        report = run(args.task, n, args.steps, args.device, args.backend,
                     min(args.model, n), shape)
        report.update(card=card, backend=args.backend or ("nccl" if args.device == "cuda"
                                                          else "gloo"))
        print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
