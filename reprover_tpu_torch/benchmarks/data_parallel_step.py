"""Data-parallel train step by part, on 1, 2 or 4 ranks.

    python -m reprover_tpu_torch.benchmarks.data_parallel_step [--task retriever|generator]
        [--ranks 1 2 4] [--steps 8] [--backend nccl|gloo] [--device cuda]

For each count in ``--ranks`` it spawns that many ranks (one per card;
ranks beyond the cards share them, gloo only) and times ``--steps`` steps of
the port's data-parallel step on one fixed random global batch at
byt5-small width (bf16 products over float32 masters, remat ``full``, as
the CLIs train), from one seed: the retriever's InfoNCE step on the
synthetic benchmark's batch (8 contexts and 32 premises, 128 bytes) or the
generator's at the reference cap ([8, 2304] sources, [8, 512] targets,
ragged). Each part is split by CUDA events on every rank: forward, backward,
the gradients' reduction over ``data``, the update (clip and AdamW on this
rank's shards) and the shards' gather. Rank 0 prints one JSON line per
count: medians over the steps after the first two, the step's ms, each
rank's moment bytes, peak device memory, the losses, and the card's name
and power limit (``nvidia-smi``). One rank runs the one-card step (no
collectives).
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
from reprover_tpu_torch.parallel.mesh import init_distributed, make_mesh
from reprover_tpu_torch.training.tasks import (
    generation_loss,
    init_train_state,
    rank_loss,
    retrieval_infonce_loss,
)

PARTS = ("forward", "backward", "reduce", "update", "gather")
SEED = 0


def global_batch(task: str, device: torch.device) -> Dict[str, torch.Tensor]:
    """The fixed random global batch of ``task`` (module docstring)."""
    rng = np.random.default_rng(SEED)
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


def _params(task: str, device: torch.device) -> Dict[str, Any]:
    params = init_params(byt5_small(), torch.Generator().manual_seed(SEED))
    if task == "retriever":
        params = {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}

    def place(tree: Any) -> Any:
        if isinstance(tree, dict):
            return {k: place(v) for k, v in tree.items()}
        return tree.to(device=device, dtype=torch.float32).contiguous()

    return place(fuse_mlp_params(params))


def timed_steps(task: str, steps: int, device: torch.device, mesh: Any) -> Dict[str, Any]:
    """``steps`` steps of the data-parallel step, each part between CUDA
    events (the host clock on the CPU) -> this rank's report."""
    cuda = device.type == "cuda"
    cfg = byt5_small(compute_dtype=torch.bfloat16 if cuda else torch.float32, remat=True)
    loss_fn = retrieval_infonce_loss if task == "retriever" else generation_loss
    local_loss = rank_loss(loss_fn, cfg, mesh if mesh.spans("data") else None)
    state = init_train_state(_params(task, device), lr=1e-4, warmup_steps=0)
    opt = state.optimizer
    opt.shard(mesh)
    batch = global_batch(task, device)
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
    losses = []
    for _ in range(steps):
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
        losses.append(loss.item())
    warm = times[2:] or times
    parts = {p: statistics.median(t[i] for t in warm) for i, p in enumerate(PARTS)}
    return dict(parts_ms=parts, step_ms=statistics.median(sum(t) for t in warm),
                moment_bytes=opt.moment_bytes(),
                grad_bytes=sum(p.numel() * p.element_size() for p in opt.params),
                peak_GiB=torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
                local_losses=losses)


def _card() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def _rank_main(rank: int, n: int, init_method: str, device: str, backend: Optional[str],
               task: str, steps: int, out_dir: str) -> None:
    init_distributed(device, backend=backend, init_method=init_method, rank=rank, world_size=n)
    import torch.distributed as dist

    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
               else torch.device("cpu"))
        report = timed_steps(task, steps, dev, make_mesh(data=n))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run(task: str, n: int, steps: int, device: str = "cuda",
        backend: Optional[str] = None) -> Dict[str, Any]:
    """Spawn ``n`` ranks, time the step on each -> rank 0's report with
    every rank's moment bytes."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="reprover_dp_step_") as tmp:
        mp.spawn(_rank_main, args=(n, "file://" + os.path.join(tmp, "store"), device, backend,
                                   task, steps, tmp), nprocs=n, join=True)
        reports = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    out = dict(task=task, ranks=n, **reports[0])
    out["moment_bytes_per_rank"] = [r["moment_bytes"] for r in reports]
    out["step_ms_per_rank"] = [r["step_ms"] for r in reports]
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="retriever", choices=("retriever", "generator"))
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
    card = _card() if args.device == "cuda" else None
    for n in args.ranks:
        report = run(args.task, n, args.steps, args.device, args.backend)
        report.update(card=card, backend=args.backend or ("nccl" if args.device == "cuda"
                                                          else "gloo"))
        print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
