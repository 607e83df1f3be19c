"""Sequence-parallel encoder on 1, 2 or 4 ranks: ms per encode, the ring's
transfer and the peak memory per rank, beside one card's ``encode``.

    python -m reprover_tpu_torch.benchmarks.sequence_parallel_encode [--ranks 1 2 4]
        [--lengths 16384 32768 65536] [--device cuda|cpu] [--backend nccl|gloo] [--tiny]

For each count in ``--ranks`` it spawns that many ranks (one per card;
ranks beyond the cards share them, gloo only) on a ``seq`` mesh of them.
Every rank makes the same seeded random byt5-small encoder (12 layers,
bf16; ``--tiny``: 2 layers of 2 heads of 16, a seconds-long CPU run) and,
for each of ``--lengths``, encodes one row of seeded ids under an all-ones
mask with ``encode_sequence_parallel``: one warm-up, then ``ITERS``
encodes timed with CUDA events (the host clock on the CPU), the median
kept. Beside it each rank times one ``ring_shift`` of a layer's k/v/mask
shard alone (median of 5: the transfer a step posts and overlaps, ``n - 1``
of them a layer) and reads its peak memory. On one rank it also times the
one-card ``encode`` at the same length (the attention kernels' long route,
kernel 2, past 4096) and reports the ring output's per-row cosine against
it. Prints one JSON line per (ranks, length): every rank's medians and
peaks, the card's name and power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from reprover_tpu_torch.benchmarks.data_parallel_step import card_name
from reprover_tpu_torch.parallel.mesh import init_distributed, make_mesh

SEED = 0
BATCH = 1
ITERS = 3
SHIFT_ITERS = 5


def model(dtype: torch.dtype, tiny: bool) -> tuple:
    """The seeded encoder, byt5-small (12 layers; ``tiny``: 2 layers of 2
    heads of 16) with one decoder layer -> (cfg in ``dtype``, float32 host
    params; ``place_params`` puts them on a device in ``dtype``)."""
    from reprover_tpu_torch.models.t5 import T5Config, byt5_small, init_params

    cfg = (T5Config(d_model=32, d_kv=16, d_ff=64, num_heads=2, num_encoder_layers=2,
                    num_decoder_layers=1, compute_dtype=dtype) if tiny
           else byt5_small(num_decoder_layers=1, compute_dtype=dtype))
    return cfg, init_params(cfg, torch.Generator().manual_seed(SEED))


def timed(fn: Callable[[], Any], iters: int, device: torch.device) -> List[float]:
    """ms of each of ``iters`` calls after one warm-up: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    out = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def _peak_GiB(device: torch.device) -> Optional[float]:
    return torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else None


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def run_rank(mesh: Any, device: torch.device, lengths: List[int], tiny: bool
             ) -> List[Dict[str, Any]]:
    """This rank's rows, one per length."""
    import torch.distributed as dist

    from reprover_tpu_torch.models.t5 import encode, encode_sequence_parallel, place_params
    from reprover_tpu_torch.ops import flash_attention
    from reprover_tpu_torch.parallel.collectives import ring_shift

    cfg, params = model(torch.bfloat16, tiny)
    params = place_params(params, cfg, device)
    n = mesh.shape["seq"]
    rows = []
    for length in lengths:
        rng = np.random.default_rng(SEED + length)
        ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (BATCH, length))).to(device)
        mask = torch.ones((BATCH, length), dtype=torch.long, device=device)
        row: Dict[str, Any] = dict(ranks=n, length=length, batch=BATCH, rank=mesh.coord("seq"))
        with torch.inference_mode():
            if n > 1:
                dist.barrier(group=mesh.group("seq"))
            _reset_peak(device)
            ms = timed(lambda: encode_sequence_parallel(params, cfg, ids, mask, mesh), ITERS,
                       device)
            row.update(ms=statistics.median(ms), ms_all=ms, peak_GiB=_peak_GiB(device))
            shard = length // n
            buf = torch.zeros(2 * BATCH * cfg.num_heads * shard * cfg.d_kv + BATCH * shard,
                              dtype=cfg.compute_dtype, device=device)
            shift = (timed(lambda: ring_shift(buf, mesh), SHIFT_ITERS, device) if n > 1
                     else None)
            row.update(shift_ms=statistics.median(shift) if shift else None,
                       shift_bytes=buf.numel() * buf.element_size(),
                       transfer_ms_per_encode=(statistics.median(shift) * (n - 1)
                                               * cfg.num_encoder_layers if shift else 0.0))
            if n == 1:
                flash_attention.reset_launch_counts()
                _reset_peak(device)
                one = timed(lambda: encode(params, cfg, ids, mask), ITERS, device)
                row.update(one_card_ms=statistics.median(one), one_card_ms_all=one,
                           one_card_peak_GiB=_peak_GiB(device),
                           one_card_launches={k: v for k, v in
                                              flash_attention.KERNEL_LAUNCHES.items() if v})
                ring = encode_sequence_parallel(params, cfg, ids, mask, mesh).float()
                ref = encode(params, cfg, ids, mask).float()
                row["cosine_min"] = float(torch.nn.functional.cosine_similarity(
                    ring, ref, dim=-1).min())
        rows.append(row)
    return rows


def _rank_main(rank: int, n: int, init_method: str, device: str, backend: Optional[str],
               args: Dict[str, Any], out_dir: str) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(device, backend=backend, init_method=init_method, rank=rank, world_size=n)
    import torch.distributed as dist

    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
               else torch.device("cpu"))
        rows = run_rank(make_mesh(data=1, seq=n), dev, **args)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def run(n: int, device: str = "cuda", backend: Optional[str] = None,
        **args: Any) -> List[Dict[str, Any]]:
    """Spawn ``n`` ranks -> one row per length: rank 0's, with every rank's
    medians and peaks."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="reprover_sp_encode_") as tmp:
        mp.spawn(_rank_main, args=(n, "file://" + os.path.join(tmp, "store"), device, backend,
                                   args, tmp), nprocs=n, join=True)
        per_rank = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                per_rank.append(json.load(f))
    out = []
    for i, row in enumerate(per_rank[0]):
        row = dict(row)
        row.pop("rank")
        for key in ("ms", "shift_ms", "peak_GiB"):
            row[f"{key}_per_rank"] = [rows[i][key] for rows in per_rank]
        out.append(row)
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--lengths", type=int, nargs="+", default=[16384, 32768, 65536])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--tiny", action="store_true", help="2 layers of 2 heads of 16: a CPU "
                    "rehearsal")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
    for n in args.ranks:
        if any(length % n for length in args.lengths):
            raise ValueError(f"every length must divide by the {n} ranks: {args.lengths}")
    card = card_name() if args.device == "cuda" else None
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    for n in args.ranks:
        for row in run(n, args.device, backend, lengths=args.lengths, tiny=args.tiny):
            print(json.dumps(dict(row, tiny=args.tiny, card=card, backend=backend)), flush=True)


if __name__ == "__main__":
    main()
