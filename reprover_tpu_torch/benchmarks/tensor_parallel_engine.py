"""Tensor-parallel streaming engines on 1, 2 or 4 ranks: the admission wave
and ms per step.

    python -m reprover_tpu_torch.benchmarks.tensor_parallel_engine [--model llama7b|byt5]
        [--bits 4|8|16] [--tp 1 2 4] [--layers 32] [--chunks 4] [--chunk 8]
        [--backend nccl|gloo] [--device cuda]

For each degree in ``--tp`` it spawns that many ranks (one per card; ranks
beyond the cards share them, gloo only) on a ``(1, tp)`` mesh. Every rank
makes the same seeded random weights on its card (LLaMA-7B width at
``--layers`` depth, one layer at a time, quantized to ``--bits`` or bf16 at
16; byt5-small in bf16), the engine keeps its Megatron part, and the first
rank drives the engine while the others follow its calls: a warm-up wave
and chunk (the first collectives set up the communicators), a reset, then
the timed admission wave of random prompts (LLaMA-7B: 4 slots x 8 beams,
prompts 512, decode 129; byt5-small: 2 slots x 64 beams, 2048 -> 512
bytes), ``--chunks`` chunks of ``--chunk`` steps, and one chunk under
``torch.profiler``. Rank 0 prints one JSON line per degree: the admission
wave's ms and the ms per step (host clock, synchronized), the device-busy
share of the profiled chunk (its device time over the unprofiled wall of
as many steps; the all-reduces' kernels count as busy), its top kernels
and host operators, each rank's weight bytes, peak GiB and kernel
launches, the quantized products' routes, and the card's name and power
limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from reprover_tpu_torch.benchmarks.data_parallel_step import card_name
from reprover_tpu_torch.parallel.mesh import init_distributed, make_mesh

SEED = 0
GEOMETRY = {"llama7b": dict(num_slots=4, num_beams=8, src=512, dec=129),
            "byt5": dict(num_slots=2, num_beams=64, src=2048, dec=512)}


def launch_counts() -> Dict[str, int]:
    """Launches by kernel in this process (the port's wrappers' counts)."""
    from reprover_tpu_torch.ops import beam_reorder, flash_attention, quant_matmul

    return {**flash_attention.KERNEL_LAUNCHES, **beam_reorder.KERNEL_LAUNCHES,
            **quant_matmul.KERNEL_LAUNCHES,
            **{f"body_{k}": v for k, v in quant_matmul.BODY_LAUNCHES.items()}}


def reset_launch_counts() -> None:
    from reprover_tpu_torch.ops import beam_reorder, flash_attention, quant_matmul

    for mod in (flash_attention, beam_reorder, quant_matmul):
        mod.reset_launch_counts()


def make_engine(model: str, bits: int, layers: int, chunk: int, mesh: Any,
                device: torch.device) -> Any:
    """The seeded model's streaming engine over ``mesh`` (reorder
    ``gather``, kernel 13), at :data:`GEOMETRY`."""
    g = GEOMETRY[model]
    if model == "llama7b":
        from reprover_tpu_torch.generation.causal_engine import CausalStepwiseEngine
        from reprover_tpu_torch.models.causal_lm import CausalLMConfig, init_serving_params

        cfg = CausalLMConfig(num_layers=layers, compute_dtype=torch.bfloat16)
        params = init_serving_params(cfg, SEED, device, bits=bits if bits < 16 else None)
        return CausalStepwiseEngine(params, cfg, g["num_slots"], g["num_beams"], g["src"],
                                    g["dec"], chunk_size=chunk, mesh=mesh,
                                    reorder_mode="gather")
    from reprover_tpu_torch.generation.engine import StepwiseBeamEngine
    from reprover_tpu_torch.models.t5 import byt5_small, fuse_mlp_params, init_params, place_params

    cfg = byt5_small(compute_dtype=torch.bfloat16)
    params = place_params(fuse_mlp_params(init_params(cfg, torch.Generator().manual_seed(SEED))),
                          cfg, device)
    return StepwiseBeamEngine(params, cfg, g["num_slots"], g["num_beams"], g["src"], g["dec"],
                              chunk_size=chunk, mesh=mesh, reorder_mode="gather",
                              quantize={4: "int4", 8: "int8"}.get(bits, False))


def wave(model: str) -> Any:
    """The admission wave: random ids (all real) for every slot."""
    g = GEOMETRY[model]
    rng = np.random.default_rng(SEED)
    vocab = 32000 if model == "llama7b" else 259
    ids = rng.integers(3, vocab, (g["num_slots"], g["src"]))
    return ids, np.ones_like(ids)


def drive(engine: Any, model: str, chunks: int, chunk: int, device: torch.device) -> Dict[str, Any]:
    """The leader's timed calls: the admission wave, ``chunks`` chunks and
    a profiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ids, mask = wave(model)
    engine.admit_batch_tokens(list(range(ids.shape[0])), ids, mask)
    engine.dispatch_run(chunk)
    engine.reset()
    sync()
    t0 = time.perf_counter()
    engine.admit_batch_tokens(list(range(ids.shape[0])), ids, mask)
    sync()
    admit_ms = 1e3 * (time.perf_counter() - t0)
    steps, t0 = 0, time.perf_counter()
    for _ in range(chunks):
        steps += engine.unpack_status(engine.dispatch_run(chunk))[3]
    sync()
    row: Dict[str, Any] = dict(admit_ms=admit_ms, steps=steps,
                               ms_per_step=1e3 * (time.perf_counter() - t0) / max(steps, 1))
    if device.type == "cuda":
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            n = engine.unpack_status(engine.dispatch_run(chunk))[3]
            sync()
        by_name: Dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        device_ms = sum(by_name.values()) / 1e3
        host = sorted(((e.key, e.self_cpu_time_total) for e in prof.key_averages()),
                      key=lambda kv: -kv[1])[:8]
        row.update(profiled_steps=n, device_ms_per_step=device_ms / n if n else None,
                   device_busy_share=device_ms / (row["ms_per_step"] * n) if n else None,
                   top_kernels_ms={k[:60]: us / 1e3 for k, us in
                                   sorted(by_name.items(), key=lambda kv: -kv[1])[:8]},
                   top_host_self_ms_per_step={k[:60]: us / 1e3 / max(n, 1) for k, us in host})
    return row


def run_rank(model: str, bits: int, layers: int, chunks: int, chunk: int, mesh: Any,
             device: torch.device) -> Dict[str, Any]:
    """This rank's part: the engine, driven (the leader) or followed."""
    from reprover_tpu_torch.models.quantize import routing_report, weight_bytes

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    engine = make_engine(model, bits, layers, chunk, mesh, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    g = GEOMETRY[model]
    layered = engine.params["layers"] if model == "llama7b" else engine.params["decoder"]["layers"]
    report: Dict[str, Any] = dict(
        coords=list(mesh.coords), weight_bytes=weight_bytes(engine.params),
        cache_shape=list((engine.state.dec_k if model == "llama7b" else engine.state.self_k).shape),
        routes_decode=routing_report({"layers": layered, "lm_head": engine.params["lm_head"]},
                                     g["num_slots"] * g["num_beams"], torch.bfloat16, device))
    reset_launch_counts()
    if mesh.is_leader:
        try:
            report.update(drive(engine, model, chunks, chunk, device))
        finally:
            engine.release_followers()
    else:
        engine.follow()
    report["launches"] = {k: n for k, n in launch_counts().items() if n}
    if device.type == "cuda":
        report["peak_GiB"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return report


def _rank_main(rank: int, n: int, init_method: str, device: str, backend: Optional[str],
               args: Dict[str, Any], out_dir: str) -> None:
    init_distributed(device, backend=backend, init_method=init_method, rank=rank, world_size=n)
    import torch.distributed as dist

    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
               else torch.device("cpu"))
        report = run_rank(mesh=make_mesh(data=1, model=n), device=dev, **args)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def run(tp: int, device: str = "cuda", backend: Optional[str] = None,
        **args: Any) -> Dict[str, Any]:
    """Spawn ``tp`` ranks and drive the engine -> rank 0's report with every
    rank's weight bytes, peak GiB and launches."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="reprover_tp_engine_") as tmp:
        mp.spawn(_rank_main, args=(tp, "file://" + os.path.join(tmp, "store"), device, backend,
                                   args, tmp), nprocs=tp, join=True)
        reports = []
        for r in range(tp):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    out = dict(tp=tp, **args, **reports[0])
    for key in ("weight_bytes", "peak_GiB", "launches"):
        out[f"{key}_per_rank"] = [r.get(key) for r in reports]
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama7b", choices=tuple(GEOMETRY))
    ap.add_argument("--bits", type=int, default=4, choices=(4, 8, 16))
    ap.add_argument("--tp", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--layers", type=int, default=32, help="LLaMA-7B depth (of 32)")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
    card = card_name() if args.device == "cuda" else None
    for tp in args.tp:
        report = run(tp, args.device, args.backend, model=args.model, bits=args.bits,
                     layers=args.layers, chunks=args.chunks, chunk=args.chunk)
        report.update(card=card, backend=args.backend or ("nccl" if args.device == "cuda"
                                                          else "gloo"))
        print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
