"""The inference service under concurrent search load (the vLLM role
benchmark): the port's counterpart of ``benchmarks/service_load.py``, which
imports the JAX package and stays as it is.

N prover worker processes (``DistributedProver``, spawned) hammer one shared
service in this process with 64-beam generate requests through an
always-progress environment (``:41-82`` there, copied below), so each search
performs exactly ``max_expansions`` requests. ``--env-latency S`` makes every
``run_tac`` wait ``S`` seconds (+-50% deterministic jitter), a Lean-bound
search: with 64 tactics an expansion, 2.0 s is ~128 s of environment time per
expansion, during which the service serves the other searches.

Geometry matches the JAX driver: seeded random-weight byt5-small, input 512,
output 128, 64 beams; ``--llama7b`` is LLaMA-7B width (with ``--bits 4`` or
``8`` its weights are made quantized on the card, one layer at a time), 4
slots x 8 beams. The streaming service reorders the beam cache with kernel 13
(``reorder_mode="gather"``; the JAX driver leaves the engine's ``auto``).
Prints one JSON line per cell with the JAX driver's keys (``:154-176``) plus
``device_busy_share`` and ``trace_kernels`` of one profiled window
(``utils/profiling.device_trace``; ``--profile-window`` seconds, 0 for none).

Differences from the JAX driver: there is no compile pass, so ``--quick``
and ``--llama7b`` run each cell once (the kernels are built before the first
cell); ``--tp1`` serves the streaming cells through a 1 x 1 mesh, as the JAX
driver does (the tensor-parallel engine's code path on one card);
``--device`` (default ``cuda``), ``--work`` (the synthetic
benchmark's directory, default ``build/service_load`` in the checkout),
``--max-expansions`` (default 6), ``--workers N`` (one streaming cell with N
workers, 8 slots, chunk 8), ``--tiny`` (a narrow T5 for CPU checks) and
``--profile-window`` are new.

Run on the card: ``python -m reprover_tpu_torch.benchmarks.service_load
--streaming-only [--env-latency 2.0] [--llama7b --bits 4]``; on the CPU at a
tiny width (a seconds-long check): ``--device cpu --tiny --num-theorems 2
--max-expansions 2 --workers 2``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch

from reprover_tpu_torch.prover.environment import Environment, Session, TacticState

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_WORK = os.path.join(REPO, "build", "service_load")

# The JAX driver's cells: (workers, max_batch, window_ms) coalescing and
# (workers, slots, chunk) streaming (``benchmarks/service_load.py:271-288``).
COALESCING_CELLS = ((1, 8, 5.0), (4, 8, 5.0), (8, 8, 5.0), (8, 16, 15.0), (16, 16, 15.0))
QUICK_COALESCING_CELLS = ((8, 16, 15.0), (16, 16, 15.0))
STREAMING_CELLS = ((4, 4, 8), (8, 8, 8), (16, 8, 8), (16, 16, 8), (16, 8, 16))
QUICK_STREAMING_CELLS = ((16, 8, 8),)


# ------------------------------------------------------------------ #
# Always-progress environment: every tactic yields a fresh open state, so
# each search performs exactly max_expansions service requests. A replay
# environment dies after 1 expansion under a random-weight model (no
# generated tactic matches ground truth), which would measure process
# startup, not serving throughput.
# ------------------------------------------------------------------ #


class _LoadSession(Session):
    def __init__(self, latency_s: float = 0.0):
        self.latency_s = latency_s

    def run_tac(self, state: TacticState, tactic: str) -> TacticState:
        if self.latency_s > 0.0:
            # Scripted Lean-bound wait (realistic multi-second run_tac
            # latencies, not instant replay). +-50% deterministic jitter so
            # waves don't stay phase-locked.
            h = hash((state.pp, tactic)) & 0xFFFF
            time.sleep(self.latency_s * (0.5 + h / 0xFFFF))
        # Unique successor per (state, tactic): no dedup, tree keeps growing.
        return TacticState(f"{state.pp[:128]}|{hash((state.pp, tactic)) & 0xFFFF:x}")


class _LoadEnter:
    def __init__(self, theorem: Any, latency_s: float = 0.0):
        self.theorem = theorem
        self.latency_s = latency_s

    def __enter__(self) -> Any:
        return _LoadSession(self.latency_s), TacticState(f"⊢ load {self.theorem.full_name}")

    def __exit__(self, *exc: Any) -> None:
        return None


class LoadEnvironment(Environment):
    """Picklable; accepts any theorem. ``latency_s`` injects a scripted
    per-tactic Lean wait (the continuous-batching design target: the device
    stays busy on other searches during env-bound gaps)."""

    def __init__(self, latency_s: float = 0.0):
        self.latency_s = latency_s

    def enter(self, theorem: Any) -> _LoadEnter:
        return _LoadEnter(theorem, self.latency_s)


def log(**kw: Any) -> None:
    print(json.dumps(kw), flush=True)


def make_data(work: str) -> str:
    """The JAX driver's synthetic benchmark (40 files x 10 premises, 400
    theorems, <= 3 steps) under ``work``, made once; returns its split dir."""
    if not os.path.exists(os.path.join(work, "data", "corpus.jsonl")):
        subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "make_synthetic_benchmark.py"),
             "--out", os.path.join(work, "data"), "--num-files", "40",
             "--premises-per-file", "10", "--num-theorems", "400", "--max-steps", "3"],
            check=True, capture_output=True,
        )
    return os.path.join(work, "data", "random")


# ------------------------------------------------------------------ #
# One profiled window of the serving
# ------------------------------------------------------------------ #


def busy_share(trace_path: str, window_s: float) -> Dict[str, Any]:
    """The device-busy share of a Chrome trace written by ``device_trace``:
    the union of its kernels' intervals over ``window_s``, and each kernel
    name's count."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in events if e.get("cat") == "kernel")
    names: Dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return dict(device_busy_share=busy_us / 1e6 / window_s if window_s > 0 else None,
                trace_window_s=window_s, trace_kernels=names)


def _profiled_window(service: Any, device: torch.device, window_s: float, done: threading.Event
                    ) -> Dict[str, Any]:
    """On this (the main) thread, while the searches run on another: wait for
    the service's first request, profile ``window_s`` seconds of the process
    (or until ``done``), then read the trace's busy share and kernels. The
    service is held quiet while the profiler starts and while it stops; the
    window runs from the end of the first hold to the start of the second,
    once the work in flight has drained, so it covers every kernel traced."""
    from reprover_tpu_torch.utils.profiling import device_trace

    while not done.is_set() and not service.stats_snapshot().get("requests"):
        time.sleep(0.01)
    if done.is_set():
        return dict(profiler="not measured: the searches ended before the first request")
    log_dir = tempfile.mkdtemp(prefix="service_load_trace_")
    marks = []  # quiet (before start), released, quiet (before stop), released

    @contextlib.contextmanager
    def hold() -> Iterator[None]:
        with service.quiesced():
            marks.append(time.perf_counter())
            yield
        marks.append(time.perf_counter())

    try:
        with device_trace(log_dir, device, hold=hold):
            done.wait(window_s)
        return busy_share(os.path.join(log_dir, "trace.json"), marks[2] - marks[1])
    except Exception as ex:  # surfaced in the cell's line; the caller decides
        return dict(profiler=f"not measured: {ex!r}")


# ------------------------------------------------------------------ #
# Cells
# ------------------------------------------------------------------ #


def run_cell(
    model: Any, data_path: str, num_workers: int, max_batch: int, window_ms: float,
    num_theorems: int = 24, streaming: bool = False, num_slots: int = 8, chunk_size: int = 8,
    step_buckets: Optional[Sequence[int]] = None, mesh: Any = None,
    quantize: "bool | str" = False, num_beams: int = 64, env_latency_s: float = 0.0,
    max_expansions: int = 6, device: Any = "cuda", profile_window_s: float = 0.0,
) -> Dict[str, Any]:
    """One cell (``benchmarks/service_load.py:96-176``): the service, the
    searches, and the JSON line, which is also returned (with
    ``searched_nodes``, each search's expansions)."""
    from reprover_tpu_torch.prover import (
        FixedTacticGenerator,
        InferenceService,
        StreamingInferenceService,
    )
    from reprover_tpu_torch.prover.distributed import DistributedProver
    from reprover_tpu_torch.prover.evaluate import get_theorems

    if streaming:
        service = StreamingInferenceService(
            model, num_slots=num_slots, num_beams=num_beams, chunk_size=chunk_size,
            mesh=mesh, step_buckets=step_buckets, quantize=quantize, reorder_mode="gather",
        )
    else:
        service = InferenceService(model, max_batch=max_batch, batch_window_s=window_ms / 1000.0)
    traced: Dict[str, Any] = {}
    service.start()
    try:
        env = LoadEnvironment(latency_s=env_latency_s)
        theorems, positions = get_theorems(data_path, split="val")
        theorems, positions = theorems[:num_theorems], positions[:num_theorems]
        prover = DistributedProver(
            FixedTacticGenerator("unused"), env, num_workers, timeout=600,
            max_expansions=max_expansions, num_sampled_tactics=num_beams,
            make_client=service.client,
        )
        t0 = time.time()
        if profile_window_s > 0:
            # The searches on a thread of their own, the profiler on this one.
            done, outcome = threading.Event(), {}

            def search() -> None:
                try:
                    outcome["results"] = prover.search_unordered(theorems, positions)
                except BaseException as ex:  # re-raised on this thread
                    outcome["error"] = ex
                finally:
                    done.set()

            searcher = threading.Thread(target=search, daemon=True)
            searcher.start()
            traced = _profiled_window(service, torch.device(device), profile_window_s, done)
            searcher.join()
            if "error" in outcome:
                raise outcome["error"]
            results = outcome["results"]
        else:
            results = prover.search_unordered(theorems, positions)
        wall = time.time() - t0
    finally:
        service.stop()
    done = [r for r in results if r is not None]
    expansions = sum(r.num_searched_nodes for r in done)
    stats = service.stats_snapshot()
    # Serving window = first request seen -> last response sent. The raw
    # wall includes spawning the worker processes (heavy imports), which
    # is startup, not serving.
    window = stats.pop("last_resp_ts", wall) - stats.pop("first_req_ts", 0.0)
    row = dict(
        mode="streaming" if streaming else "coalescing",
        beams=num_beams,
        env_latency_s=env_latency_s,
        tp=mesh.size if mesh is not None else 0,
        quantize=quantize,
        buckets=list(step_buckets) if streaming and step_buckets else None,
        slots=num_slots if streaming else None,
        chunk=chunk_size if streaming else None,
        workers=num_workers,
        max_batch=max_batch,
        window_ms=window_ms,
        theorems=len(done),
        expansions=expansions,
        wall_s=round(wall, 1),
        expansions_per_s=round(expansions / wall, 2),
        serve_window_s=round(window, 1),
        expansions_per_s_serving=round(expansions / max(window, 1e-9), 2),
        stats={k: round(v, 3) if isinstance(v, float) else v for k, v in stats.items()},
    )
    row.update(traced)
    # The line names the window's eight most launched kernels, cut to 60
    # characters; the returned row keeps every name whole.
    top = sorted(row.get("trace_kernels", {}).items(), key=lambda kv: -kv[1])[:8]
    log(**{**row, "trace_kernels": {name[:60]: n for name, n in top}})
    row["searched_nodes"] = [r.num_searched_nodes for r in done]
    return row


# ------------------------------------------------------------------ #
# Models (seeded random weights)
# ------------------------------------------------------------------ #


class _ByteTokenizer:
    """HF-tokenizer-shaped byte mapper for the random-weight causal cell."""

    def __init__(self, vocab: int) -> None:
        self.vocab = vocab

    def __call__(self, text: str, add_special_tokens: bool = True) -> Dict[str, List[int]]:
        return {"input_ids": [3 + (b % (self.vocab - 3)) for b in text.encode()]}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return " ".join(str(i) for i in ids)


def make_model(device: Any = "cuda", causal: bool = False, llama7b: bool = False,
               bits: Optional[int] = None, tiny: bool = False, seed: int = 0) -> Any:
    """The JAX driver's models (``benchmarks/service_load.py:190-250``) on
    the port, seeded random weights on ``device``: byt5-small (bf16 on the
    card, fp32 on the CPU) at input 512 / output 128; ``causal``, a
    decoder-only model at byt5-small-comparable decode cost; ``llama7b``,
    LLaMA-7B width, its weights quantized to ``bits`` as they are made when
    ``bits`` is given. ``tiny``: a narrow T5 (d_model 64, 2 + 2 layers) for
    CPU checks."""
    from reprover_tpu_torch.models.t5 import default_dtype

    dev = torch.device(device)
    dtype = default_dtype(dev)
    if causal or llama7b:
        from reprover_tpu_torch.generation.causal_generator import CausalTacticGeneratorModel
        from reprover_tpu_torch.models.causal_lm import CausalLMConfig, init_serving_params

        if llama7b:
            cfg = CausalLMConfig(vocab_size=32000, d_model=4096, num_layers=32, num_heads=32,
                                 num_kv_heads=32, d_ff=11008, compute_dtype=dtype)
        else:
            cfg = CausalLMConfig(vocab_size=4096, d_model=1024, num_layers=8, num_heads=16,
                                 num_kv_heads=8, d_ff=2816, compute_dtype=dtype)
        params = init_serving_params(cfg, seed, dev, bits=bits if llama7b else None)
        return CausalTacticGeneratorModel(params, cfg, _ByteTokenizer(cfg.vocab_size),
                                          max_inp_seq_len=512, max_oup_seq_len=128,
                                          template="[GOAL]\n%s\n[PROOFSTEP]\n")
    from reprover_tpu_torch.generation import TacticGeneratorModel
    from reprover_tpu_torch.models.t5 import (
        T5Config, byt5_small, fuse_mlp_params, init_params, place_params,
    )

    if tiny:
        cfg = T5Config(d_model=64, d_kv=16, d_ff=128, num_heads=4, num_encoder_layers=2,
                       num_decoder_layers=2, compute_dtype=dtype)
    else:
        cfg = byt5_small(compute_dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    return TacticGeneratorModel(place_params(fuse_mlp_params(params), cfg, dev), cfg,
                                max_inp_seq_len=512, max_oup_seq_len=128)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="The inference service under concurrent search load.")
    p.add_argument("--device", default="cuda")
    p.add_argument("--work", default=DEFAULT_WORK)
    p.add_argument("--causal", action="store_true")
    p.add_argument("--llama7b", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--env-latency", type=float, default=0.0)
    p.add_argument("--bits", type=int, choices=(4, 8), default=None)
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--num-theorems", type=int, default=24)
    p.add_argument("--max-expansions", type=int, default=6)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--streaming-only", action="store_true")
    p.add_argument("--buckets", action="store_true")
    p.add_argument("--tp1", action="store_true")
    p.add_argument("--workers", type=int, default=None,
                   help="run one streaming cell with this many workers (8 slots, chunk 8)")
    p.add_argument("--profile-window", type=float, default=3.0,
                   help="seconds of each cell to profile for the device-busy share")
    return p


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card (pass --device cpu to run on the CPU)")
    mesh = None
    if args.tp1:
        from reprover_tpu_torch.parallel.mesh import local_mesh

        mesh = local_mesh()
    data = make_data(args.work)
    if device.type == "cuda":
        from reprover_tpu_torch.ops.native import load_library

        load_library()  # every kernel is built before the first cell
    model = make_model(device, args.causal, args.llama7b, args.bits if args.llama7b else None,
                       args.tiny)
    quantize = {None: args.quantize, 8: "int8", 4: "int4"}[args.bits]
    if args.llama7b:
        quantize = False  # made quantized
    common = dict(env_latency_s=args.env_latency, max_expansions=args.max_expansions,
                  num_theorems=args.num_theorems, device=device,
                  profile_window_s=args.profile_window)
    rows = []
    if args.llama7b:
        # One steady-state cell: 4 slots x 8 beams (the BASELINE serve
        # geometry), 16 workers so admission waves and the coalescer meet
        # the prefill.
        rows.append(run_cell(model, data, 16, 0, 0.0, streaming=True, num_slots=4, chunk_size=8,
                             num_beams=8, step_buckets=(32, 64, 96, 129), mesh=mesh, **common))
        return rows
    coalescing = () if args.streaming_only else (
        QUICK_COALESCING_CELLS if args.quick else COALESCING_CELLS)
    streaming = QUICK_STREAMING_CELLS if args.quick else STREAMING_CELLS
    if args.workers is not None:
        coalescing, streaming = (), ((args.workers, 8, 8),)
    for num_workers, max_batch, window_ms in coalescing:
        rows.append(run_cell(model, data, num_workers, max_batch, window_ms, **common))
    # Length-bucketed stepping: decode-depth buckets for the per-beam KV
    # caches (dec len is 128, +1 start for causal); quarters of the range.
    dec = 129 if args.causal else 128
    buckets = tuple(sorted({32, 64, 96, dec}))
    for num_workers, num_slots, chunk in streaming:
        rows.append(run_cell(model, data, num_workers, 0, 0.0, streaming=True,
                             num_slots=num_slots, chunk_size=chunk,
                             step_buckets=buckets if args.buckets else None,
                             quantize=quantize, mesh=mesh, **common))
    return rows


if __name__ == "__main__":
    main()
