"""Closed-loop search clients on the port's streaming inference service.

Set-up makes the weights from the seed, builds the tactic generator and
warms one engine of the service's geometry at every admission width the
window can meet (1 to ``num_slots`` rows), then starts
``StreamingInferenceService`` with the cell's slots and beams and the
service's defaults for everything else. ``clients`` threads of this process
each hold a ``ServiceClient``: send a request of ``num_samples`` beams, wait
for its candidates, optionally think for a drawn time, send the next. Each
request's source is the next of a seeded pool of lengths (the mix's
``source_bytes``), its bytes drawn from the seed. The window opens once
``warm_responses`` requests have come back, so it sees the loop in its
steady state, and lasts ``seconds``; a traced run then profiles
``trace_seconds`` more under the same load.

Expansions served count each request by the share of its life, from
sending to answer, that lies in the window (:func:`served_in`); the
latencies are those of the requests answered in it.

The answers are the candidates' scores and texts. The tokens behind them
are read where the generator turns them into text (``decode_candidates``),
keyed by the scores the client got. After the window a sample of the
requests completed in it, drawn from the seed with the longest source
always in it, is scored again by the float32 reference: each candidate's
summed log-probability given its source, against the score served.
"""

from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import counts, harness, traffic, weights
from perfbench.reference import t5 as ref


@dataclasses.dataclass
class Request:
    index: int
    source: str
    sent: float
    done: float = 0.0
    scores: Optional[Tuple[float, ...]] = None
    texts: Optional[List[str]] = None
    error: Optional[str] = None


class Load:
    """The clients and what they saw."""

    def __init__(self, service: Any, mix: Dict[str, Any], seed: int, num_samples: int,
                 timeout_s: float) -> None:
        self.seed = seed
        self.num_samples = num_samples
        self.pool = traffic.lengths(mix["source_bytes"], mix["pool"], seed, stream=0)
        self.think_ms = (traffic.lengths(mix["think_ms"], mix["pool"], seed, stream=1)
                         if "think_ms" in mix else None)
        self.lock = threading.Lock()
        self.issued = 0
        self.requests: List[Request] = []
        self.stop = threading.Event()
        self.clients = [service.client() for _ in range(mix["clients"])]
        for c in self.clients:
            c.timeout_s = timeout_s
        self.threads = [threading.Thread(target=self._client, args=(c,), daemon=True)
                        for c in self.clients]

    def _next(self) -> Tuple[int, str, float]:
        with self.lock:
            i = self.issued
            self.issued += 1
        n = self.pool[i % len(self.pool)]
        think = 0.0 if self.think_ms is None else float(self.think_ms[i % len(self.pool)]) / 1e3
        return i, traffic.texts(np.array([n]), self.seed, stream=1000 + i)[0], think

    def _client(self, client: Any) -> None:
        async def loop() -> None:
            while not self.stop.is_set():
                i, source, think = self._next()
                req = Request(i, source, time.perf_counter())
                try:
                    cands = await client.agenerate(source, "Bench/Load.lean", f"Bench.t{i}",
                                                   (1, 0), self.num_samples)
                    req.scores = tuple(float(s) for _, s in cands)
                    req.texts = [t for t, _ in cands]
                except Exception as ex:  # recorded; the run counts it as failed
                    req.error = repr(ex)
                req.done = time.perf_counter()
                with self.lock:
                    self.requests.append(req)
                if think:
                    self.stop.wait(think)

        asyncio.run(loop())

    def completed(self) -> int:
        with self.lock:
            return len(self.requests)

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def join(self, timeout_s: float) -> bool:
        self.stop.set()
        deadline = time.perf_counter() + timeout_s
        for t in self.threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return not any(t.is_alive() for t in self.threads)


def served_in(requests: List[Request], t_open: float, t_close: float) -> float:
    """Requests served in ``[t_open, t_close]``: each answered request
    counts by the share of its life, from sending to answer, inside the
    window. Answers come in waves of up to a slot count, so whole answers
    counted in a fixed window move by a wave; the shares move smoothly."""
    total = 0.0
    for r in requests:
        if r.error is None and r.done > r.sent:
            inside = min(r.done, t_close) - max(r.sent, t_open)
            total += max(0.0, inside) / (r.done - r.sent)
    return total


def _generator(params: Any, cfg: Any, cell: Dict[str, Any]) -> Any:
    """The port's tactic generator, remembering the tokens of each answer
    by its scores."""
    from reprover_tpu_torch.generation import TacticGeneratorModel

    class Recording(TacticGeneratorModel):
        def decode_candidates(self, seqs: np.ndarray, scores: np.ndarray, lens: np.ndarray
                              ) -> List[Tuple[str, float]]:
            cands = super().decode_candidates(seqs, scores, lens)
            self.served[tuple(float(s) for s in scores)] = (np.array(seqs), np.array(lens))
            return cands

    model = Recording(params, cfg, max_inp_seq_len=cell["max_inp_seq_len"],
                      max_oup_seq_len=cell["max_oup_seq_len"])
    model.served = {}
    return model


def _warm(model: Any, cell: Dict[str, Any], sources: List[str]) -> None:
    """Every admission width from 1 to ``num_slots`` rows and a few steps,
    on an engine of the service's geometry, freed afterwards."""
    slots = cell["num_slots"]
    eng = model.make_stepwise_engine(slots, cell["num_beams"])
    for width in range(1, slots + 1):
        ids, mask = model.tokenize_for_engine(sources[:width])
        eng.admit_batch_tokens(list(range(width)), ids, mask)
        eng.unpack_status(eng.dispatch_run(2))
        for s in range(width):
            eng.finalize(s)
    del eng


def _decode_text(tokens: np.ndarray) -> str:
    """ByT5 text of generated ids: byte ids kept, special and extra ids
    dropped, invalid UTF-8 ignored."""
    b = bytes(int(t) - 3 for t in tokens if 3 <= int(t) < 259)
    return b.decode("utf-8", errors="ignore")


def _check(ctx: harness.Context, params: Any, model: Any, window: List[Request]
           ) -> Tuple[Dict[str, Dict[str, float]], Dict[str, float], List[str]]:
    cell, sizes = ctx.cell, ctx.sizes
    limits = cell["checks"]
    ok = [r for r in window if r.error is None]
    notes: List[str] = []
    if not ok:
        return {}, {}, ["no request completed in the window"]
    rng = traffic.rng(ctx.seed, 3)
    longest = max(range(len(ok)), key=lambda i: len(ok[i].source))
    others = [i for i in range(len(ok)) if i != longest]
    pick = [longest] + list(rng.permutation(others)[: cell["check_requests"] - 1])
    params32 = weights.to_float32(params)
    dev = torch.device(ctx.device)
    gap = ctl_gap = 0.0
    missing = mismatched = 0
    tokens = 0
    with ref.exact_matmuls():
        for i in pick:
            r = ok[i]
            found = model.served.get(r.scores)
            if found is None:
                missing += 1
                continue
            seqs, lens = found
            gen = [torch.as_tensor(seqs[k, 1: int(lens[k])], dtype=torch.long, device=dev)
                   for k in range(len(lens))]
            mismatched += sum(_decode_text(g.cpu().numpy()) != t for g, t in zip(gen, r.texts))
            tokens += sum(len(g) for g in gen)
            src = torch.tensor(harness.byte_ids(r.source, cell["max_inp_seq_len"]), device=dev)
            want = ref.sequence_logprobs(params32, sizes, src, gen, "fp32")
            served = torch.tensor(r.scores, dtype=torch.float64)
            gap = max(gap, float((served - want).abs().max()))
            if ctx.control:
                low = ref.sequence_logprobs(params32, sizes, src, gen, "fp8")
                ctl_gap = max(ctl_gap, float((low - want).abs().max()))
    notes.append(f"checked {len(pick)} requests, {tokens} served tokens; longest source "
                 f"{len(ok[longest].source)} bytes")
    checks = {
        "score_gap_nats": {"value": gap, "limit": limits["score_gap_nats"]},
        "answers_unmatched": {"value": float(missing + mismatched),
                              "limit": limits["answers_unmatched"]},
    }
    return checks, ({"score_gap_nats": ctl_gap} if ctx.control else {}), notes


def run(ctx: harness.Context) -> harness.Result:
    from reprover_tpu_torch.prover import StreamingInferenceService

    from perfbench import trace as tr

    cell, mix, sizes = ctx.cell, ctx.traffic, ctx.sizes
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    if cuda:
        from reprover_tpu_torch.ops.native import load_library

        load_library()
    params = weights.make_t5(sizes, ctx.seed, dev, dtype)
    # Random weights that put EOS near the top stop some seeds' beams early,
    # so the seed would change the decode depth; with its output column at
    # zero, every seed decodes to the cap, as the configuration assumes.
    params["lm_head"][:, cell["silent_tokens"]] = 0
    model = _generator(params, harness.port_t5_config(sizes, dtype), cell)
    warm_len = int(max(traffic.lengths(mix["source_bytes"], mix["pool"], ctx.seed)))
    _warm(model, cell, traffic.texts(np.full(cell["num_slots"], warm_len), ctx.seed, stream=999))
    model.served.clear()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    service = StreamingInferenceService(model, num_slots=cell["num_slots"],
                                        num_beams=cell["num_beams"])
    service.start()
    load = Load(service, mix, ctx.seed, cell["num_beams"], cell["drain_timeout_s"])
    traced: Dict[str, Any] = {}
    try:
        load.start()
        # A program that never answers gets its window all the same, and
        # fails the check for want of answers.
        deadline = time.perf_counter() + cell["warm_timeout_s"]
        while load.completed() < mix["warm_responses"] and time.perf_counter() < deadline:
            time.sleep(0.01)
        t_open = time.perf_counter()
        snap_open = service.stats_snapshot()
        quarters = [snap_open]
        for q in range(1, 5):
            time.sleep(max(0.0, t_open + ctx.seconds * q / 4 - time.perf_counter()))
            quarters.append(service.stats_snapshot())
        t_close = time.perf_counter()
        snap_close = quarters[-1]
        card = harness.card_state() if cuda else "cpu"
        # The profiler slows the host that paces this cell, so it records a
        # slice after the window, under the same load, and the window's own
        # numbers stay those of an untraced run.
        if ctx.trace and cuda:
            with tr.profiled(traced, hold=service.quiesced):
                time.sleep(cell["trace_seconds"])
        drained = load.join(cell["drain_timeout_s"])
    finally:
        load.stop.set()
        service.stop()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None

    window = [r for r in load.requests if t_open <= r.done <= t_close]
    failed = sum(r.error is not None for r in window) + (0 if drained else 1)
    lat = sorted(r.done - r.sent for r in window)
    s, K = sizes, cell["num_beams"]
    # Admissions are padded to the engine's source bucket.
    src = counts.padded_length(cell["max_inp_seq_len"], model.bucket_multiple,
                               cell["max_inp_seq_len"])
    w = harness.Window(seconds=t_close - t_open, setup_s=t_open - ctx.started,
                       on_card=cuda,
                       counters={"open": snap_open, "close": snap_close})
    steps, admissions = w.delta("steps") or 0.0, w.delta("admissions") or 0.0
    w.values.update(completed=len(window), latencies_s=lat,
                    expansions=served_in(load.requests, t_open, t_close))
    if cuda:
        w.values["flops"] = (
            admissions * (counts.encoder_flops(s, 1, src) + counts.cross_kv_flops(s, 1, src))
            + steps * counts.decode_step_flops(s, cell["num_slots"] * K, cell["max_oup_seq_len"],
                                               src))
    if traced.get("events"):
        w.trace = tr.reduce(traced.pop("events"))

    del service, load.clients
    if cuda:
        torch.cuda.empty_cache()
    checks, w.values["control"], notes = _check(ctx, params, model, window)
    served = [int(lens.sum() - len(lens)) for seqs, lens in model.served.values()]
    notes[:0] = [
        f"requests completed in the window: {len(window)}, median latency "
        f"{lat[len(lat) // 2] if lat else float('nan')!r} s",
        "service counters over the window: " + ", ".join(
            f"{k} {w.delta(k)!r}" for k in ("requests", "admissions", "steps", "chunks", "loops",
                                           "admit_time", "admit_tok_time", "admit_dispatch_time",
                                           "status_time", "emit_time")),
        "steps and answers in each quarter of the window: " + ", ".join(
            f"{b['steps'] - a['steps']:.0f}/{b['requests'] - a['requests']:.0f}"
            for a, b in zip(quarters, quarters[1:])),
        f"generated tokens a request (mean over all answered): "
        f"{sum(served) / max(1, len(served))!r} over {len(served)}",
        f"set-up {w.setup_s!r} s; card at the window's close: {card}"]
    return harness.Result(window=w, checks=checks, attempted=len(window), failed=failed,
                          memory_peak_bytes=peak, notes=notes)
