"""Shared inference service: continuous batching across proof searches.

A copy of the JAX package's ``prover/service.py`` for the port. The
reference keeps its GPU busy during Lean-bound waits by sharing one vLLM
``AsyncLLMEngine`` across all Ray prover actors
(`reference/prover/proof_search.py:332-366`). Here prover *processes* do
only host work (Lean + search tree) and submit generate requests over a
multiprocessing queue to a single service that owns the card. The service
thread drains the queue, coalesces requests into padded batches, runs the
port's encoder + beam search on them and replies on per-worker queues.
Cross-search batching is what keeps the card busy while each individual
search waits seconds on ``run_tac``.

Retrieval-augmented mode keeps the retriever on the same device: the service
embeds the query state, runs the masked cosine top-k, packs premises with
``format_augmented_state``, then generates — one process, zero host<->host
hops (the reference ships state across Ray actors instead).
"""

from __future__ import annotations

import asyncio
import dataclasses
import multiprocessing as mp
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from reprover_tpu_torch.data import Pos

STREAMING_TODO = (
    "the streaming inference service is not ported yet: ROADMAP.md Queue 1 "
    "item 6 (streaming serving engine)"
)


@dataclasses.dataclass
class GenerateRequest:
    client_id: int
    req_id: int
    state: str
    file_path: str
    theorem_full_name: str
    theorem_pos: Tuple[int, int]
    num_samples: int


@dataclasses.dataclass
class GenerateResponse:
    req_id: int
    candidates: List[Tuple[str, float]]
    error: Optional[str] = None


def _batch_buckets(n: int, max_batch: int) -> int:
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return b


class InferenceService:
    """Owns the device models; serves generate requests from many provers.

    ``start()`` spawns the serving thread; ``client()`` mints picklable
    :class:`ServiceClient` handles to hand to worker processes.
    """

    def __init__(
        self,
        generator: Any,  # reprover_tpu_torch.generation.TacticGeneratorModel
        retriever: Any = None,  # Optional[reprover_tpu_torch.retrieval.PremiseRetriever]
        max_num_retrieved: int = 100,
        max_batch: int = 8,
        batch_window_s: float = 0.005,
    ) -> None:
        self.generator = generator
        self.retriever = retriever
        self.max_num_retrieved = max_num_retrieved
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s

        ctx = mp.get_context("spawn")
        self._ctx = ctx
        self.request_q: Any = ctx.Queue()
        self._response_qs: Dict[int, Any] = {}
        self._next_client = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Serving stats (observability, SURVEY.md §5): batch sizes, waits.
        self.stats: Dict[str, float] = {
            "requests": 0,
            "batches": 0,
            "batched_requests": 0,
            "device_time": 0.0,
        }
        # Guards read-modify-write stats updates made off the serve thread
        # (streaming-service reaper threads) and snapshot reads.
        self._stats_lock = threading.Lock()

    def stats_snapshot(self) -> Dict[str, float]:
        """Serving counters + derived rates (observability, SURVEY.md §5):
        mean coalesced batch size and device-time share per request."""
        with self._stats_lock:
            s = dict(self.stats)
        if s["batches"]:
            s["mean_batch_size"] = s["batched_requests"] / s["batches"]
            s["device_time_per_request"] = s["device_time"] / s["requests"]
        return s

    # -- lifecycle ---------------------------------------------------- #

    def client(self) -> "ServiceClient":
        cid = self._next_client
        self._next_client += 1
        q = self._ctx.Queue()
        self._response_qs[cid] = q
        return ServiceClient(cid, self.request_q, q)

    def start(self) -> None:
        assert self._thread is None
        if self.retriever is not None:
            # One eager reindex so queries never pay the lazy-reindex cost
            # mid-search (`retrieval/model.py:348` does this per actor).
            self.retriever.reindex_corpus(batch_size=32)
        self._stop.clear()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    # -- serving loop -------------------------------------------------- #

    def _drain(self) -> List[GenerateRequest]:
        """Collect pending requests: block briefly for the first, then sweep
        the queue for ``batch_window_s`` to coalesce concurrent searches."""
        import queue as _q

        reqs: List[GenerateRequest] = []
        try:
            reqs.append(self.request_q.get(timeout=0.05))
        except _q.Empty:
            return reqs
        deadline = time.monotonic() + self.batch_window_s
        while len(reqs) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                reqs.append(self.request_q.get(timeout=remaining))
            except _q.Empty:
                break
        return reqs

    def _serve(self) -> None:
        while not self._stop.is_set():
            reqs = self._drain()
            if not reqs:
                continue
            # Group by num_samples (beam width is a static jit arg).
            by_beams: Dict[int, List[GenerateRequest]] = {}
            for r in reqs:
                by_beams.setdefault(r.num_samples, []).append(r)
            for num_samples, group in by_beams.items():
                try:
                    self._serve_group(group, num_samples)
                except Exception as ex:  # containment: fail requests, not the service
                    for r in group:
                        self._response_qs[r.client_id].put(
                            GenerateResponse(r.req_id, [], error=repr(ex))
                        )

    def _serve_group(self, group: List[GenerateRequest], num_samples: int) -> None:
        t0 = time.monotonic()
        self.stats.setdefault("first_req_ts", t0)
        states = [r.state for r in group]
        if self.retriever is not None:
            states = self._augment(group)

        # Pad the batch to a power-of-2 bucket: one compiled program per
        # (batch-bucket, src-bucket, beams) shape, reused forever after.
        bucket = _batch_buckets(len(states), self.max_batch)
        padded = states + [""] * (bucket - len(states))
        candidates = self.generator.generate(padded, num_samples)

        # The streaming service runs this on a fallback worker thread
        # concurrently with the serve thread's stats writes — guard RMWs.
        with self._stats_lock:
            self.stats["requests"] += len(group)
            self.stats["last_resp_ts"] = time.monotonic()
            self.stats["batches"] += 1
            self.stats["batched_requests"] += len(group)
            self.stats["device_time"] += time.monotonic() - t0

        for r, cands in zip(group, candidates):
            self._response_qs[r.client_id].put(GenerateResponse(r.req_id, cands))

    def _augment(self, group: List[GenerateRequest]) -> List[str]:
        """Batched retrieve + premise packing (`tactic_generator.py:286-295`),
        one device round for the whole group."""
        from reprover_tpu_torch.data import Context, format_augmented_state, remove_marks

        contexts = [
            Context(
                r.file_path,
                r.theorem_full_name,
                Pos.of(r.theorem_pos),
                r.state,
            )
            for r in group
        ]
        premises, _ = self.retriever.retrieve_batch(contexts, self.max_num_retrieved)
        max_len = self.generator.max_inp_seq_len
        # remove_marks: match the generator's training input distribution
        # (see RetrievalAugmentedTacticGenerator.generate for the measured
        # train/search skew behind this).
        return [
            remove_marks(format_augmented_state(r.state, prems, max_len))
            for r, prems in zip(group, premises)
        ]


class StreamingInferenceService(InferenceService):
    """Token-level continuous batching (the JAX package's vLLM role) waits
    for the port's streaming engine (ROADMAP.md Queue 1 item 6): building
    one raises ``NotImplementedError``, as ``--streaming`` does."""

    def __init__(self, generator: Any, retriever: Any = None, **kwargs: Any) -> None:
        raise NotImplementedError(STREAMING_TODO)



class ServiceClient:
    """Picklable handle a prover worker uses to reach the service."""

    def __init__(
        self,
        client_id: int,
        request_q: Any,
        response_q: Any,
        timeout_s: float = 1800.0,
    ) -> None:
        self.client_id = client_id
        self.request_q = request_q
        self.response_q = response_q
        self.timeout_s = timeout_s
        self._next_req = 0

    async def agenerate(
        self,
        state: str,
        file_path: str,
        theorem_full_name: str,
        theorem_pos: Pos,
        num_samples: int,
    ) -> List[Tuple[str, float]]:
        req_id = self._next_req
        self._next_req += 1
        pos = Pos.of(theorem_pos)
        self.request_q.put(
            GenerateRequest(
                self.client_id,
                req_id,
                state,
                file_path,
                theorem_full_name,
                (pos.line_nb, pos.column_nb),
                num_samples,
            )
        )
        import functools
        import queue as _q

        loop = asyncio.get_event_loop()
        deadline = time.monotonic() + self.timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"inference service did not answer within {self.timeout_s}s"
                )
            try:
                resp: GenerateResponse = await loop.run_in_executor(
                    None,
                    functools.partial(self.response_q.get, timeout=remaining),
                )
            except _q.Empty:
                continue
            if resp.req_id != req_id:
                continue  # stale reply from a cancelled request
            if resp.error is not None:
                raise RuntimeError(f"inference service error: {resp.error}")
            return resp.candidates
