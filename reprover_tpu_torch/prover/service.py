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
search waits seconds on ``run_tac``. :class:`StreamingInferenceService`
batches at token granularity instead, through the generator's stepwise
engine (:mod:`reprover_tpu_torch.generation.engine`).

Retrieval-augmented mode keeps the retriever on the same device: the service
embeds the query state, runs the masked cosine top-k, packs premises with
``format_augmented_state``, then generates — one process, zero host<->host
hops (the reference ships state across Ray actors instead).
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import multiprocessing as mp
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from reprover_tpu_torch.data import Pos

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
        # Set by :meth:`quiesced`; the serving loop answers with ``_held``
        # once it has no device work in flight, and dispatches none until
        # ``_hold`` clears.
        self._hold = threading.Event()
        self._held = threading.Event()

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

    @contextlib.contextmanager
    def quiesced(self, timeout_s: float = 120.0) -> Iterator[None]:
        """Inside the block the serving loop has no device work in flight
        and dispatches none; requests keep queueing and are served after
        it. For starting and stopping a device profiler, whose activity
        buffers are not safe to switch while other threads launch work.
        Requests of another beam width than a streaming engine's are served
        on a side thread that this does not hold."""
        self._held.clear()
        self._hold.set()
        try:
            if not self._held.wait(timeout_s):
                raise TimeoutError(f"the serving loop did not go quiet in {timeout_s} s")
            yield
        finally:
            self._hold.clear()

    def _holding(self) -> bool:
        """At a point of the serving loop with nothing in flight: whether
        :meth:`quiesced` holds it (then it says so and idles briefly)."""
        if not self._hold.is_set():
            return False
        self._held.set()
        time.sleep(0.005)
        return True

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
            if self._holding():
                continue
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
    """Token-level continuous batching (the full vLLM role).

    Replaces the request-coalescing `_serve` loop with the generator's
    stepwise engine (:class:`~reprover_tpu_torch.generation.engine.StepwiseBeamEngine`
    or the decoder-only ``CausalStepwiseEngine``): requests
    join the running decode at chunk boundaries (``chunk_size`` tokens), so
    a request arriving mid-decode waits ~chunk_size steps instead of a full
    beam decode, and up to ``num_slots`` searches decode simultaneously.

    Requests whose ``num_samples`` differs from the engine's beam width fall
    back to the classic one-shot path (the prover uses one width,
    `reference/prover/evaluate.py:218`).

    Under a tensor-parallel ``mesh`` the service runs on the grid's first
    rank as it runs on one card, and its engine sends each state-changing
    call to the other ranks, which follow it
    (:func:`serve_tensor_parallel` starts either side); :meth:`stop`
    releases them.
    """

    def __init__(
        self,
        generator: Any,
        retriever: Any = None,
        max_num_retrieved: int = 100,
        num_slots: int = 8,
        num_beams: int = 64,
        chunk_size: int = 8,
        chunk_burst: int = 4,
        pipeline_depth: int = 4,
        mesh: Any = None,
        step_buckets: Any = None,
        quantize: "bool | str" = False,
        reorder_mode: str = "auto",
    ) -> None:
        super().__init__(generator, retriever, max_num_retrieved)
        # Weight-only int8 engine weights (near-lossless; halves the decode
        # weight stream; "int4" quarters it).
        self.quantize = quantize
        # Cache-reorder strategy (see StepwiseEngineBase): "auto" resolves
        # to the one-hot einsum or the layer-blocked in-place "scan" by cache
        # size; "gather" is the hand-written kernel.
        self.reorder_mode = reorder_mode
        self.num_slots = num_slots
        self.num_beams = num_beams
        self.chunk_size = chunk_size
        # Length-bucketed stepping (see StepwiseEngineBase.step_buckets):
        # per-beam cache reorder/attention traffic scales with the deepest
        # working slot's decode depth instead of max_decode_len.
        self.step_buckets = step_buckets
        # Tensor-parallel serving: the engine is sharded over the mesh's
        # `model` axis and this rank leads the others (serve_tensor_parallel).
        self.mesh = mesh
        # Step horizon per dispatch while every slot is occupied:
        # chunk_size * chunk_burst decoder steps (the device stops early the
        # moment a slot newly finishes). Once any slot is free the horizon
        # drops to chunk_size so an arrival waits at most that many steps
        # before it can be admitted into the free slot.
        self.chunk_burst = max(1, chunk_burst)
        # Chunks dispatched ahead of the status being retired. A chunk here
        # runs to its end before dispatch_run returns (one device flag per
        # step), so only the status copy itself overlaps.
        self.pipeline_depth = max(1, pipeline_depth)
        self._engine = None  # built lazily on the serving thread
        self.stats.update(
            {
                "chunks": 0,
                "steps": 0,
                "admissions": 0,
                "fallbacks": 0,
                "loops": 0,
                # Slot utilization: host-side occupancy sampled at each run
                # dispatch (slot_busy / slot_cap = mean fraction of engine
                # slots decoding; occupancy can change within a horizon, so
                # this is the dispatch-time approximation).
                "slot_busy": 0.0,
                "slot_cap": 0.0,
                "admit_wait": 0.0,
                "status_time": 0.0,
                "admit_time": 0.0,
                "admit_tok_time": 0.0,
                "admit_dispatch_time": 0.0,
                "emit_time": 0.0,
            }
        )

    @property
    def engine(self) -> Any:
        """The stepwise engine (None until the service has built it)."""
        return self._engine

    def stop(self) -> None:
        super().stop()
        if self._engine is not None:
            self._engine.release_followers()

    def _build_engine(self) -> Any:
        # Model-agnostic: the generator wrapper (T5 seq2seq OR decoder-only
        # causal LM) builds its own engine family and owns tokenization.
        self._engine = self.generator.make_stepwise_engine(
            self.num_slots, self.num_beams, chunk_size=self.chunk_size,
            mesh=self.mesh, step_buckets=self.step_buckets,
            quantize=self.quantize, reorder_mode=self.reorder_mode,
        )

    def _admit_wave(self, slots: List[int], states: List[str]) -> None:
        """Tokenize an arrival wave padded to the engine's source bucket and
        admit it in ONE device dispatch (encode/prefill + scatter fused in
        ``admit_batch_tokens``). The batch is padded to a power-of-2 bucket
        with slot = -1 no-op rows, so one compiled program per bucket
        serves every arrival count."""
        gen = self.generator
        t0 = time.monotonic()
        bucket = _batch_buckets(len(states), self.num_slots)
        padded_states = states + [""] * (bucket - len(states))
        padded_slots = list(slots) + [-1] * (bucket - len(slots))
        ids, mask = gen.tokenize_for_engine(padded_states)
        t1 = time.monotonic()
        self._engine.admit_batch_tokens(padded_slots, ids, mask)
        t2 = time.monotonic()
        self.stats["admit_tok_time"] += t1 - t0
        self.stats["admit_dispatch_time"] += t2 - t1

    def _emit(self, slot: int, handle: Any) -> None:
        seqs, scores, lens = self._engine.finalize_prefetched(slot, handle)
        req = self._slot_req.pop(slot)
        cands = self.generator.decode_candidates(seqs, scores, lens)
        self._response_qs[req.client_id].put(GenerateResponse(req.req_id, cands))
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["last_resp_ts"] = time.monotonic()

    def _serve(self) -> None:
        """Crash containment around the serving loop: an unexpected error
        fails every outstanding request (instead of hanging their clients
        until timeout), resets the engine to a blank state, and keeps
        serving — arrivals still queued are preserved."""
        self._build_engine()
        self._slot_req: Dict[int, GenerateRequest] = {}
        self._backlog: List[GenerateRequest] = []
        while not self._stop.is_set():
            try:
                self._serve_inner()
            except Exception as ex:
                for req in list(self._slot_req.values()):
                    self._response_qs[req.client_id].put(
                        GenerateResponse(req.req_id, [], error=repr(ex))
                    )
                self._slot_req.clear()
                self._engine.reset()

    def _serve_inner(self) -> None:
        """Event-driven serving loop.

        The device conversation is fully asynchronous: the serve thread
        (sole owner of the engine) dispatches run programs, admissions, and
        finalize gathers without ever blocking on the device. All blocking
        host fetches happen on a *reaper* thread that resolves device
        handles in FIFO order and feeds one event queue; a forwarder thread
        funnels client arrivals into the same queue. The serve thread
        therefore reacts to whichever happens first — a new request, a
        retired status, or a landed finalize — instead of serializing a
        fixed phase order around blocking fetches (which left the device
        idle and workers starved of responses)."""
        import queue as _q

        import numpy as np

        eng = self._engine
        S = self.num_slots
        T = eng.max_decode_len
        backlog = self._backlog
        events: Any = _q.Queue()  # ("req", r) | ("status", seq, arr) | ("fin", slot, arrs)
        # One reap queue per kind: a finalize fetch (waits on copies queued
        # behind dispatched compute) must not head-of-line-block status
        # fetches, which pace the dispatch pipeline — and vice versa.
        status_q: Any = _q.Queue()
        fin_q: Any = _q.Queue()
        # Helper threads stop on session stop OR this invocation's teardown
        # (crash containment re-enters with fresh queues — stale threads
        # must not keep consuming the client request queue).
        inner_stop = threading.Event()
        stop = self._stop

        def halted() -> bool:
            return stop.is_set() or inner_stop.is_set()

        def forwarder() -> None:
            while not halted():
                try:
                    events.put(("req", self.request_q.get(timeout=0.1)))
                except _q.Empty:
                    continue

        # Non-engine-width requests run the classic one-shot path on this
        # side thread (CUDA launches are thread-safe): a stray width must not
        # stall admissions/status retirement/emits for a full decode — or
        # minutes, if it triggers a fresh compile.
        fallback_q: Any = _q.Queue()

        def fallback_worker() -> None:
            while not halted():
                try:
                    req = fallback_q.get(timeout=0.1)
                except _q.Empty:
                    continue
                try:
                    self._serve_group([req], req.num_samples)
                except Exception as ex:  # containment per request
                    self._response_qs[req.client_id].put(
                        GenerateResponse(req.req_id, [], error=repr(ex))
                    )

        def reaper(kind: str, q: Any, stat: str) -> None:
            while not halted():
                try:
                    key, handles = q.get(timeout=0.1)
                except _q.Empty:
                    continue
                t0 = time.monotonic()
                try:
                    host = tuple(np.asarray(a) for a in handles)
                except Exception as ex:  # device/transfer faults surface
                    # at the consuming fetch — forward to the serve thread
                    # so its crash containment runs instead of this thread
                    # dying silently and wedging the pipeline.
                    events.put(("error", key, ex))
                    continue
                # Reaper threads RMW their stat concurrently with the serve
                # thread's dict writes; guard so increments aren't dropped.
                with self._stats_lock:
                    self.stats[stat] += time.monotonic() - t0
                events.put((kind, key, host))

        threads = [
            threading.Thread(target=forwarder, daemon=True),
            threading.Thread(
                target=reaper, args=("status", status_q, "status_time"),
                daemon=True,
            ),
            threading.Thread(
                target=reaper, args=("fin", fin_q, "emit_time"), daemon=True
            ),
            threading.Thread(target=fallback_worker, daemon=True),
        ]
        for t in threads:
            t.start()

        # Host-authoritative slot bookkeeping: statuses are stale by
        # construction, so occupancy lives here and the device is only
        # consulted for *finish* events.
        occupied = np.zeros(S, dtype=bool)
        awaiting_fin = set()  # slots freed on device, response not yet sent
        # Slots emitted from a ride-along payload, not yet cleared on
        # device — the next dispatch carries this mask so the device state
        # stays truthful without a dedicated free dispatch.
        pending_release = np.zeros(S, dtype=bool)
        barrier = [0] * S  # first dispatch seq that can see this admission
        in_flight = 0  # statuses dispatched, not yet back through events
        seq = 0

        try:
            while not stop.is_set():
                self.stats["loops"] += 1
                # 1. Wait for the next event; then drain everything ready.
                try:
                    batch = [events.get(timeout=0.05)]
                except _q.Empty:
                    batch = []
                try:
                    while True:
                        batch.append(events.get_nowait())
                except _q.Empty:
                    pass

                fault: Optional[BaseException] = None
                for kind, *payload in batch:
                    if kind == "error":
                        # Reaper-forwarded device fault: raise AFTER the
                        # batch so sibling "req" events land in the backlog
                        # (crash containment preserves it).
                        fault = payload[1]
                        continue
                    if kind == "req":
                        (req,) = payload
                        req._arrived = time.monotonic()  # admission-wait t0
                        self.stats.setdefault(
                            "first_req_ts", time.monotonic()
                        )
                        if req.num_samples != self.num_beams:
                            with self._stats_lock:
                                self.stats["fallbacks"] += 1
                            fallback_q.put(req)
                        else:
                            backlog.append(req)
                    elif kind == "status":
                        psq, (arr,) = payload
                        in_flight -= 1
                        _, done_d, n_d, steps, f, fin_handle = (
                            eng.unpack_status(arr)
                        )
                        self.stats["steps"] += steps
                        for s in range(S):
                            if not (
                                occupied[s]
                                and s not in awaiting_fin
                                and psq >= barrier[s]
                                and (done_d[s] or n_d[s] >= T)
                            ):
                                continue
                            if s == f:
                                # The finish event's finalize payload rode
                                # along with this status — respond now,
                                # zero extra round trips.
                                self._emit(s, fin_handle)
                                occupied[s] = False
                                pending_release[s] = True
                            else:
                                # Simultaneous multi-finish (or a finish
                                # first seen via a later status): fall back
                                # to the gather dispatch.
                                awaiting_fin.add(s)
                                fin_q.put((s, eng.prefetch_finalize(s)))
                    else:  # "fin" — host copies landed, respond + free
                        slot, host = payload
                        self._emit(slot, host)
                        occupied[slot] = False
                        awaiting_fin.discard(slot)

                if fault is not None:
                    raise fault
                # Held: dispatch nothing, and go quiet once the statuses and
                # finalize copies in flight have come back.
                if self._hold.is_set():
                    if in_flight == 0 and not awaiting_fin:
                        self._holding()
                    continue

                # 2. Admit a wave into free slots (one fused dispatch).
                free = [s for s in range(S) if not occupied[s]]
                if backlog and free:
                    t0 = time.monotonic()
                    admissible = backlog[: len(free)]
                    del backlog[: len(free)]
                    try:
                        states = (
                            self._augment(admissible)
                            if self.retriever is not None
                            else [r.state for r in admissible]
                        )
                        slots = free[: len(admissible)]
                        self._admit_wave(slots, states)
                        now = time.monotonic()
                        for req, slot in zip(admissible, slots):
                            self._slot_req[slot] = req
                            occupied[slot] = True
                            # The admit dispatch re-arms the slot; a later
                            # release would wipe the fresh admission.
                            pending_release[slot] = False
                            barrier[slot] = seq
                            self.stats["admissions"] += 1
                            # Queueing delay arrival -> slot (admission
                            # latency; mean = admit_wait / admissions).
                            self.stats["admit_wait"] += now - getattr(
                                req, "_arrived", now
                            )
                    except Exception as ex:
                        for req in admissible:
                            self._response_qs[req.client_id].put(
                                GenerateResponse(req.req_id, [], error=repr(ex))
                            )
                    self.stats["admit_time"] += time.monotonic() - t0

                # 3. Keep run programs in flight for the decoding slots.
                #    A short horizon only pays when a free slot means an
                #    arrival could be admitted soon; with every slot busy,
                #    the finish events that end a run early are what free
                #    slots, so run long and save round trips.
                decoding = any(
                    occupied[s] and s not in awaiting_fin for s in range(S)
                )
                slot_free = not all(occupied)
                while decoding and in_flight < self.pipeline_depth:
                    horizon = (
                        self.chunk_size
                        if slot_free
                        else self.chunk_size * self.chunk_burst
                    )
                    status_q.put(
                        (
                            seq,
                            (eng.dispatch_run(horizon, pending_release),),
                        )
                    )
                    pending_release = np.zeros(S, dtype=bool)
                    seq += 1
                    in_flight += 1
                    self.stats["chunks"] += 1
                    self.stats["slot_busy"] += float(
                        sum(
                            occupied[s] and s not in awaiting_fin
                            for s in range(S)
                        )
                    )
                    self.stats["slot_cap"] += float(S)
        finally:
            inner_stop.set()
            for t in threads:
                t.join(timeout=1.0)
            # Recover arrivals stranded in this invocation's event queue so
            # crash-containment reentry still serves them.
            try:
                while True:
                    kind, *payload = events.get_nowait()
                    if kind == "req":
                        backlog.append(payload[0])
            except _q.Empty:
                pass
            # Fallback requests not yet picked up re-enter via the client
            # queue (the next invocation's forwarder re-routes them; the
            # engine backlog is engine-width-only, so they can't go there).
            try:
                while True:
                    self.request_q.put(fallback_q.get_nowait())
            except _q.Empty:
                pass



def serve_tensor_parallel(generator: Any, mesh: Any, **service_kwargs: Any
                          ) -> StreamingInferenceService:
    """Tensor-parallel serving of ``generator`` over ``mesh`` (every rank of
    the grid calls this with the same arguments). The first rank gets a
    :class:`StreamingInferenceService` to start, serve and stop as on one
    card. Every other rank builds the same sharded engine, follows the
    leader's calls until the service stops, and then gets its own service
    back, never started, whose :attr:`~StreamingInferenceService.engine`
    holds the followed state. The service's keyword arguments are
    :class:`StreamingInferenceService`'s."""
    service = StreamingInferenceService(generator, mesh=mesh, **service_kwargs)
    if not mesh.is_leader:
        service._build_engine()  # the leader's engine, built from the same arguments
        service.engine.follow()
    return service


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
