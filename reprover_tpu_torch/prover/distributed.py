"""Distributed proof search: a host process pool sharing one TPU service.

The reference parallelizes searches with Ray actors, each holding its own
copy of the tactic generator (or a handle to one shared vLLM engine)
(`reference/prover/proof_search.py:306-485`). Lean interaction is
CPU-subprocess work, so the TPU-native shape (SURVEY.md §2.2) is plain
``multiprocessing`` workers for the searches + one in-parent
:class:`~reprover_tpu_torch.prover.service.InferenceService` owning the device.

Fault handling improves on the reference: a dead worker re-queues its
in-flight theorem and a replacement worker is spawned (the reference calls
``sys.exit(1)``, `proof_search.py:481-483`). Per-theorem containment
(init error -> discard; crash -> keep partial tree) lives in
:class:`BestFirstSearchProver`.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import queue as _q
import time
from typing import Any, Dict, List, Optional, Tuple

from reprover_tpu_torch.data import Pos
from reprover_tpu_torch.prover.environment import Environment, Theorem
from reprover_tpu_torch.prover.proof_search import BestFirstSearchProver, SearchResult
from reprover_tpu_torch.prover.tactic_generator import TacticGenerator

logger = logging.getLogger(__name__)

_MAX_RESPAWNS = 3


def _worker_main(
    tac_gen: TacticGenerator,
    environment: Environment,
    timeout: float,
    max_expansions: Optional[int],
    num_sampled_tactics: int,
    debug: bool,
    task_q: Any,
    result_q: Any,
) -> None:
    prover = BestFirstSearchProver(
        tac_gen, environment, timeout, max_expansions, num_sampled_tactics, debug
    )
    while True:
        task = task_q.get()
        if task is None:
            break
        idx, theorem, pos = task
        result_q.put(("claim", idx, None))
        try:
            result = prover.search(theorem, pos)
            result_q.put(("done", idx, result))
        except Exception as ex:  # noqa: BLE001 — report, don't kill the pool
            logger.exception("search raised for %s", theorem.full_name)
            result_q.put(("error", idx, repr(ex)))


class DistributedProver:
    """Run proof searches across ``num_workers`` processes.

    ``tac_gen`` must be picklable *pre-initialize* (FixedTacticGenerator,
    RemoteTacticGenerator with a ServiceClient, or LocalTacticGenerator
    holding a checkpoint path); each worker calls ``initialize()`` once.
    With ``num_workers == 1`` everything runs in-process (the reference's
    Ray bypass, `proof_search.py:424-430`).
    """

    def __init__(
        self,
        tac_gen: TacticGenerator,
        environment: Environment,
        num_workers: int,
        timeout: float,
        max_expansions: Optional[int] = None,
        num_sampled_tactics: int = 64,
        debug: bool = False,
        make_client: Any = None,  # Optional: InferenceService.client per worker
    ) -> None:
        self.tac_gen = tac_gen
        self.environment = environment
        self.num_workers = num_workers
        self.timeout = timeout
        self.max_expansions = max_expansions
        self.num_sampled_tactics = num_sampled_tactics
        self.debug = debug
        self.make_client = make_client

    # -- single-process path ------------------------------------------ #

    def _search_local(
        self, theorems: List[Theorem], positions: List[Pos]
    ) -> List[Optional[SearchResult]]:
        gen = self.tac_gen
        if self.make_client is not None:
            # A shared InferenceService is authoritative even in-process:
            # single-worker runs must exercise the same serving path.
            from reprover_tpu_torch.prover.tactic_generator import RemoteTacticGenerator

            gen = RemoteTacticGenerator(self.make_client())
        prover = BestFirstSearchProver(
            gen,
            self.environment,
            self.timeout,
            self.max_expansions,
            self.num_sampled_tactics,
            self.debug,
        )
        return [prover.search(t, p) for t, p in zip(theorems, positions)]

    # -- multi-process path -------------------------------------------- #

    def search_unordered(
        self, theorems: List[Theorem], positions: List[Pos]
    ) -> List[Optional[SearchResult]]:
        """Prove ``theorems``; result order is not guaranteed
        (`proof_search.py:464-479`). ``None`` entries are discarded theorems."""
        assert len(theorems) == len(positions)
        if self.num_workers <= 1:
            return self._search_local(theorems, positions)

        ctx = mp.get_context("spawn")
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        pending: Dict[int, Tuple[Theorem, Pos]] = {
            i: (t, p) for i, (t, p) in enumerate(zip(theorems, positions))
        }
        for i, (t, p) in pending.items():
            task_q.put((i, t, p))

        def spawn() -> mp.process.BaseProcess:
            gen = self.tac_gen
            if self.make_client is not None:
                from reprover_tpu_torch.prover.tactic_generator import RemoteTacticGenerator

                gen = RemoteTacticGenerator(self.make_client())
            proc = ctx.Process(
                target=_worker_main,
                args=(
                    gen,
                    self.environment,
                    self.timeout,
                    self.max_expansions,
                    self.num_sampled_tactics,
                    self.debug,
                    task_q,
                    result_q,
                ),
                daemon=True,
            )
            proc.start()
            return proc

        workers = [spawn() for _ in range(self.num_workers)]
        claimed: Dict[int, bool] = {}
        results: List[Optional[SearchResult]] = []
        finished: set = set()
        respawns = 0
        # Watchdog: a task pulled by a worker that dies before sending its
        # "claim" event is unrecoverable by claim-requeueing; bound the
        # whole run instead of hanging.
        watchdog_s = max(3 * self.timeout, 60.0)
        last_progress = time.monotonic()

        while len(finished) < len(theorems):
            if time.monotonic() - last_progress > watchdog_s:
                logger.error(
                    "no progress for %.0fs; aborting %d unfinished theorems",
                    watchdog_s,
                    len(theorems) - len(finished),
                )
                break
            try:
                kind, idx, payload = result_q.get(timeout=1.0)
            except _q.Empty:
                # Health check: re-queue claims of dead workers.
                dead = [w for w in workers if not w.is_alive()]
                if dead:
                    workers = [w for w in workers if w.is_alive()]
                    lost = [i for i, c in claimed.items() if c and i not in finished]
                    for i in lost:
                        if respawns >= _MAX_RESPAWNS * self.num_workers:
                            logger.error("theorem %d lost to repeated worker death", i)
                            finished.add(i)
                            results.append(None)
                            continue
                        logger.warning("worker died; re-queueing theorem %d", i)
                        claimed[i] = False
                        t, p = pending[i]
                        task_q.put((i, t, p))
                    while len(workers) < self.num_workers and respawns < (
                        _MAX_RESPAWNS * self.num_workers
                    ):
                        workers.append(spawn())
                        respawns += 1
                    if not workers:
                        logger.error("all workers dead; aborting remaining theorems")
                        break
                continue

            last_progress = time.monotonic()
            if kind == "claim":
                claimed[idx] = True
            elif kind == "done":
                if idx not in finished:
                    finished.add(idx)
                    results.append(payload)
            else:  # "error"
                logger.error("search error on theorem %d: %s", idx, payload)
                if idx not in finished:
                    finished.add(idx)
                    results.append(None)

        for _ in workers:
            task_q.put(None)
        for w in workers:
            w.join(timeout=5)
            if w.is_alive():
                w.terminate()
        return results
