"""Best-first proof search.

Semantics parity with `reference/prover/proof_search.py:40-303`,
decoupled from Lean through the :class:`Environment` protocol:

- expand the max-cumulative-logprob open node; beam-generate
  ``num_sampled_tactics`` candidates; run them in the environment in
  descending-logprob order, stopping at the first ``ProofFinished``
  (`proof_search.py:195-201`);
- dedup result nodes by response (`proof_search.py:249-252`);
- on hitting the wall-clock or expansion budget, the root status is
  force-reset to OPEN **even if just proved** — a deliberate behavioral
  quirk preserved from `proof_search.py:153-161`;
- an environment crash mid-search keeps the partial tree
  (`proof_search.py:110-112`); an init failure discards the theorem
  (returns None, `proof_search.py:132-134`);
- ``actor_time`` / ``environment_time`` split carried in
  :class:`SearchResult` (`proof_search.py:40-53`) — the key schedulability
  signal for the shared TPU service (SURVEY.md §5).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from reprover_tpu_torch.data import Pos
from reprover_tpu_torch.prover.environment import (
    Environment,
    EnvironmentCrashError,
    EnvironmentInitError,
    EnvironmentTimeoutError,
    ProofFinished,
    Session,
    TacticResult,
    TacticState,
    Theorem,
)
from reprover_tpu_torch.prover.search_tree import (
    Edge,
    ErrorNode,
    InternalNode,
    Node,
    ProofFinishedNode,
    Status,
    node_for_result,
)
from reprover_tpu_torch.prover.tactic_generator import TacticGenerator

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class SearchResult:
    """Outcome + statistics of one proof search (`proof_search.py:40-53`)."""

    theorem: Theorem
    status: Status
    proof: Optional[List[str]]
    actor_time: float
    environment_time: float
    total_time: float
    num_total_nodes: int
    num_searched_nodes: int


class BestFirstSearchProver:
    """Best-first search driven by a tactic generator."""

    def __init__(
        self,
        tac_gen: TacticGenerator,
        environment: Environment,
        timeout: float,
        max_expansions: Optional[int],
        num_sampled_tactics: int,
        debug: bool = False,
    ) -> None:
        self.tac_gen = tac_gen
        self.tac_gen.initialize()
        self.environment = environment
        self.timeout = timeout
        self.max_expansions = max_expansions
        self.num_sampled_tactics = num_sampled_tactics
        self.debug = debug

        self.num_expansions = 0
        self.actor_time = 0.0
        self.environment_time = 0.0
        self.total_time = 0.0

    def search(self, theorem: Theorem, pos: Pos) -> Optional[SearchResult]:
        logger.info("Proving %s", theorem.full_name)
        self.theorem = theorem
        self.position = Pos.of(pos)
        self.actor_time = 0.0
        self.environment_time = 0.0
        self.num_expansions = 0

        try:
            with self.environment.enter(theorem) as (session, init_state):
                self.session: Session = session
                self.root = InternalNode(init_state, cumulative_logprob=0.0)
                self.nodes: Dict[TacticResult, Node] = {init_state: self.root}
                try:
                    asyncio.run(self._search_loop())
                except EnvironmentCrashError as ex:
                    # Keep the partial tree (`proof_search.py:110-112`).
                    logger.warning(
                        "environment crashed (%s) proving %s", ex, theorem.full_name
                    )

            proof = None
            if self.root.status == Status.PROVED:
                edges = self.root.extract_proof()
                assert edges is not None
                proof = [e.tactic for e in edges]

            result = SearchResult(
                theorem=theorem,
                status=self.root.status,
                proof=proof,
                actor_time=self.actor_time,
                environment_time=self.environment_time,
                total_time=self.total_time,
                num_total_nodes=len(self.nodes),
                num_searched_nodes=self.num_expansions,
            )
            logger.info("%s", result)
            return result
        except EnvironmentInitError as ex:
            # Theorem discarded — excluded from the Pass@1 denominator
            # (`proof_search.py:132-134`, `prover/evaluate.py:148-149`).
            logger.warning("init error for %s: %s", theorem.full_name, ex)
            return None

    async def _search_loop(self) -> None:
        t_start = time.monotonic()
        queue: asyncio.PriorityQueue = asyncio.PriorityQueue()
        # Tie-break counter keeps heap comparisons off node internals when
        # priorities are equal.
        self._tick = 0
        queue.put_nowait((-self.root.priority, self._tick, self.root))

        while True:
            if queue.empty():
                logger.info("ran out of nodes to search")
                break
            try:
                await self._step(queue)
            except EnvironmentTimeoutError:
                assert time.monotonic() - t_start >= self.timeout

            self.total_time = time.monotonic() - t_start
            if self.total_time > self.timeout or (
                self.max_expansions is not None
                and self.num_expansions > self.max_expansions
            ):
                # Resource-limit quirk preserved from the reference
                # (`proof_search.py:153-161`): the root is reset to OPEN
                # even if a proof was just found.
                if self.root.status == Status.PROVED:
                    logger.info("found a proof (at the resource limit)")
                self.root.status = Status.OPEN
                logger.info("hit the resource limit")
                break
            if self.root.status == Status.FAILED:
                logger.info("failed early")
                break
            if self.root.status == Status.PROVED:
                logger.info("found a proof!")
                break

    async def _step(self, queue: asyncio.PriorityQueue) -> None:
        try:
            _, _, node = queue.get_nowait()
        except asyncio.QueueEmpty:
            return

        suggestions = await self._generate_tactics(node.state.pp)

        edges: List[Edge] = []
        for tactic, logprob in suggestions:
            edge, finished = self._run_tactic(node, tactic, logprob, queue)
            edges.append(edge)
            if finished:
                # First ProofFinished wins; skip lower-scored candidates
                # (`proof_search.py:195-201`).
                break

        node.out_edges = edges  # explore event: triggers status recompute
        self.num_expansions += 1
        queue.task_done()

        if self.debug:
            assert self.num_expansions == sum(
                n.is_explored
                for n in self.nodes.values()
                if isinstance(n, InternalNode)
            )
            self.check_invariants()

    async def _generate_tactics(self, state_pp: str) -> List[Tuple[str, float]]:
        t0 = time.monotonic()
        suggestions = await self.tac_gen.generate(
            state=state_pp,
            file_path=self.theorem.file_path,
            theorem_full_name=self.theorem.full_name,
            theorem_pos=self.position,
            num_samples=self.num_sampled_tactics,
        )
        self.actor_time += time.monotonic() - t0
        return suggestions

    def _run_tactic(
        self,
        node: InternalNode,
        tactic: str,
        logprob: float,
        queue: asyncio.PriorityQueue,
    ) -> Tuple[Edge, bool]:
        t0 = time.monotonic()
        response = self.session.run_tac(node.state, tactic)
        self.environment_time += time.monotonic() - t0

        known = response in self.nodes
        result_node = node_for_result(response, self.nodes, node, logprob)
        if not known and result_node.status == Status.OPEN:
            assert isinstance(result_node, InternalNode)
            self._tick += 1
            queue.put_nowait((-result_node.priority, self._tick, result_node))

        edge = Edge(tactic=tactic, src=node, dst=result_node)
        if isinstance(result_node, InternalNode):
            result_node.in_edges.append(edge)
        return edge, isinstance(response, ProofFinished)

    # -- debug -------------------------------------------------------- #

    def check_invariants(self) -> None:
        """Whole-tree consistency suite (`proof_search.py:288-303`)."""
        from reprover_tpu_torch.prover.environment import ERROR_RESULT_TYPES

        for response, node in self.nodes.items():
            if isinstance(response, ProofFinished):
                assert isinstance(node, ProofFinishedNode)
                assert self.root.status == Status.PROVED
            elif type(response) in ERROR_RESULT_TYPES:
                assert isinstance(node, ErrorNode)
            else:
                assert isinstance(node, InternalNode)
                node.check_invariants()
