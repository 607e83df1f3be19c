"""Best-first proof search tree.

Semantics-parity re-implementation of the reference search tree
(`reference/prover/search_tree.py`):

- nodes hash/compare **only by proof state** (`search_tree.py:73`), so
  identical states reached along different branches collapse into one node;
- priority is cumulative logprob, max-first (`search_tree.py:176-181`);
- setting ``out_edges`` is the "explore" event and triggers recursive upward
  recomputation of status (proved if any child proved; failed iff all
  children failed, `search_tree.py:132-155`) and ``distance_to_proof``
  (`search_tree.py:161-173`);
- a PROVED/FAILED status is frozen — nothing is ever appended to out_edges;
- ``extract_proof`` follows minimum-distance edges (`search_tree.py:183-205`);
- ``check_invariants`` is the runtime consistency suite run each step in
  debug mode (`search_tree.py:211-247`).

The tree is host-side pure Python by design: search is pointer-chasing, not
math — the TPU work lives entirely in the tactic generator (SURVEY.md §7.5).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Union

from reprover_tpu_torch.prover.environment import (
    ERROR_RESULT_TYPES,
    LeanError,
    ProofFinished,
    ProofGivenUp,
    TacticResult,
    TacticState,
    TacticTimeout,
)


class Status(enum.Enum):
    PROVED = "Proved"  # at least one known proof
    FAILED = "Failed"  # exhausted: cannot be proved within this run
    OPEN = "Open"  # not yet proved or given up on


@dataclass
class ProofFinishedNode:
    """Terminal success node."""

    inner: ProofFinished
    status: Status = field(default=Status.PROVED, init=False)
    distance_to_proof: float = field(default=0.0, init=False)
    is_terminal = True


@dataclass
class ErrorNode:
    """Terminal failure node (Lean error / tactic timeout / gave up)."""

    inner: Union[LeanError, TacticTimeout, ProofGivenUp]
    status: Status = field(default=Status.FAILED, init=False)
    distance_to_proof: float = field(default=math.inf, init=False)
    is_terminal = True


class InternalNode:
    """A nonterminal proof state in the search tree.

    Identity is the state alone: ``__eq__``/``__hash__`` ignore logprob and
    edges, mirroring `search_tree.py:62-73`.
    """

    is_terminal = False

    __slots__ = (
        "state",
        "cumulative_logprob",
        "in_edges",
        "_out_edges",
        "_status",
        "_distance_to_proof",
    )

    def __init__(self, state: TacticState, cumulative_logprob: float) -> None:
        self.state = state
        self.cumulative_logprob = cumulative_logprob
        self.in_edges: List[Edge] = []
        self._out_edges: Optional[List[Edge]] = None
        self._status = Status.OPEN
        self._distance_to_proof: float = math.inf

    # -- identity --------------------------------------------------- #

    def __eq__(self, other: object) -> bool:
        return isinstance(other, InternalNode) and self.state == other.state

    def __hash__(self) -> int:
        return hash(self.state)

    # max-priority ordering for heap/priority-queue use
    # (`search_tree.py:175-181`): a < b  <=>  a has HIGHER priority.
    @property
    def priority(self) -> float:
        return self.cumulative_logprob

    def __lt__(self, other: "InternalNode") -> bool:
        return self.priority > other.priority

    def __repr__(self) -> str:
        return (
            f"InternalNode(state={self.state.pp!r}, status={self._status},"
            f" cumulative_logprob={self.cumulative_logprob})"
        )

    # -- exploration ------------------------------------------------ #

    @property
    def is_explored(self) -> bool:
        return self._out_edges is not None

    @property
    def out_edges(self) -> Optional[List["Edge"]]:
        return self._out_edges

    @out_edges.setter
    def out_edges(self, edges: Iterable["Edge"]) -> None:
        """Mark this node explored; fixed forever afterwards."""
        if self.is_explored:
            raise RuntimeError("node already explored")
        self._out_edges = list(edges)
        self._propagate_status()
        self._propagate_distance()

    # -- status ----------------------------------------------------- #

    @property
    def status(self) -> Status:
        return self._status

    @status.setter
    def status(self, s: Status) -> None:
        # Needed by the resource-limit quirk: the prover force-resets the
        # root to OPEN on timeout even if just proved
        # (`proof_search.py:153-161`).
        self._status = s

    def _propagate_status(self) -> None:
        """Recompute this node's status from children; recurse to parents on
        any change. Terminates: only OPEN nodes can change, finitely many."""
        assert self._out_edges is not None
        if self._status != Status.OPEN:  # frozen once decided
            return
        child_statuses = [e.dst.status for e in self._out_edges]
        if any(s == Status.PROVED for s in child_statuses):
            self._status = Status.PROVED
        if all(s == Status.FAILED for s in child_statuses):
            # NB: vacuously true for zero children -> FAILED, as in the
            # reference (`search_tree.py:147,222-223`).
            self._status = Status.FAILED
        if self._status != Status.OPEN:
            for e in self.in_edges:
                e.src._propagate_status()

    # -- distance ---------------------------------------------------- #

    @property
    def distance_to_proof(self) -> float:
        return self._distance_to_proof

    def _propagate_distance(self) -> None:
        if self._out_edges:
            d = min(e.distance_to_proof() for e in self._out_edges)
        else:
            d = math.inf
        if d < self._distance_to_proof:
            self._distance_to_proof = d
            for e in self.in_edges:
                e.src._propagate_distance()

    # -- proof extraction -------------------------------------------- #

    def extract_proof(self) -> Optional[List["Edge"]]:
        """Shortest known proof of this node as an edge list, or None."""
        if self._status != Status.PROVED:
            return None
        assert self.is_explored and self._out_edges is not None
        best = min(self._out_edges, key=Edge.distance_to_proof)
        if best.dst.is_terminal:
            assert isinstance(best.dst, ProofFinishedNode)
            return [best]
        assert isinstance(best.dst, InternalNode)
        rest = best.dst.extract_proof()
        assert rest is not None
        return [best, *rest]

    # -- debug -------------------------------------------------------- #

    def check_invariants(self) -> None:
        """Consistency suite (`search_tree.py:211-247`)."""
        if not self.is_explored:
            assert self.status == Status.OPEN
            return
        for e in self.in_edges:
            assert e.dst is self
        if self._out_edges == []:
            assert self.status == Status.FAILED
        else:
            assert self._out_edges is not None
            for e in self._out_edges:
                assert e.src is self
        if self.status == Status.PROVED:
            assert self._out_edges
            assert any(e.dst.status == Status.PROVED for e in self._out_edges)
            assert all(e.dst.status == Status.PROVED for e in self.in_edges)
            proof = self.extract_proof()
            assert proof is not None
            assert self.distance_to_proof == len(proof)
        elif self.status == Status.FAILED:
            assert self._out_edges is not None
            assert all(e.dst.status == Status.FAILED for e in self._out_edges)
            assert self.distance_to_proof == math.inf
            assert self.extract_proof() is None
        else:
            assert self._out_edges
            assert not any(e.dst.status == Status.PROVED for e in self._out_edges)
            assert not all(e.dst.status == Status.FAILED for e in self._out_edges)
            assert self.distance_to_proof == math.inf
            assert self.extract_proof() is None


Node = Union[ProofFinishedNode, ErrorNode, InternalNode]


@dataclass
class Edge:
    """A tactic application connecting two nodes."""

    tactic: str
    src: InternalNode = field(repr=False)
    dst: Node = field(repr=False)

    def distance_to_proof(self) -> float:
        return 1 + self.dst.distance_to_proof


def node_for_result(
    response: TacticResult,
    nodes: Dict[TacticResult, Node],
    parent: InternalNode,
    logprob: float,
) -> Node:
    """Get-or-create the node for a tactic response (dedup by response,
    `proof_search.py:249-267`)."""
    node = nodes.get(response)
    if node is None:
        if isinstance(response, ProofFinished):
            node = ProofFinishedNode(response)
        elif type(response) in ERROR_RESULT_TYPES:
            node = ErrorNode(response)
        else:
            assert isinstance(response, TacticState)
            node = InternalNode(response, parent.cumulative_logprob + logprob)
        nodes[response] = node
    return node
