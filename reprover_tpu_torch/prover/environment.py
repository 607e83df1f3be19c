"""Proof environment protocol (the Lean 4 interaction boundary).

The reference talks to Lean through LeanDojo's ``Dojo`` context manager and
``run_tac`` (`reference/prover/proof_search.py:97,244`). LeanDojo *is*
the environment, not the framework (SURVEY.md §2.2), so here we define a thin
structural protocol plus:

- result/state types mirroring ``lean_dojo``'s (hashable, so search-tree
  dedup-by-response works: `proof_search.py:249-252`);
- :class:`FakeEnvironment` — a scripted Lean stand-in for tests and search
  benchmarks (generalizing the reference's ``FixedTacticGenerator``-as-test
  pattern, SURVEY.md §4);
- :class:`LeanDojoEnvironment` — the adapter to real LeanDojo, gated on the
  package being importable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

# ------------------------------------------------------------------ #
# Theorem identity
# ------------------------------------------------------------------ #


@dataclasses.dataclass(frozen=True)
class RepoSpec:
    """A (url, commit) Lean repo pin — the role of ``lean_dojo.LeanGitRepo``."""

    url: str
    commit: str

    @property
    def name(self) -> str:
        return self.url.rstrip("/").split("/")[-1]


@dataclasses.dataclass(frozen=True)
class Theorem:
    """A theorem to prove — the role of ``lean_dojo.Theorem``."""

    repo: RepoSpec
    file_path: str
    full_name: str


# ------------------------------------------------------------------ #
# Tactic results (hashable — the search tree dedups nodes by response)
# ------------------------------------------------------------------ #


@dataclasses.dataclass(frozen=True)
class TacticState:
    """An unfinished proof state, identified by its pretty-printed goals."""

    pp: str

    @property
    def id(self) -> int:  # structural compat with lean_dojo.TacticState
        return hash(self.pp)


@dataclasses.dataclass(frozen=True)
class ProofFinished:
    """The tactic closed all goals."""

    message: str = ""


@dataclasses.dataclass(frozen=True)
class LeanError:
    """The tactic failed to elaborate / apply."""

    error: str


@dataclasses.dataclass(frozen=True)
class TacticTimeout:
    """The tactic itself timed out (returned, not raised)."""

    error: str = "timeout"


@dataclasses.dataclass(frozen=True)
class ProofGivenUp:
    """The tactic gave up on the proof (e.g. `sorry`)."""

    unsolved_tactic_state: str = ""


TacticResult = Union[TacticState, ProofFinished, LeanError, TacticTimeout, ProofGivenUp]

#: Result types that terminate a branch as FAILED
#: (`proof_search.py:256-261`).
ERROR_RESULT_TYPES: Tuple[type, ...] = (LeanError, TacticTimeout, ProofGivenUp)


# ------------------------------------------------------------------ #
# Exceptions (mirror lean_dojo's Dojo* error taxonomy)
# ------------------------------------------------------------------ #


class EnvironmentError_(Exception):
    """Base class for environment failures."""


class EnvironmentInitError(EnvironmentError_):
    """The theorem could not be entered — the search discards it
    (`proof_search.py:132-134`)."""


class EnvironmentCrashError(EnvironmentError_):
    """The environment process died mid-search — the search keeps the
    partial tree (`proof_search.py:110-112`)."""


class EnvironmentTimeoutError(EnvironmentError_):
    """Raised by ``run_tac`` when the global wall-clock budget is exhausted
    (`proof_search.py:149-150`)."""


# ------------------------------------------------------------------ #
# Environment protocol
# ------------------------------------------------------------------ #


class Environment:
    """Structural interface of a proof environment.

    Usage (same shape as ``lean_dojo.Dojo``)::

        with env.enter(theorem) as (session, init_state):
            result = session.run_tac(state, tactic)
    """

    def enter(self, theorem: Theorem) -> Any:  # context manager of (session, state)
        raise NotImplementedError


class Session:
    def run_tac(self, state: TacticState, tactic: str) -> TacticResult:
        raise NotImplementedError


# ------------------------------------------------------------------ #
# Fake environment for tests / search benchmarks
# ------------------------------------------------------------------ #


class _FakeSession(Session):
    def __init__(self, env: "FakeEnvironment") -> None:
        self.env = env
        self.num_tactics = 0

    def run_tac(self, state: TacticState, tactic: str) -> TacticResult:
        self.num_tactics += 1
        if self.env.crash_after is not None and self.num_tactics > self.env.crash_after:
            raise EnvironmentCrashError("scripted crash")
        key = (state.pp, tactic)
        spec = self.env.transitions.get(key)
        if spec is None:
            return LeanError(f"unknown tactic {tactic!r} at {state.pp!r}")
        if isinstance(spec, str):
            return ProofFinished() if spec == "QED" else TacticState(spec)
        return spec


class _FakeEnter:
    def __init__(self, env: "FakeEnvironment", theorem: Theorem) -> None:
        self.env = env
        self.theorem = theorem

    def __enter__(self) -> Tuple[Session, TacticState]:
        init = self.env.init_states.get(self.theorem.full_name)
        if init is None:
            raise EnvironmentInitError(f"no init state for {self.theorem.full_name}")
        return _FakeSession(self.env), TacticState(init)

    def __exit__(self, *exc: object) -> None:
        return None


class FakeEnvironment(Environment):
    """A scripted proof environment.

    ``init_states``: theorem full_name -> initial state pp.
    ``transitions``: (state pp, tactic) -> next state pp | "QED" |
    a :data:`TacticResult` instance. Unknown (state, tactic) pairs yield
    :class:`LeanError`. ``crash_after`` injects an
    :class:`EnvironmentCrashError` after N tactic executions (fault
    injection; the search must keep the partial tree).

    Picklable (plain dicts), so it crosses process boundaries to provers.
    """

    def __init__(
        self,
        init_states: Dict[str, str],
        transitions: Dict[Tuple[str, str], Any],
        crash_after: Optional[int] = None,
    ) -> None:
        self.init_states = dict(init_states)
        self.transitions = dict(transitions)
        self.crash_after = crash_after

    def enter(self, theorem: Theorem) -> _FakeEnter:
        return _FakeEnter(self, theorem)


# ------------------------------------------------------------------ #
# LeanDojo adapter (only if lean_dojo is installed)
# ------------------------------------------------------------------ #


def _to_our_result(res: Any) -> TacticResult:
    """Map a lean_dojo TacticResult onto our hashable result types."""
    tname = type(res).__name__
    if tname == "TacticState":
        return TacticState(res.pp)
    if tname == "ProofFinished":
        return ProofFinished(getattr(res, "message", "") or "")
    if tname == "ProofGivenUp":
        return ProofGivenUp(getattr(res, "unsolved_tactic_state", "") or "")
    if tname == "DojoTacticTimeoutError":
        return TacticTimeout()
    return LeanError(str(getattr(res, "error", res)))


class _LeanDojoSession(Session):
    def __init__(self, dojo: Any, timeout_exc: type) -> None:
        self.dojo = dojo
        self._timeout_exc = timeout_exc
        self._states: Dict[str, Any] = {}  # our pp -> lean_dojo state

    def remember(self, ld_state: Any) -> TacticState:
        ours = TacticState(ld_state.pp)
        self._states[ours.pp] = ld_state
        return ours

    def run_tac(self, state: TacticState, tactic: str) -> TacticResult:
        ld_state = self._states[state.pp]
        try:
            res = self.dojo.run_tac(ld_state, tactic)
        except self._timeout_exc as ex:
            raise EnvironmentTimeoutError(str(ex)) from ex
        except Exception as ex:
            if type(ex).__name__ == "DojoCrashError":
                raise EnvironmentCrashError(str(ex)) from ex
            raise
        if type(res).__name__ == "TacticState":
            return self.remember(res)
        return _to_our_result(res)


class _LeanDojoEnter:
    def __init__(self, env: "LeanDojoEnvironment", theorem: Theorem) -> None:
        self.env = env
        self.theorem = theorem
        self._cm: Any = None

    def __enter__(self) -> Tuple[Session, TacticState]:
        ld = self.env._ld
        repo = ld.LeanGitRepo(self.theorem.repo.url, self.theorem.repo.commit)
        thm = ld.Theorem(repo, self.theorem.file_path, self.theorem.full_name)
        self._cm = ld.Dojo(
            thm, self.env.timeout, additional_imports=self.env.additional_imports
        )
        try:
            dojo, init_state = self._cm.__enter__()
        except ld.DojoInitError as ex:
            raise EnvironmentInitError(str(ex)) from ex
        session = _LeanDojoSession(dojo, ld.DojoTacticTimeoutError)
        return session, session.remember(init_state)

    def __exit__(self, *exc: object) -> Any:
        return self._cm.__exit__(*exc)


class LeanDojoEnvironment(Environment):
    """Adapter running searches in real Lean 4 via LeanDojo
    (`proof_search.py:91-112` semantics). Requires ``lean_dojo``."""

    def __init__(self, timeout: int, additional_imports: Optional[List[str]] = None):
        import lean_dojo  # noqa: F401 — hard dependency of this adapter only

        self._ld = lean_dojo
        self.timeout = timeout
        self.additional_imports = additional_imports or []

    def enter(self, theorem: Theorem) -> _LeanDojoEnter:
        return _LeanDojoEnter(self, theorem)

    # Picklable across process boundaries: drop the module handle and
    # re-import on the other side.
    def __getstate__(self) -> Dict[str, Any]:
        return {
            "timeout": self.timeout,
            "additional_imports": self.additional_imports,
        }

    def __setstate__(self, state: Dict[str, Any]) -> None:
        import lean_dojo

        self._ld = lean_dojo
        self.timeout = state["timeout"]
        self.additional_imports = state["additional_imports"]


def lean_dojo_available() -> bool:
    try:
        import lean_dojo  # noqa: F401

        return True
    except ImportError:
        return False


def environment_from_dataset(theorems: List[Dict[str, Any]]) -> FakeEnvironment:
    """Build a replay environment from LeanDojo-format theorem records.

    Each theorem's ``traced_tactics`` become scripted transitions: applying
    the recorded tactic at its ``state_before`` yields ``state_after``
    (``"no goals"`` -> ProofFinished). This turns any dataset — real or
    synthetic (``scripts/make_synthetic_benchmark.py``) — into a provable
    offline environment for end-to-end training/search validation without
    Lean.
    """
    init_states: Dict[str, str] = {}
    transitions: Dict[Tuple[str, str], Any] = {}
    for thm in theorems:
        tactics = thm.get("traced_tactics") or []
        if not tactics:
            continue
        init_states[thm["full_name"]] = tactics[0]["state_before"]
        for tac in tactics:
            after = tac["state_after"]
            transitions[(tac["state_before"], tac["tactic"])] = (
                "QED" if after == "no goals" else after
            )
    return FakeEnvironment(init_states=init_states, transitions=transitions)
