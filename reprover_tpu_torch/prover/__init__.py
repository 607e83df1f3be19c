"""Proof search on the port's models: environment protocol, search tree,
best-first search, tactic generators, the shared inference service, the
distributed worker pool, the Pass@1 evaluation harness, its failure
attribution and the LLM-API tactic generator. Copies of the JAX package's
host-side modules (``reprover_tpu/prover/__init__.py:37-45`` for the last
two), wired to the port's models."""

from reprover_tpu_torch.prover.environment import (
    Environment,
    EnvironmentCrashError,
    EnvironmentInitError,
    EnvironmentTimeoutError,
    FakeEnvironment,
    LeanError,
    ProofFinished,
    ProofGivenUp,
    RepoSpec,
    TacticResult,
    TacticState,
    TacticTimeout,
    Theorem,
    environment_from_dataset,
    lean_dojo_available,
)
from reprover_tpu_torch.prover.search_tree import (
    Edge,
    ErrorNode,
    InternalNode,
    ProofFinishedNode,
    Status,
)
from reprover_tpu_torch.prover.proof_search import BestFirstSearchProver, SearchResult
from reprover_tpu_torch.prover.tactic_generator import (
    FixedTacticGenerator,
    LocalTacticGenerator,
    RemoteTacticGenerator,
    RetrievalAugmentedTacticGenerator,
    TacticGenerator,
)
from reprover_tpu_torch.prover.api_generator import ApiTacticGenerator
from reprover_tpu_torch.prover.distributed import DistributedProver
from reprover_tpu_torch.prover.evaluate import aggregate_pass1, evaluate, get_theorems
from reprover_tpu_torch.prover.attribution import (
    StepAttribution,
    TheoremAttribution,
    attribute_failure,
    attribute_failures,
)
from reprover_tpu_torch.prover.service import (
    InferenceService,
    ServiceClient,
    StreamingInferenceService,
    serve_tensor_parallel,
)

__all__ = [
    "Environment",
    "EnvironmentCrashError",
    "EnvironmentInitError",
    "EnvironmentTimeoutError",
    "FakeEnvironment",
    "LeanError",
    "ProofFinished",
    "ProofGivenUp",
    "RepoSpec",
    "TacticResult",
    "TacticState",
    "TacticTimeout",
    "Theorem",
    "environment_from_dataset",
    "lean_dojo_available",
    "Edge",
    "ErrorNode",
    "InternalNode",
    "ProofFinishedNode",
    "Status",
    "BestFirstSearchProver",
    "SearchResult",
    "FixedTacticGenerator",
    "LocalTacticGenerator",
    "RemoteTacticGenerator",
    "RetrievalAugmentedTacticGenerator",
    "TacticGenerator",
    "ApiTacticGenerator",
    "DistributedProver",
    "StepAttribution",
    "TheoremAttribution",
    "attribute_failure",
    "attribute_failures",
    "aggregate_pass1",
    "evaluate",
    "get_theorems",
    "InferenceService",
    "StreamingInferenceService",
    "serve_tensor_parallel",
    "ServiceClient",
]
