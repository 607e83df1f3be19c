"""Proof search on the port's models. The search itself, the environments,
the inference service and the evaluation harness are the JAX package's
host-side modules (``reprover_tpu.prover``), which import no JAX."""

from reprover_tpu_torch.prover.tactic_generator import (
    LocalTacticGenerator,
    RetrievalAugmentedTacticGenerator,
)

__all__ = ["LocalTacticGenerator", "RetrievalAugmentedTacticGenerator"]
