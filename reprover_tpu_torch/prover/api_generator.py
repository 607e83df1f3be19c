"""Prompted LLM-API tactic generator (the reference's GPT-4 baseline).

Parity with `/root/reference/prover/tactic_generator.py:32-147`: the same
prompt template, ``#(tactic, confidence)#`` parsing, over-request by
``1/threshold``, per-call retries, and score-sorted truncation to
``num_samples``. The transport is injectable (``complete``: prompt -> text)
so the parser/retry logic is testable offline; the default transport uses
the ``openai`` package if installed (gated — not bundled).

A copy of ``reprover_tpu/prover/api_generator.py:1-123``, which the port may
not import. It runs no model and touches no device.
"""

from __future__ import annotations

import logging
from typing import Callable, List, Optional, Tuple

from reprover_tpu_torch.data import Pos
from reprover_tpu_torch.prover.tactic_generator import TacticGenerator

logger = logging.getLogger(__name__)

DEFAULT_PROMPT = (
    "You are an expert in theorem proving in Lean. We are trying to solve the"
    " Lean theorem 'THEOREM_FULL_NAME' from the mathlib file 'FILE_PATH'. The"
    " current tactic state is: 'TACTIC_STATE'. Suggest exactly NUM_SAMPLES"
    " unique tactics to progress in solving 'THEOREM_FULL_NAME', along with"
    " their confidence levels as a float between 0 and 1. Rank them in order"
    " of effectiveness. Present the tactics and their confidence levels as"
    " comma-separated tuples in this format: #(tactic_{1}, confidence_{1})#,"
    " #(tactic_{2}, confidence_{2})#, ...,"
    " #(tactic_{NUM_SAMPLES}, confidence_{NUM_SAMPLES})#."
)


def parse_tactic_tuples(output: str) -> List[Tuple[str, float]]:
    """Parse ``#(tactic, confidence)#`` tuples
    (`tactic_generator.py:102-130` semantics, malformed entries skipped)."""
    indices = [i for i, c in enumerate(output) if c == "#"]
    parsed: List[Tuple[str, float]] = []
    for i in range(1, len(indices), 2):
        chunk = output[indices[i - 1] + 1 : indices[i]].strip()
        try:
            while chunk[0] == "(":
                chunk = chunk[1:]
            if chunk[-1] == ")":
                chunk = chunk[:-1]
            split = chunk.rindex(",")
            tactic = chunk[:split].strip()
            confidence = float(chunk[split + 1 :].strip())
        except Exception:
            logger.info("unparsable tactic tuple: %r", chunk)
            continue
        parsed.append((tactic, confidence))
    return parsed


def _openai_transport(model: str, max_tokens: int) -> Callable[[str], str]:
    import openai  # gated import — not bundled

    client = openai.OpenAI()

    def complete(prompt: str) -> str:
        response = client.chat.completions.create(
            model=model,
            messages=[{"role": "user", "content": prompt}],
            max_tokens=max_tokens,
        )
        return response.choices[0].message.content

    return complete


class ApiTacticGenerator(TacticGenerator):
    """Tactic suggestions from a prompted chat-completion API."""

    def __init__(
        self,
        complete: Optional[Callable[[str], str]] = None,
        model: str = "gpt-4",
        max_tokens: int = 1024,
        num_retries: int = 3,
        threshold: float = 0.9,
    ) -> None:
        self.complete = complete
        self.model = model
        self.max_tokens = max_tokens
        self.num_retries = num_retries
        self.threshold = threshold

    def initialize(self) -> None:
        if self.complete is None:
            self.complete = _openai_transport(self.model, self.max_tokens)

    async def generate(
        self,
        state: str,
        file_path: str,
        theorem_full_name: str,
        theorem_pos: Pos,
        num_samples: int,
    ) -> List[Tuple[str, float]]:
        assert self.complete is not None, "initialize() first"
        prompt = (
            DEFAULT_PROMPT.replace("TACTIC_STATE", state)
            .replace("FILE_PATH", file_path)
            .replace("THEOREM_FULL_NAME", theorem_full_name)
            .replace("NUM_SAMPLES", str(int(num_samples / self.threshold)))
        )

        for _ in range(self.num_retries):
            try:
                output = self.complete(prompt)
            except Exception as ex:  # API / connection / rate-limit errors
                logger.info("API error: %s", ex)
                continue
            if output is None:
                continue
            tactics = parse_tactic_tuples(output)
            if len(tactics) < int(self.threshold * num_samples):
                continue  # under-delivered — retry (`tactic_generator.py:132`)
            tactics.sort(key=lambda x: x[1], reverse=True)
            return tactics[: min(num_samples, len(tactics))]

        raise ValueError("API outputs are unparsable.")
