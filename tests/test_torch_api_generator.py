"""PyTorch port, the LLM-API tactic generator (``prover/api_generator.py``):
``parse_tactic_tuples`` equal to the JAX package's on the reference's cases
and on generated strings, and the generator's retry, over-request and
unparsable paths through a fake transport (nothing is installed or called
over the network)."""

import asyncio

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from reprover_tpu.prover.api_generator import parse_tactic_tuples as jax_parse
from reprover_tpu_torch.data import Pos
from reprover_tpu_torch.prover import ApiTacticGenerator
from reprover_tpu_torch.prover.api_generator import DEFAULT_PROMPT, parse_tactic_tuples
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

CASES = [
    "Sure! #(rfl, 0.9)#, #(simp [foo, bar], 0.75)#, #(broken",
    "#(no confidence here)# #(ok, 0.5)#",
    "#((nested, parens), 0.1)# #(, 0.2)# #(x, -inf)# #(y, 1e-3)#",
    "", "#", "##", "#()#", "#(a,b)#", "#(intro h, 0.3)#\n#(exact h, .7)#",
]


@pytest.mark.parametrize("text", CASES)
def test_parse_matches_jax_on_cases(text):
    assert parse_tactic_tuples(text) == jax_parse(text)


def test_parse_reference_cases():
    assert parse_tactic_tuples(CASES[0]) == [("rfl", 0.9), ("simp [foo, bar]", 0.75)]
    assert parse_tactic_tuples(CASES[1]) == [("ok", 0.5)]


_tuple = st.tuples(st.text(alphabet="abc [](),. #", max_size=12),
                   st.one_of(st.floats(allow_nan=False, width=32).map(repr),
                             st.text(alphabet="0123456789.e-", max_size=6)))


@settings(max_examples=200, deadline=None)
@given(st.lists(_tuple, max_size=6), st.text(alphabet="ab #(),", max_size=20))
def test_parse_matches_jax_on_generated(tuples, noise):
    text = noise + ", ".join(f"#({t}, {c})#" for t, c in tuples) + noise
    assert parse_tactic_tuples(text) == jax_parse(text)


def test_generate_retry_then_success():
    calls = []

    def complete(prompt):
        calls.append(prompt)
        if len(calls) == 1:
            return "garbage"  # under-delivers -> retry
        if len(calls) == 2:
            raise ConnectionError("rate limited")  # an API error -> retry
        return "#(tac_b, 0.4)#, #(tac_a, 0.8)#, #(tac_c, 0.1)#"

    gen = ApiTacticGenerator(complete=complete, threshold=0.9, num_retries=3)
    gen.initialize()  # a transport is given: no client is made
    result = asyncio.run(gen.generate("⊢ x", "f.lean", "thm", Pos(1, 1), 2))
    assert result == [("tac_a", 0.8), ("tac_b", 0.4)]  # score-sorted, truncated
    assert len(calls) == 3
    # over-request by 1/threshold, the reference's template
    assert calls[0] == (DEFAULT_PROMPT.replace("TACTIC_STATE", "⊢ x")
                        .replace("FILE_PATH", "f.lean").replace("THEOREM_FULL_NAME", "thm")
                        .replace("NUM_SAMPLES", "2"))
    assert "exactly 2" in calls[0]


def test_generate_unparsable_raises():
    calls = []
    gen = ApiTacticGenerator(complete=lambda p: calls.append(p) or "nope", num_retries=2)
    with pytest.raises(ValueError, match="unparsable"):
        asyncio.run(gen.generate("⊢ x", "f.lean", "thm", Pos(1, 1), 4))
    assert len(calls) == 2


def test_generate_without_transport_asserts():
    with pytest.raises(AssertionError):
        asyncio.run(ApiTacticGenerator().generate("⊢ x", "f.lean", "thm", Pos(1, 1), 1))
