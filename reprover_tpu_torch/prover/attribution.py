"""Pass@1 failure attribution: gold-path replay over failed theorems.

The prover's headline number (Pass@1, `/root/reference/prover/evaluate.py:146-162`)
conflates three very different failure modes. For each *failed* theorem this
module replays the dataset's gold proof path (``traced_tactics``) through the
same retriever + tactic generator the search used, and buckets the failure at
the first broken link:

- ``retrieval_miss``  — a gold premise of the first failing step was not in
  the retriever's top-k (the generator never saw the evidence it needed);
- ``prompt_overflow`` — every gold premise was retrieved, but at least one
  did not fit the augmented prompt's byte budget (retrieved-but-unseen);
- ``generator_rank``  — the evidence was in the prompt, yet the gold tactic
  did not appear among the ``num_samples`` beam candidates;
- ``search_budget``   — every gold step's tactic was generated at its gold
  state (the gold path was fully reachable), so the search spent its
  expansions/time elsewhere (ordering/width, not model quality).

The causal walk is in proof order: steps after the first broken one are
unreachable by the gold path, so the bucket is decided at that step —
retrieval before prompt before generator (a miss upstream explains the
failure downstream). This is the attribution harness VERDICT round-4 asked
for (weak #2); the emitted table tells you which stage to attack.

A copy of ``reprover_tpu/prover/attribution.py:1-206``, which the port may
not import, with one repair (reference fault 4): the JAX module calls
``asyncio.run`` once per gold step (``:144``), which raises inside a running
event loop. Here each theorem's replay is one coroutine
(:func:`attribute_failure_async`) that awaits every gold step, and
:func:`attribute_failures` runs one event loop for all of them; a
synchronous call made from inside a running loop runs its loop on a helper
thread instead of raising. The retriever and generator are the caller's, so
the replay runs on whatever device they hold.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import logging
from typing import Any, Coroutine, Dict, List, Optional, Sequence, TypeVar

from reprover_tpu_torch.data import Pos, get_all_pos_premises, remove_marks

logger = logging.getLogger(__name__)

BUCKETS = (
    "retrieval_miss",
    "prompt_overflow",
    "generator_rank",
    "search_budget",
)


@dataclasses.dataclass
class StepAttribution:
    """Gold-path replay outcome for one proof step."""

    step_idx: int
    gold_tactic: str
    num_gold_premises: int
    num_retrieved_gold: int  # gold premises found in the retriever's top-k
    worst_gold_rank: Optional[int]  # 0-based rank of the worst-ranked gold hit
    premises_in_prompt: bool  # all gold premises survived the byte budget
    gold_in_beams: bool  # gold tactic among the sampled candidates
    gold_beam_rank: Optional[int]

    @property
    def retrieval_ok(self) -> bool:
        return self.num_retrieved_gold == self.num_gold_premises


@dataclasses.dataclass
class TheoremAttribution:
    full_name: str
    bucket: str
    first_failing_step: Optional[int]  # None for search_budget
    steps: List[StepAttribution]


def _gold_candidates(tac_gen: Any) -> tuple:
    """Pull (retriever, delegate, max_inp_seq_len, max_num_retrieved) out of
    a RetrievalAugmentedTacticGenerator; plain generators have no
    retrieval stage (their retrieval/prompt checks trivially pass)."""
    retriever = getattr(tac_gen, "retriever", None)
    if retriever is None:
        return None, tac_gen, None, 0
    return (
        retriever,
        tac_gen,
        getattr(tac_gen, "max_inp_seq_len", 2048),
        getattr(tac_gen, "max_num_retrieved", 100),
    )


_T = TypeVar("_T")


def _run(coro: Coroutine[Any, Any, _T]) -> _T:
    """Run ``coro`` to its end on a new event loop: on this thread, or on a
    helper thread when this one already runs a loop (``asyncio.run`` would
    raise there)."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(asyncio.run, coro).result()


def attribute_failure(
    thm: Dict[str, Any],
    tac_gen: Any,
    num_samples: int,
    corpus: Any = None,
) -> Optional[TheoremAttribution]:
    """Replay one failed theorem's gold path on one event loop. Returns None
    when the record has no ``traced_tactics`` (nothing to replay)."""
    return _run(attribute_failure_async(thm, tac_gen, num_samples, corpus))


async def attribute_failure_async(
    thm: Dict[str, Any],
    tac_gen: Any,
    num_samples: int,
    corpus: Any = None,
) -> Optional[TheoremAttribution]:
    """:func:`attribute_failure` as a coroutine: every gold step's
    generation is awaited on the caller's loop."""
    from reprover_tpu_torch.data import format_augmented_state

    tactics = thm.get("traced_tactics") or []
    if not tactics:
        return None
    retriever, gen, max_inp_seq_len, max_num_retrieved = _gold_candidates(
        tac_gen
    )
    file_path = thm["file_path"]
    full_name = thm["full_name"]
    pos = Pos.of(thm["start"])

    steps: List[StepAttribution] = []
    bucket: Optional[str] = None
    first_fail: Optional[int] = None
    for i, tac in enumerate(tactics):
        state = tac["state_before"]
        gold_tactic = tac["tactic"]
        gold_premises: List[Any] = []
        if corpus is not None and tac.get("annotated_tactic"):
            gold_premises = get_all_pos_premises(
                tuple(tac["annotated_tactic"]), corpus
            )

        num_hit = len(gold_premises)
        worst_rank: Optional[int] = None
        in_prompt = True
        if retriever is not None and gold_premises:
            retrieved, _scores = retriever.retrieve(
                state, file_path, full_name, pos, max_num_retrieved
            )
            keys = {(p.path, p.full_name): r for r, p in enumerate(retrieved)}
            ranks = [
                keys.get((p.path, p.full_name)) for p in gold_premises
            ]
            hits = [r for r in ranks if r is not None]
            num_hit = len(hits)
            worst_rank = max(hits) if hits else None
            # Reproduce the exact search-time prompt (augment + strip
            # marks) and check every gold premise's text survived the
            # byte budget — retrieved-at-rank-90 premises can be skipped.
            prompt = remove_marks(
                format_augmented_state(state, retrieved, max_inp_seq_len)
            )
            in_prompt = all(
                remove_marks(p.serialize()) in prompt for p in gold_premises
            )

        # The generator check uses the SAME entry point as the search
        # (augmentation included for RetrievalAugmented generators).
        candidates = await gen.generate(state, file_path, full_name, pos, num_samples)
        beam_rank = None
        for r, (t, _s) in enumerate(candidates):
            if t == gold_tactic:
                beam_rank = r
                break

        step = StepAttribution(
            step_idx=i,
            gold_tactic=gold_tactic,
            num_gold_premises=len(gold_premises),
            num_retrieved_gold=num_hit,
            worst_gold_rank=worst_rank,
            premises_in_prompt=in_prompt,
            gold_in_beams=beam_rank is not None,
            gold_beam_rank=beam_rank,
        )
        steps.append(step)
        if bucket is None and beam_rank is None:
            first_fail = i
            if not step.retrieval_ok:
                bucket = "retrieval_miss"
            elif not in_prompt:
                bucket = "prompt_overflow"
            else:
                bucket = "generator_rank"
            break  # steps past the first broken link are unreachable

    if bucket is None:
        bucket = "search_budget"
    return TheoremAttribution(
        full_name=full_name,
        bucket=bucket,
        first_failing_step=first_fail,
        steps=steps,
    )


def attribute_failures(
    theorems: Sequence[Dict[str, Any]],
    failed_names: Sequence[str],
    tac_gen: Any,
    num_samples: int,
    corpus: Any = None,
) -> Dict[str, Any]:
    """Attribute every failed theorem, on one event loop; returns
    per-theorem records plus the bucket table ``{bucket: count}`` (the
    BASELINE.md deliverable)."""
    return _run(_attribute_all(theorems, failed_names, tac_gen, num_samples, corpus))


async def _attribute_all(
    theorems: Sequence[Dict[str, Any]],
    failed_names: Sequence[str],
    tac_gen: Any,
    num_samples: int,
    corpus: Any,
) -> Dict[str, Any]:
    by_name = {t["full_name"]: t for t in theorems}
    records: List[TheoremAttribution] = []
    counts = {b: 0 for b in BUCKETS}
    for name in failed_names:
        thm = by_name.get(name)
        if thm is None:
            logger.warning("failed theorem %s not in dataset records", name)
            continue
        att = await attribute_failure_async(thm, tac_gen, num_samples, corpus=corpus)
        if att is None:
            continue
        records.append(att)
        counts[att.bucket] += 1
    return {"records": records, "counts": counts}
