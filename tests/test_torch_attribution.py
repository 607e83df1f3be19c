"""PyTorch port, Pass@1 failure attribution (``prover/attribution.py``): the
seven cases of ``tests/test_attribution.py`` on the port's copy, the two
packages' records and counts equal for the same fake retriever and
generator, and the copy's repair of reference fault 4: it runs from inside a
running event loop (the JAX module calls ``asyncio.run`` per gold step,
which raises there)."""

import asyncio
import dataclasses

import pytest

from reprover_tpu import data as jdata
from reprover_tpu import prover as jprover
from reprover_tpu_torch import data as tdata
from reprover_tpu_torch import prover as tprover
from reprover_tpu_torch.prover import (
    RetrievalAugmentedTacticGenerator,
    TacticGenerator,
    attribute_failure,
    attribute_failures,
)
from reprover_tpu_torch.prover.attribution import BUCKETS
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()


def _premise(name, code="theorem x : 1 = 1 := rfl", pkg=tdata):
    return pkg.Premise("f.lean", name, [1, 1], [2, 1], code)


GOLD_A = _premise("Ns.gold_a")
GOLD_B = _premise("Ns.gold_b")
FILLER = [_premise(f"Ns.filler_{i}") for i in range(4)]


class MapRetriever:
    """state -> fixed retrieved list."""

    def __init__(self, table, filler=FILLER):
        self.table, self.filler = table, filler

    def retrieve(self, state, file_path, full_name, pos, k):
        got = self.table.get(state, self.filler)[:k]
        return got, [1.0] * len(got)


class SuffixGenerator:
    """Candidates keyed by the RAW state the augmented prompt ends with."""

    def __init__(self, table):
        self.table = table

    def initialize(self):
        pass

    async def generate(self, state, file_path, full_name, pos, num_samples):
        for suffix, cands in self.table.items():
            if state.endswith(suffix):
                return cands[:num_samples]
        return []


def _thm(tactics):
    return {
        "url": "u", "commit": "c", "file_path": "d.lean",
        "full_name": "thm", "start": [1, 1], "end": [2, 1],
        "traced_tactics": tactics,
    }


def _step(state, tactic, premises, after="s_next"):
    return {
        "tactic": tactic,
        "annotated_tactic": [tactic, [
            {"full_name": p.full_name, "def_path": p.path,
             "def_pos": [p.start.line_nb, p.start.column_nb],
             "def_end_pos": [p.end.line_nb, p.end.column_nb]}
            for p in premises
        ]],
        "state_before": state,
        "state_after": after,
    }


class StubCorpus:
    """locate_premise keyed on (path, pos) over the fixture premises."""

    def __init__(self, premises=None):
        self.premises = premises or [GOLD_A, GOLD_B] + FILLER

    def locate_premise(self, path, pos):
        for p in self.premises:
            if p.path == path and p.start == pos:
                return p
        return None


def _rag(ret_table, gen_table, max_inp=2048, prover=tprover, filler=FILLER):
    return prover.RetrievalAugmentedTacticGenerator(
        SuffixGenerator(gen_table), MapRetriever(ret_table, filler),
        max_inp_seq_len=max_inp, max_num_retrieved=4,
    )


def test_retrieval_miss():
    thm = _thm([_step("s0", "rw [gold_a]", [GOLD_A])])
    tac_gen = _rag({"s0": FILLER}, {"s0": [("wrong", 0.0)]})
    att = attribute_failure(thm, tac_gen, 4, corpus=StubCorpus())
    assert att.bucket == "retrieval_miss"
    assert att.first_failing_step == 0
    assert att.steps[0].num_retrieved_gold == 0
    assert not att.steps[0].gold_in_beams


def test_generator_rank():
    thm = _thm([_step("s0", "rw [gold_a]", [GOLD_A])])
    tac_gen = _rag({"s0": [GOLD_A] + FILLER[:2]}, {"s0": [("wrong", 0.0)]})
    att = attribute_failure(thm, tac_gen, 4, corpus=StubCorpus())
    assert att.bucket == "generator_rank"
    assert att.steps[0].num_retrieved_gold == 1
    assert att.steps[0].worst_gold_rank == 0
    assert att.steps[0].premises_in_prompt


def test_prompt_overflow():
    filler_big = [_premise(f"Ns.big_{i}", "theorem big : 1 = 1 := " + "x" * 40)
                  for i in range(3)]
    thm = _thm([_step("s0", "rw [gold_a]", [GOLD_A])])
    max_inp = len("s0".encode()) + sum(
        len(f"{p.serialize()}\n\n".encode()) for p in filler_big) + 4
    tac_gen = _rag({"s0": filler_big + [GOLD_A]}, {"s0": [("wrong", 0.0)]}, max_inp)
    att = attribute_failure(thm, tac_gen, 4, corpus=StubCorpus())
    assert att.bucket == "prompt_overflow"
    assert att.steps[0].num_retrieved_gold == 1
    assert not att.steps[0].premises_in_prompt


def test_search_budget():
    thm = _thm([
        _step("s0", "rw [gold_a]", [GOLD_A], after="s1"),
        _step("s1", "rw [gold_b]", [GOLD_B], after="no goals"),
    ])
    tac_gen = _rag(
        {"s0": [GOLD_A] + FILLER[:2], "s1": [GOLD_B] + FILLER[:2]},
        {"s0": [("rw [gold_a]", 0.0)], "s1": [("rw [gold_b]", -0.1)]},
    )
    att = attribute_failure(thm, tac_gen, 4, corpus=StubCorpus())
    assert att.bucket == "search_budget"
    assert att.first_failing_step is None
    assert len(att.steps) == 2 and all(s.gold_in_beams for s in att.steps)


def test_first_broken_link_wins():
    thm = _thm([
        _step("s0", "rw [gold_a]", [GOLD_A], after="s1"),
        _step("s1", "rw [gold_b]", [GOLD_B], after="no goals"),
    ])
    tac_gen = _rag(
        {"s0": [GOLD_A] + FILLER[:2], "s1": FILLER},
        {"s0": [("rw [gold_a]", 0.0)], "s1": [("wrong", 0.0)]},
    )
    att = attribute_failure(thm, tac_gen, 4, corpus=StubCorpus())
    assert att.bucket == "retrieval_miss"
    assert att.first_failing_step == 1
    assert len(att.steps) == 2


def test_plain_generator_no_retrieval_stage():
    thm = _thm([_step("s0", "tac", [GOLD_A])])

    class NoGen(TacticGenerator):
        async def generate(self, *a):
            return [("wrong", 0.0)]

    att = attribute_failure(thm, NoGen(), 4, corpus=StubCorpus())
    assert att.bucket == "generator_rank"


def _two_theorems(pkg):
    gold_a, gold_b = _premise("Ns.gold_a", pkg=pkg), _premise("Ns.gold_b", pkg=pkg)
    return [
        _thm([_step("s0", "rw [gold_a]", [gold_a])]),
        {**_thm([_step("s1", "rw [gold_b]", [gold_b])]), "full_name": "thm2"},
    ]


def test_aggregate_counts():
    out = attribute_failures(_two_theorems(tdata), ["thm", "thm2"], _rag(
        {"s0": FILLER, "s1": [GOLD_B] + FILLER[:2]},
        {"s0": [("wrong", 0.0)], "s1": [("rw [gold_b]", 0.0)]},
    ), 4, corpus=StubCorpus())
    assert out["counts"]["retrieval_miss"] == 1
    assert out["counts"]["search_budget"] == 1
    assert len(out["records"]) == 2


def _scenario(pkg, prover):
    """Every bucket once, and a theorem that is not in the records, through
    one package's attribution with its own premises."""
    gold_a, gold_b = (_premise(n, pkg=pkg) for n in ("Ns.gold_a", "Ns.gold_b"))
    filler = [_premise(f"Ns.filler_{i}", pkg=pkg) for i in range(4)]
    big = [_premise(f"Ns.big_{i}", "theorem big : 1 = 1 := " + "x" * 40, pkg=pkg)
           for i in range(3)]
    corpus = StubCorpus([gold_a, gold_b] + filler + big)
    theorems = [
        {**_thm([_step("m0", "rw [gold_a]", [gold_a])]), "full_name": "miss"},
        {**_thm([_step("r0", "rw [gold_a]", [gold_a])]), "full_name": "rank"},
        {**_thm([_step("o0", "rw [gold_a]", [gold_a])]), "full_name": "overflow"},
        {**_thm([_step("b0", "rw [gold_a]", [gold_a], after="b1"),
                 _step("b1", "rw [gold_b]", [gold_b], after="no goals")]),
         "full_name": "budget"},
        {**_thm([]), "full_name": "untraced"},
    ]
    max_inp = 2 + sum(len(f"{p.serialize()}\n\n".encode()) for p in big) + 4
    retrieved = {"m0": filler, "r0": [gold_a] + filler[:2], "o0": big + [gold_a],
                 "b0": [gold_a] + filler[:2], "b1": [gold_b] + filler[:2]}
    generated = {"m0": [("wrong", 0.0)], "r0": [("also wrong", -1.0), ("wrong", -2.0)],
                 "o0": [("wrong", 0.0)], "b0": [("x", 0.0), ("rw [gold_a]", -0.5)],
                 "b1": [("rw [gold_b]", -0.1)]}
    rag = _rag(retrieved, generated, max_inp, prover=prover, filler=filler)
    names = ["miss", "rank", "budget", "untraced", "not_in_dataset"]
    out = prover.attribute_failures(theorems, names, rag, 4, corpus=corpus)
    # The overflow theorem alone: its byte budget is the prompt's.
    over = prover.attribute_failure(theorems[2], rag, 4, corpus=corpus)
    return out, over


def test_records_and_counts_equal_the_jax_package():
    """The same fake retriever, generator and theorems through both
    packages: equal records (field by field) and bucket counts."""
    jout, jover = _scenario(jdata, jprover)
    tout, tover = _scenario(tdata, tprover)
    assert tout["counts"] == jout["counts"]
    assert [dataclasses.asdict(r) for r in tout["records"]] == \
        [dataclasses.asdict(r) for r in jout["records"]]
    assert dataclasses.asdict(tover) == dataclasses.asdict(jover)
    assert tover.bucket == "prompt_overflow"
    assert tout["counts"] == {**{b: 0 for b in BUCKETS}, "retrieval_miss": 1,
                              "generator_rank": 1, "search_budget": 1}


@pytest.mark.parametrize("many", [False, True])
def test_runs_inside_a_running_event_loop(many):
    """Called from a coroutine (a running loop on this thread), the
    synchronous entry points run their own loop elsewhere instead of
    raising; the async one awaits on the caller's loop."""
    thm = _thm([_step("s0", "rw [gold_a]", [GOLD_A], after="s1"),
                _step("s1", "rw [gold_b]", [GOLD_B], after="no goals")])
    tac_gen = _rag({"s0": [GOLD_A], "s1": [GOLD_B]},
                   {"s0": [("rw [gold_a]", 0.0)], "s1": [("rw [gold_b]", 0.0)]})

    async def caller():
        if many:
            return attribute_failures([thm], ["thm"], tac_gen, 4, corpus=StubCorpus())
        from reprover_tpu_torch.prover.attribution import attribute_failure_async

        first = attribute_failure(thm, tac_gen, 4, corpus=StubCorpus())
        second = await attribute_failure_async(thm, tac_gen, 4, corpus=StubCorpus())
        assert second == first
        return first

    got = asyncio.run(caller())
    if many:
        assert got["counts"]["search_budget"] == 1
    else:
        assert got.bucket == "search_budget" and len(got.steps) == 2


def test_one_event_loop_per_call(monkeypatch):
    """A two-step replay starts one event loop, not one per gold step."""
    runs = []
    real_run = asyncio.run
    monkeypatch.setattr(asyncio, "run", lambda coro: runs.append(1) or real_run(coro))
    thm = _thm([_step("s0", "rw [gold_a]", [GOLD_A], after="s1"),
                _step("s1", "rw [gold_b]", [GOLD_B], after="no goals")])
    tac_gen = _rag({"s0": [GOLD_A], "s1": [GOLD_B]},
                   {"s0": [("rw [gold_a]", 0.0)], "s1": [("rw [gold_b]", 0.0)]})
    assert attribute_failure(thm, tac_gen, 4, corpus=StubCorpus()).bucket == "search_budget"
    assert len(runs) == 1
    assert RetrievalAugmentedTacticGenerator is tprover.RetrievalAugmentedTacticGenerator
