"""Each cell's control flow at a tiny width on the CPU: a sound run is
correct and reports no device metric; each fault the cell can have, planted
in the program underneath, turns ``correct`` false; the precision control
fails the check. The limits here are for float32 on the CPU at this size;
the cells' own limits hold at their size in bf16 on the card."""

import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, traffic
from perfbench.tests.conftest import TINY

TINY_LIMITS = {"score_gap_nats": 1e-3, "answers_unmatched": 0, "embedding_gap": 1e-4}


# Each cell's configuration and mix. `tacgen.search` is not in BENCHMARK.json
# (its rate spreads too widely between runs to be bounded), so its files are
# named here.
CELLS = {"tacgen.search": ("byt5-small-tacgen", "search"),
         "retriever.reindex": ("byt5-small-retriever", "reindex")}


def _context(name, seed, seconds, device="cuda", control=False, sizes_override=None):
    config, mix = CELLS[name]
    ctx = harness.Context(
        name=name, cell=harness.load_json(harness.HERE, "cells", name + ".json"),
        config=harness.load_json(harness.HERE, "configs", config + ".json"),
        traffic=traffic.load_mix(mix), seed=seed, seconds=seconds, trace=False, device=device,
        sizes_override=sizes_override, control=control)
    ctx.started = time.perf_counter()
    return ctx


def _ctx(name, seed=2 ** 40 + 11, control=False, seconds=2.0):
    ctx = _context(name, seed, seconds, "cpu", control, TINY)
    ctx.cell["checks"] = {k: v for k, v in TINY_LIMITS.items() if k in ctx.cell["checks"]}
    if name == "tacgen.search":
        ctx.cell.update(num_slots=2, num_beams=4, max_inp_seq_len=300, max_oup_seq_len=8,
                        check_requests=3, warm_timeout_s=5, drain_timeout_s=5)
        ctx.traffic.update(clients=3, warm_responses=2, source_bytes={"uniform": [50, 300]},
                           pool=64)
    else:
        ctx.cell.update(batch_size=8, max_seq_len=256, check_rows=4)
        ctx.traffic.update(premises=300, shard=64, shards=3, premise_bytes={
            "lognormal": {"median": 64, "sigma": 0.8, "min": 8, "max": 256}})
    return ctx


def _run(ctx):
    return harness.driver(ctx.cell["driver"]).run(ctx)


@pytest.mark.parametrize("name", ["tacgen.search", "retriever.reindex"])
def test_perfbench_cell_runs_on_cpu(name):
    r = _run(_ctx(name))
    assert r.correct, r.checks
    assert r.attempted > 0 and r.failed == 0
    bench = harness.benchmark()
    for trace in (False, True):
        assert harness.metrics(bench, "retriever.reindex", r.window, trace) == {}
    assert r.memory_peak_bytes is None


@pytest.mark.parametrize("name,check", [("tacgen.search", "score_gap_nats"),
                                        ("retriever.reindex", "embedding_gap")])
def test_perfbench_precision_control_fails(name, check):
    r = _run(_ctx(name, control=True))
    program, control = r.checks[check]["value"], r.window.values["control"][check]
    assert r.correct
    assert control > TINY_LIMITS[check] and control >= 3 * program


def _alter_token(monkeypatch):
    from reprover_tpu_torch.generation import engine

    real = engine.StepwiseEngineBase.finalize_prefetched

    def altered(self, slot, handle):
        seqs, scores, lens = real(self, slot, handle)
        seqs = seqs.copy()
        seqs[:, 1] = 3 + (seqs[:, 1] - 2) % 200
        return seqs, scores, lens

    monkeypatch.setattr(engine.StepwiseEngineBase, "finalize_prefetched", altered)


def _state_unchanged(monkeypatch):
    from reprover_tpu_torch.generation import engine

    monkeypatch.setattr(engine.StepwiseBeamEngine, "_step_program", lambda self, s, t: None)


def _half_batch(monkeypatch):
    from reprover_tpu_torch.retrieval import retriever

    real = retriever.masked_mean_normalize

    def half(hidden, mask):
        keep = max(1, hidden.shape[0] // 2)
        out = real(hidden[:keep], mask[:keep])
        return torch.cat([out, out.mean(0, keepdim=True).expand(hidden.shape[0] - keep, -1)])

    monkeypatch.setattr(retriever, "masked_mean_normalize", half)


def _answer_altered(monkeypatch):
    from reprover_tpu_torch.retrieval import retriever

    real = retriever.masked_mean_normalize

    def without_last(hidden, mask):
        m = mask.clone()
        m[torch.arange(m.shape[0]), m.sum(1).long() - 1] = 0
        return real(hidden, m)

    monkeypatch.setattr(retriever, "masked_mean_normalize", without_last)


@pytest.mark.parametrize("name,fault", [
    ("tacgen.search", _alter_token),
    ("tacgen.search", _state_unchanged),
    ("retriever.reindex", _half_batch),
    ("retriever.reindex", _answer_altered),
], ids=["search-token-altered", "search-state-unchanged", "reindex-half-batch",
        "reindex-answer-altered"])
def test_perfbench_fault_fails_the_check(monkeypatch, name, fault):
    fault(monkeypatch)
    r = _run(_ctx(name))
    assert not r.correct


def test_perfbench_run_without_a_card_prints_nothing():
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "retriever.reindex",
                        "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode == 3 and p.stdout == "" and "CUDA card" in p.stderr


def test_perfbench_run_without_the_program_prints_nothing(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "retriever.reindex",
                        "--seed", "7", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name,check", [("tacgen.search", "score_gap_nats"),
                                        ("retriever.reindex", "embedding_gap")])
def test_perfbench_control_at_cell_size(card, name, check):
    """The precision control at the cell's own size on the card: the
    program passes its limit, the fp8 reference in its place does not."""
    r = _run(_context(name, 2 ** 36 + 5, 10.0, control=True))
    assert r.correct, r.checks
    assert r.window.values["control"][check] > r.checks[check]["limit"]
