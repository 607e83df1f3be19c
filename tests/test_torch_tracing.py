"""PyTorch port, spans and counters (``utils/profiling.py``) and the
re-index path that reports to them (``retrieval/retriever.py``): the
process's registry of spans and counters; counts from many threads
adding up exactly; no ``record_function`` entered without a profiler; every
``retriever.*`` span of a re-index in a CPU Chrome trace, nested in
``retriever.reindex``; the counters of a small re-index against the
arithmetic of its corpus; the indexer's spans line read back by
``parse_report``. On a card (``-m cuda``): a profiled re-index's first
kernel starts after the tokenize span ends, in the trace's one clock.

Imports no JAX, so the card test runs on a machine without it
(``python -m pytest tests/test_torch_tracing.py -m cuda --noconftest``)."""

import json
import sys
import threading
import time

import pytest
import torch

from reprover_tpu_torch.data import Corpus
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.retrieval.indexer import _spans_line, parse_report
from reprover_tpu_torch.retrieval.retriever import PremiseRetriever
from reprover_tpu_torch.utils.misc import cap_cpu_threads
from reprover_tpu_torch.utils.profiling import SectionTimer, count, counters, device_trace, span

cap_cpu_threads()

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2, num_decoder_layers=1)
# Head width 64 for the card's attention kernel.
CARD = dict(d_model=384, d_kv=64, d_ff=512, num_heads=6, num_encoder_layers=2,
            num_decoder_layers=1)
MAX_LEN, MULT, BATCH = 160, 32, 4
SPANS = ("retriever.reindex", "retriever.serialize", "retriever.tokenize", "retriever.upload",
         "retriever.encode")


def _gained(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _corpus(path, n=11):
    """``n`` premises of one file, 5 to 200 bytes of code (one with a
    two-byte character), so batches pad to several lengths and one is cut
    at ``MAX_LEN``."""
    premises = [{"full_name": f"Toy.p{i}", "code": f"theorem p{i} : {'x' * (i * i * 2)} := rfl"
                 + ("é" if i == 3 else ""), "start": [i + 1, 1], "end": [i + 1, 2]}
                for i in range(n)]
    with open(path, "w") as f:
        f.write(json.dumps({"path": "Toy.lean", "imports": [], "premises": premises}) + "\n")
    return Corpus(str(path))


def _retriever(corpus, cfg=TINY, device="cpu", dtype=torch.float32):
    config = tt5.T5Config(**cfg, compute_dtype=dtype)
    params = tt5.init_params(config, torch.Generator().manual_seed(0))
    params = {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}
    r = PremiseRetriever(tt5.place_params(tt5.fuse_mlp_params(params), config, device), config,
                         max_seq_len=MAX_LEN, bucket_multiple=MULT)
    r.load_corpus(corpus)
    return r


def test_span_count_and_counters_registry():
    """The process's registry: a span counts its seconds and entry, even
    when its block raises; ``count`` adds; ``counters()`` is a snapshot."""
    before = counters()
    with span("test.tracing.outer"):
        with span("test.tracing.inner"):
            time.sleep(0.002)
    with pytest.raises(RuntimeError):
        with span("test.tracing.raises"):
            raise RuntimeError
    count("test.tracing.count", 2)
    count("test.tracing.count")
    snap = counters()
    got = _gained(before, snap)
    assert got["test.tracing.raises.calls"] == 1 and got["test.tracing.count"] == 3
    assert got["test.tracing.outer.seconds"] >= got["test.tracing.inner.seconds"] >= 0.002
    count("test.tracing.count")
    assert snap["test.tracing.count"] == counters()["test.tracing.count"] - 1


def test_counts_from_threads_add_up_exactly():
    timer, threads_n, each = SectionTimer(), 16, 500
    start = threading.Barrier(threads_n)

    def work():
        start.wait(timeout=30)
        for _ in range(each):
            timer.count("n")
            timer.count("twos", 2)
            with timer.section("s"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = timer.snapshot()
    assert snap["n"] == threads_n * each and snap["twos"] == 2 * threads_n * each
    assert snap["s.calls"] == threads_n * each


def test_no_record_function_without_a_profiler(tmp_path, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    class Recording(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Recording)
    retriever = _retriever(_corpus(tmp_path / "c.jsonl"))
    with span("test.tracing.off"):
        retriever.reindex_corpus(BATCH)
    assert entered == []
    retriever.mark_stale()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("test.tracing.on"):
            retriever.reindex_corpus(BATCH)
    assert entered[0] == "test.tracing.on" and "retriever.reindex" in entered
    assert "retriever.encode" in entered


def test_reindex_spans_in_a_cpu_trace(tmp_path):
    """Every span of a one-process re-index (``retriever.gather`` runs
    under a mesh only: tests/test_torch_data_parallel.py) is a
    ``user_annotation``; serialise, tokenise and encode lie inside the
    re-index."""
    retriever = _retriever(_corpus(tmp_path / "c.jsonl"))
    with device_trace(str(tmp_path / "trace"), device="cpu"):
        retriever.reindex_corpus(BATCH)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and str(e.get("name")).startswith("retriever."):
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert set(spans) == set(SPANS)
    (outer,) = spans["retriever.reindex"]
    for name in ("retriever.serialize", "retriever.tokenize", "retriever.encode"):
        assert all(outer[0] <= s and t <= outer[1] for s, t in spans[name]), name
    n_batches = -(-len(retriever.corpus.all_premises) // BATCH)
    assert len(spans["retriever.upload"]) == len(spans["retriever.encode"]) == 2 * n_batches


def test_reindex_counters_equal_the_arithmetic(tmp_path):
    retriever = _retriever(_corpus(tmp_path / "c.jsonl"))
    texts = [p.serialize().encode("utf-8") for p in retriever.corpus.all_premises]
    real = [min(len(t) + 1, MAX_LEN) for t in texts]
    by_len = sorted(real)
    padded = sum(len(rows) * -(-max(rows) // MULT) * MULT
                 for rows in (by_len[i:i + BATCH] for i in range(0, len(by_len), BATCH)))
    assert max(real) == MAX_LEN and len(set(-(-r // MULT) for r in real)) >= 3

    before = counters()
    retriever.reindex_corpus(BATCH)
    first = _gained(before, counters())
    n = len(texts)
    assert first["retriever.premises"] == first["retriever.premises_prepared"] == n
    assert first["retriever.batches"] == -(-n // BATCH)
    assert first["retriever.tokens_real"] == sum(real)
    assert first["retriever.tokens_padded"] == padded
    assert "retriever.token_cache_hits" not in first
    for name in SPANS:
        assert first[f"{name}.seconds"] > 0, name
    assert first["retriever.reindex.calls"] == 1
    assert first["retriever.upload.calls"] == first["retriever.encode.calls"] == 2 * -(-n // BATCH)

    retriever.reindex_corpus(BATCH)  # fresh: a no-op, nothing counted
    assert _gained(before, counters()) == first

    retriever.mark_stale()
    mid = counters()
    retriever.reindex_corpus(BATCH)
    second = _gained(mid, counters())
    assert second["retriever.token_cache_hits"] == 1
    assert "retriever.premises_prepared" not in second
    assert "retriever.serialize.calls" not in second and "retriever.tokenize.calls" not in second
    for key in ("retriever.premises", "retriever.batches", "retriever.tokens_real",
                "retriever.tokens_padded"):
        assert second[key] == first[key], key


@pytest.mark.parametrize("gathered", [False, True])
def test_indexer_spans_line_is_read_back(gathered):
    before = {"retriever.serialize.seconds": 1.0, "retriever.tokens_real": 10,
              "retriever.tokens_padded": 20, "retriever.premises": 4, "retriever.batches": 1}
    after = {"retriever.serialize.seconds": 3.5, "retriever.tokenize.seconds": 0.25,
             "retriever.upload.seconds": 1.125, "retriever.encode.seconds": 0.5,
             "retriever.gather.seconds": 0.0625, "retriever.tokens_real": 854,
             "retriever.tokens_padded": 1020, "retriever.token_cache_hits": 2,
             "retriever.premises": 68, "retriever.batches": 17}
    line = _spans_line(before, after, gathered)
    printed = ("indexed 64 premises in 1.500s (42.7 premises/s) on cuda" + (
        " over 2 ranks, gather 0.250 ms of 4096 bytes" if gathered else "") + "\n" + line + "\n")
    got = parse_report(printed)
    assert got["premises"] == 64 and got["premises_per_s"] == 42.7
    assert (got["serialize_s"], got["tokenize_s"], got["upload_s"], got["encode_s"]) == (
        2.5, 0.25, 1.125, 0.5)
    assert got["gather_s"] == (0.062 if gathered else None)
    assert got["gather_ms"] == (0.25 if gathered else None)
    assert got["pad_efficiency_pct"] == 84.4 and got["token_cache_hits"] == 2
    assert (got["embedded_premises"], got["embedded_batches"]) == (64, 16)
    assert parse_report("indexed 3 premises in 1.0s (3.0 premises/s) on cpu")["encode_s"] is None


def test_indexer_prints_the_spans_line(tmp_path, capsys):
    from reprover_tpu_torch.models.hf_import import export_hf_t5
    from reprover_tpu_torch.retrieval.indexer import main

    cfg = tt5.T5Config(**TINY)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    export_hf_t5({"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]},
                 cfg, str(tmp_path / "ckpt"), encoder_only=True)
    _corpus(tmp_path / "c.jsonl")
    main(["--ckpt-path", str(tmp_path / "ckpt"), "--corpus-path", str(tmp_path / "c.jsonl"),
          "--output-path", str(tmp_path / "out"), "--batch-size", str(BATCH),
          "--max-seq-len", str(MAX_LEN), "--device", "cpu"])
    got = parse_report(capsys.readouterr().out)
    assert got["premises"] == 11 and got["token_cache_hits"] == 0 and got["gather_s"] is None
    assert (got["embedded_premises"], got["embedded_batches"]) == (11, -(-11 // BATCH))
    assert all(got[k] >= 0 for k in ("serialize_s", "tokenize_s", "upload_s", "encode_s"))
    assert 0 < got["pad_efficiency_pct"] < 100


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_first_kernel_starts_after_the_tokenize_span(card, tmp_path):
    """One clock for host spans and kernels: no kernel of a profiled
    re-index starts before its tokenize span has ended, and the first one
    starts within the re-index."""
    retriever = _retriever(_corpus(tmp_path / "c.jsonl", n=40), CARD, card, torch.bfloat16)
    retriever.reindex_corpus(BATCH)  # builds and warms the kernels
    retriever.load_corpus(_corpus(tmp_path / "d.jsonl", n=40))
    torch.cuda.synchronize()
    with device_trace(str(tmp_path / "trace"), device=card):
        retriever.reindex_corpus(BATCH)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]

    def annotation(name):
        (e,) = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])

    reindex, tokenize = annotation("retriever.reindex"), annotation("retriever.tokenize")
    kernels = sorted(float(e["ts"]) for e in events
                     if e.get("cat") == "kernel" and float(e["ts"]) >= reindex[0])
    assert kernels, "the profiler recorded no kernel"
    assert tokenize[1] <= kernels[0] <= reindex[1]
