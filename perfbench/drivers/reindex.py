"""Corpus re-indexing through the port's ``PremiseRetriever.reindex_corpus``.

Set-up makes the encoder's weights from the seed and a corpus of
``premises`` texts (lengths from the mix's ``premise_bytes``, bytes from the
seed), cuts it into shards of ``shard`` premises taken in turn around the
corpus (``shards`` of them, each a ``Corpus`` read from a JSONL file under
``TMPDIR``), and warms one batch at each padded length the window meets.
The window re-indexes shard after shard: bind it (``load_corpus``), embed it
(``reindex_corpus`` tokenizes, sorts by length, batches), wait for the
device. It lasts ``seconds`` and then to the end of the shard in hand; a
traced run then profiles the re-index of a smaller shard
(``trace_premises``).

After each shard, the rows of a sample drawn from the seed (its longest
premise always in it) are copied off; after the window the float32
reference embeds the same texts and the rows are compared.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import counts, harness, traffic, weights
from perfbench.reference import t5 as ref


def _corpus(path: str, name: str, texts: List[str], ids: np.ndarray) -> Any:
    from reprover_tpu_torch.data import Corpus

    premises = [{"full_name": f"Bench.premise_{i}", "code": texts[i],
                 "start": [r + 1, 1], "end": [r + 1, 2]} for r, i in enumerate(ids.tolist())]
    with open(path, "w") as f:
        f.write(json.dumps({"path": name, "imports": [], "premises": premises}) + "\n")
    return Corpus(path)


def _reindex(retriever: Any, corpus: Any, batch: int, cuda: bool,
             times: Optional[List[Tuple[float, float]]] = None) -> torch.Tensor:
    """Bind and embed one shard, and wait for the device; ``times`` gets
    the host's seconds (serialise, tokenise, enqueue) and the wait after."""
    t0 = time.perf_counter()
    retriever.load_corpus(corpus)
    retriever.reindex_corpus(batch)
    t1 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
    if times is not None:
        times.append((t1 - t0, time.perf_counter() - t1))
    return retriever.corpus_embeddings


def _token_counts(texts: List[str], ids: np.ndarray, max_len: int) -> List[int]:
    return [min(len(texts[i].encode("utf-8")) + 1, max_len) for i in ids.tolist()]


def run(ctx: harness.Context) -> harness.Result:
    from reprover_tpu_torch.retrieval.retriever import PremiseRetriever

    from perfbench import trace as tr

    cell, mix, sizes = ctx.cell, ctx.traffic, ctx.sizes
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    if cuda:
        from reprover_tpu_torch.ops.native import load_library

        load_library()
    params = weights.make_t5(sizes, ctx.seed, dev, dtype, encoder_only=True)
    retriever = PremiseRetriever(params, harness.port_t5_config(sizes, dtype),
                                 max_seq_len=cell["max_seq_len"])
    batch, max_len, mult = cell["batch_size"], cell["max_seq_len"], retriever.bucket_multiple

    n, shard = mix["premises"], mix["shard"]
    texts = traffic.texts(traffic.lengths(mix["premise_bytes"], n, ctx.seed), ctx.seed)
    shard_ids = [(j * shard + np.arange(shard)) % n for j in range(mix["shards"])]
    with tempfile.TemporaryDirectory(prefix="perfbench_corpus_") as tmp:
        shards = [_corpus(os.path.join(tmp, f"shard{j}.jsonl"), f"Bench/Shard{j}.lean", texts, ids)
                  for j, ids in enumerate(shard_ids)]
        # One batch at each padded length: rows of 10 bytes under each step.
        lengths = [L - 10 for L in range(mult, counts.padded_length(max_len, mult, max_len) + 1,
                                         mult)]
        warm_texts = traffic.texts(np.repeat(lengths, batch), ctx.seed, stream=9)
        warm = _corpus(os.path.join(tmp, "warm.jsonl"), "Bench/Warm.lean", warm_texts,
                       np.arange(len(warm_texts)))
        # A traced run profiles a smaller shard after the window.
        trace_ids = np.arange(cell["trace_premises"]) % n
        traced_corpus = (_corpus(os.path.join(tmp, "trace.jsonl"), "Bench/Trace.lean", texts,
                                 trace_ids) if ctx.trace and cuda else None)
    batch_lens = [counts.batch_lengths(_token_counts(texts, ids, max_len), batch, mult, max_len)
                  for ids in shard_ids]
    retriever.load_corpus(warm)
    retriever.reindex_corpus(batch)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    traced: Dict[str, Any] = {}
    kept: List[Tuple[int, np.ndarray]] = []  # (premise index, embedding row)
    done, flops = 0, 0.0
    shard_times: List[Tuple[float, float]] = []
    t_open = time.perf_counter()
    j = 0
    while True:
        k = j % len(shards)
        emb = _reindex(retriever, shards[k], batch, cuda, shard_times)
        rng = traffic.rng(ctx.seed, 4, j)
        local = np.concatenate([[int(np.argmax([len(texts[i]) for i in shard_ids[k]]))],
                                rng.choice(shard, cell["check_rows"] - 1, replace=False)])
        rows = emb[torch.as_tensor(local, device=emb.device)].float().cpu().numpy()
        kept += [(int(shard_ids[k][r]), rows[a]) for a, r in enumerate(local.tolist())]
        done += shard
        flops += sum(counts.encoder_flops(sizes, batch, L) for L in batch_lens[k])
        j += 1
        if time.perf_counter() - t_open >= ctx.seconds:
            break
    t_close = time.perf_counter()
    card = harness.card_state() if cuda else "cpu"
    if traced_corpus is not None:
        with tr.profiled(traced):
            emb = _reindex(retriever, traced_corpus, batch, cuda)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None

    w = harness.Window(seconds=t_close - t_open, setup_s=t_open - ctx.started,
                       on_card=cuda)
    w.values.update(premises=done, shards=j)
    if cuda:
        w.values["flops"] = flops
    if traced.get("events"):
        w.trace = tr.reduce(traced.pop("events"))
        traced_lens = counts.batch_lengths(_token_counts(texts, trace_ids, max_len), batch, mult,
                                           max_len)
        w.values["attention_bound_s"] = sizes["num_layers"] * sum(
            counts.encoder_attention_bound_s(sizes, batch, L)[0] for L in traced_lens)

    del retriever, shards, emb
    if cuda:
        torch.cuda.empty_cache()
    checks, w.values["control"], notes = _check(ctx, params, texts, kept)
    notes[:0] = [f"re-indexed {done} premises in {j} shards over {w.seconds!r} s",
                 "shards' host and wait seconds: " + ", ".join(
                     f"{a:.3f}+{b:.3f}" for a, b in shard_times),
                 f"set-up {w.setup_s!r} s; card at the window's close: {card}"]
    return harness.Result(window=w, checks=checks, attempted=done, failed=0,
                          memory_peak_bytes=peak, notes=notes)


def _check(ctx: harness.Context, params: Any, texts: List[str],
           kept: List[Tuple[int, np.ndarray]]
           ) -> Tuple[Dict[str, Dict[str, float]], Dict[str, float], List[str]]:
    cell, sizes = ctx.cell, ctx.sizes
    dev = torch.device(ctx.device)
    params32 = weights.to_float32(params)
    gap = ctl_gap = 0.0
    with ref.exact_matmuls():
        for i, row in kept:
            ids = torch.tensor(harness.byte_ids(texts[i], cell["max_seq_len"]), device=dev)
            want = ref.embed(params32, sizes, ids, "fp32")
            gap = max(gap, float((torch.as_tensor(row, device=dev) - want).norm()))
            if ctx.control:
                low = ref.embed(params32, sizes, ids, "fp8")
                ctl_gap = max(ctl_gap, float((low - want).norm()))
    checks = {"embedding_gap": {"value": gap, "limit": cell["checks"]["embedding_gap"]}}
    control = {"embedding_gap": ctl_gap} if ctx.control else {}
    return checks, control, [f"checked {len(kept)} embeddings"]
