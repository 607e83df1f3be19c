"""Corpus indexing CLI on the port: embed every premise, save an
``IndexedCorpus`` artifact.

Usage:
    python -m reprover_tpu_torch.retrieval.indexer \
        --ckpt-path PATH/TO/HF_CKPT --corpus-path corpus.jsonl \
        --output-path indexed_corpus/ [--batch-size 64] [--max-seq-len 1024] \
        [--device cuda]

As the JAX indexer forms ``make_mesh()`` over every device, the port's
re-indexes on every card: with ``--device cuda`` on a machine with ``n > 1``
cards it launches one rank per card itself (NCCL); under ``torchrun``
(``torchrun --nproc_per_node n -m reprover_tpu_torch.retrieval.indexer
...``) or inside a process group its caller formed, it joins that group.
Each rank embeds every ``n``-th batch of ``--batch-size`` premises and the
gathered index is whole on every rank; the first rank saves the artifact
and prints the rate while the others wait for it, and a failure on any
rank raises on every rank. After the rate line it prints the re-index's
own spans and counters (``utils/profiling.py``) on that rank: seconds of
serialising, tokenising, the batches' copies to the device and their
enqueue (and under a mesh the gather), the premises and batches that rank
embedded, the share of the padded tokens that are real, and the re-indexes
that reused the tokenized batches, in one line::

    re-index host seconds: serialize 2.890, tokenize 0.440, upload 1.210,
    encode 0.350; embedded 16384 premises in 256 batches; padded tokens
    84.4% real; token cache hits 0

``--device cpu`` runs one process; ``--device cuda`` without a card raises.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from typing import Any, Callable, Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt-path", type=str, required=True)
    parser.add_argument("--corpus-path", type=str, required=True)
    parser.add_argument("--output-path", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--max-seq-len", type=int, default=1024)
    parser.add_argument("--device", type=str, default="cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from reprover_tpu_torch.models.t5 import resolve_device
    from reprover_tpu_torch.parallel.mesh import in_torchrun_env, launch_ranks

    device = resolve_device(args.device)
    if dist.is_initialized() or in_torchrun_env():
        _index(args, device, joined=True)
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        launch_ranks(main, argv, torch.cuda.device_count(), device)
    else:
        _index(args, device, joined=False)


def _index(args: argparse.Namespace, device: Any, joined: bool) -> None:
    """Load, re-index and save, on one process or as a rank of a group."""
    from reprover_tpu_torch.parallel.mesh import init_distributed, is_first_rank, make_mesh

    from reprover_tpu_torch.utils.profiling import counters

    mesh = None
    if joined:
        _, world = init_distributed(device)
        mesh = make_mesh(data=world)  # every rank forms the groups
    retriever = _on_every_rank(mesh, "loading the checkpoint and corpus",
                               lambda: _load(args, mesh, device))

    before = counters()
    t0 = time.perf_counter()
    retriever.reindex_corpus(args.batch_size)
    emb = retriever.corpus_embeddings
    _wait(emb)  # the whole index is on this rank's device
    dt = time.perf_counter() - t0
    gather = "" if mesh is None else (f", gather {_time_gather(emb, mesh):.3f} ms of "
                                      f"{emb.numel() * emb.element_size()} bytes")
    first = is_first_rank(mesh)
    if first:
        n = len(retriever.corpus)
        ranks = "" if mesh is None else f" over {mesh.size} ranks"
        print(f"indexed {n} premises in {dt:.3f}s ({n / max(dt, 1e-9):.1f} premises/s) on "
              f"{device}{ranks}{gather}", flush=True)
        print(_spans_line(before, counters(), mesh is not None), flush=True)
    # Only the first rank copies the index to the host and saves it; the
    # others wait here until its file is whole.
    _on_every_rank(mesh, "saving the index",
                   lambda: first and retriever.to_indexed_corpus().save(args.output_path))
    if first:
        print(f"saved IndexedCorpus to {args.output_path}", flush=True)


def _wait(t: Any) -> None:
    import torch

    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _time_gather(emb: Any, mesh: Any) -> float:
    """ms of one all-reduce of the index's bytes over the mesh's ``data``
    ranks, timed alone: the re-index's own gather has set up the group's
    communicator, and a one-element all-reduce lines the ranks up before the
    clock starts, so no rank's wait for a slower one is counted."""
    import torch
    import torch.distributed as dist

    group = mesh.group("data")
    probe = torch.zeros_like(emb)
    ready = torch.zeros(1, device=emb.device)
    dist.all_reduce(ready, group=group)
    _wait(ready)
    t0 = time.perf_counter()
    dist.all_reduce(probe, group=group)
    _wait(probe)
    return 1e3 * (time.perf_counter() - t0)


def _spans_line(before: Dict[str, float], after: Dict[str, float], gathered: bool) -> str:
    """The re-index's spans and counters between two ``counters()``
    snapshots, as the line :func:`parse_report` reads."""

    def gained(key: str) -> float:
        return after.get(key, 0) - before.get(key, 0)

    parts = ["serialize", "tokenize", "upload", "encode"] + (["gather"] if gathered else [])
    seconds = ", ".join(f"{p} {gained(f'retriever.{p}.seconds'):.3f}" for p in parts)
    padded = gained("retriever.tokens_padded")
    real = 100.0 * gained("retriever.tokens_real") / padded if padded else 0.0
    return (f"re-index host seconds: {seconds}; embedded {int(gained('retriever.premises'))} "
            f"premises in {int(gained('retriever.batches'))} batches; padded tokens "
            f"{real:.1f}% real; token cache hits {int(gained('retriever.token_cache_hits'))}")


def _load(args: argparse.Namespace, mesh: Any, device: Any) -> Any:
    from reprover_tpu_torch.retrieval.retriever import PremiseRetriever

    retriever = PremiseRetriever.load_hf(args.ckpt_path, args.max_seq_len, mesh=mesh,
                                         device=device)
    retriever.load_corpus(args.corpus_path)
    return retriever


def _on_every_rank(mesh: Any, what: str, fn: Callable[[], Any]) -> Any:
    """``fn()``, raising on every rank of ``mesh`` if it raised on any."""
    if mesh is None:
        return fn()
    from reprover_tpu_torch.parallel.collectives import raise_everywhere

    failed = True
    try:
        result = fn()
        failed = False
    finally:
        raise_everywhere(mesh, failed, what)
    return result


SPANS = re.compile(r"re-index host seconds: serialize (\S+), tokenize (\S+), upload (\S+), "
                   r"encode ([^;,\s]+)(?:, gather ([^;\s]+))?; embedded (\d+) premises in "
                   r"(\d+) batches; padded tokens (\S+)% real; token cache hits (\d+)")


def parse_report(printed: str) -> Dict[str, Any]:
    """The numbers of the two lines the indexer prints. The rate line:
    premises, seconds, premises/s, and under a mesh the gather's ms and
    bytes timed alone. The spans line: seconds of serialising
    (``serialize_s``), tokenising, copying up and enqueueing the batches,
    under a mesh of the re-index's own gather (``gather_s``, a slower rank's
    wait included), the premises and batches that rank embedded
    (``embedded_premises``, ``embedded_batches``), ``pad_efficiency_pct``
    and ``token_cache_hits``. None where the lines have none."""
    rate = re.search(r"indexed (\d+) premises in (\S+)s \((\S+) premises/s\)", printed)
    gather = re.search(r"gather (\S+) ms of (\d+) bytes", printed)
    spans = SPANS.search(printed)

    def span(i: int, kind: Callable[[str], Any] = float) -> Any:
        return kind(spans.group(i)) if spans and spans.group(i) is not None else None

    return dict(premises=int(rate.group(1)) if rate else None,
                seconds=float(rate.group(2)) if rate else None,
                premises_per_s=float(rate.group(3)) if rate else None,
                gather_ms=float(gather.group(1)) if gather else None,
                gather_bytes=int(gather.group(2)) if gather else None,
                serialize_s=span(1), tokenize_s=span(2), upload_s=span(3), encode_s=span(4),
                gather_s=span(5), embedded_premises=span(6, int), embedded_batches=span(7, int),
                pad_efficiency_pct=span(8), token_cache_hits=span(9, int))


if __name__ == "__main__":
    main()
