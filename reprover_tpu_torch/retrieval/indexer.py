"""Corpus indexing CLI on the port: embed every premise, save an
``IndexedCorpus`` artifact (single device).

Usage:
    python -m reprover_tpu_torch.retrieval.indexer \
        --ckpt-path PATH/TO/HF_CKPT --corpus-path corpus.jsonl \
        --output-path indexed_corpus/ [--batch-size 64] [--max-seq-len 1024] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt-path", type=str, required=True)
    parser.add_argument("--corpus-path", type=str, required=True)
    parser.add_argument("--output-path", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--max-seq-len", type=int, default=1024)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from reprover_tpu_torch.retrieval.retriever import PremiseRetriever

    retriever = PremiseRetriever.load_hf(args.ckpt_path, args.max_seq_len, device=args.device)
    retriever.load_corpus(args.corpus_path)

    t0 = time.perf_counter()
    retriever.reindex_corpus(args.batch_size)
    indexed = retriever.to_indexed_corpus()  # waits for the device
    dt = time.perf_counter() - t0
    n = len(retriever.corpus)
    print(f"indexed {n} premises in {dt:.1f}s ({n / max(dt, 1e-9):.1f} premises/s) on {args.device}")

    indexed.save(args.output_path)
    print(f"saved IndexedCorpus to {args.output_path}")


if __name__ == "__main__":
    main()
