"""The indexer CLI on 1, 2 and 4 cards: premises/s and the gather's ms.

    python -m reprover_tpu_torch.benchmarks.indexer_scaling [--ranks 1 2 4]
        [--torchrun 4] [--num-files 3000] [--repeats 1] [--device cuda|cpu] [--tiny]

Builds the synthetic corpus (``scripts/make_synthetic_benchmark.py
--num-files N``, 43 premises a file: 129,000 at 3000) and a seeded random
byt5-small encoder written as an HF checkpoint (``--tiny``: 2 layers of
width 32, for a seconds-long CPU run), builds the kernels once, then runs
``python -m reprover_tpu_torch.retrieval.indexer`` at the JAX indexer's
defaults (batch 64, ``max_seq_len`` 1024): for each ``n`` of ``--ranks`` on
the first ``n`` cards (``CUDA_VISIBLE_DEVICES``; the indexer launches its
ranks itself, NCCL), and for each ``n`` of ``--torchrun`` under
``torchrun --standalone --nproc_per_node n``. Each run prints one JSON
line: the premises/s and the gather's ms and bytes that the indexer
printed (its clock runs from the first batch to the whole index on the
device; the gather is one all-reduce of the index's bytes, timed alone),
the process's wall seconds (start-up included), and the largest
gap of its embeddings to the first run's. The card's name and power limit
come first (``nvidia-smi``), then the host seconds that one process takes to
tokenize the corpus into the re-index's batches, which every rank does in
full before it embeds its share.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 0
BATCH, MAX_SEQ_LEN = 64, 1024  # the JAX indexer's defaults
RUN_TIMEOUT_S = 900


def _export_encoder(out: str, tiny: bool) -> None:
    import torch

    from reprover_tpu_torch.models.hf_import import export_hf_t5
    from reprover_tpu_torch.models.t5 import T5Config, byt5_small, init_params

    cfg = (T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                    num_decoder_layers=1) if tiny else byt5_small())
    params = init_params(cfg, torch.Generator().manual_seed(SEED))
    export_hf_t5({"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]},
                 cfg, out, encoder_only=True)


def _tokenize_seconds(ckpt: str, corpus: str) -> Dict[str, object]:
    """Host seconds of the re-index's tokenization of the whole corpus."""
    from reprover_tpu_torch.retrieval import PremiseRetriever

    retriever = PremiseRetriever.load_hf(ckpt, MAX_SEQ_LEN, device="cpu")
    retriever.load_corpus(corpus)
    texts = [p.serialize() for p in retriever.corpus.all_premises]
    t0 = time.perf_counter()
    batches = retriever._tokenize_batches(texts, BATCH)
    return dict(tokenize_s=time.perf_counter() - t0, premises=len(texts), batches=len(batches))


def _run(cmd: List[str], env: Dict[str, str]) -> Dict[str, object]:
    from reprover_tpu_torch.retrieval.indexer import parse_report

    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=RUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if done.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed ({done.returncode}): {done.stderr[-4000:]}")
    return dict(parse_report(done.stdout), wall_s=wall)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ranks", type=int, nargs="*", default=[1, 2, 4])
    parser.add_argument("--torchrun", type=int, nargs="*", default=[4])
    parser.add_argument("--num-files", type=int, default=3000)
    parser.add_argument("--repeats", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--tiny", action="store_true")
    args = parser.parse_args(argv)

    from reprover_tpu_torch.benchmarks.data_parallel_step import card_name
    from reprover_tpu_torch.data import IndexedCorpus
    from reprover_tpu_torch.models.t5 import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        import torch

        from reprover_tpu_torch.ops.native import load_library

        load_library()  # built once here; each run's processes load it
        print(json.dumps({"card": card_name(), "cards": torch.cuda.device_count()}), flush=True)
    with tempfile.TemporaryDirectory(prefix="indexer_scaling_") as work:
        make = os.path.join(REPO, "scripts", "make_synthetic_benchmark.py")
        subprocess.run([sys.executable, make, "--out", work, "--num-files", str(args.num_files),
                        "--num-theorems", "20"], check=True, cwd=REPO, capture_output=True,
                       timeout=600)
        ckpt = os.path.join(work, "ckpt")
        _export_encoder(ckpt, args.tiny)
        print(json.dumps(_tokenize_seconds(ckpt, os.path.join(work, "corpus.jsonl"))), flush=True)
        base = [sys.executable, "-m", "reprover_tpu_torch.retrieval.indexer", "--ckpt-path", ckpt,
                "--corpus-path", os.path.join(work, "corpus.jsonl"), "--batch-size", str(BATCH),
                "--max-seq-len", str(MAX_SEQ_LEN), "--device", args.device]
        runs = [("self", n) for n in args.ranks] + [("torchrun", n) for n in args.torchrun]
        first: Optional[np.ndarray] = None
        for _ in range(args.repeats):
            for launch, n in runs:
                env = dict(os.environ)
                if device.type == "cuda":
                    env["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in range(n))
                out = os.path.join(work, "indexed")
                cmd = base + ["--output-path", out]
                if launch == "torchrun":
                    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(n)] + cmd[1:]
                row = dict(launch=launch, ranks=n, **_run(cmd, env))
                emb = IndexedCorpus.load(out).embeddings
                if first is None:
                    first = emb
                row["max_gap_to_first"] = float(np.abs(emb - first).max())
                shutil.rmtree(out)
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
