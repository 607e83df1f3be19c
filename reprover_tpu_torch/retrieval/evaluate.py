"""Standalone retrieval evaluator: R@1, R@10, MRR from a predictions file.

A copy of ``reprover_tpu/retrieval/evaluate.py:1-87``, which the port may
not import, reading the pickle through the port's
``data/interop.load_reference_pickle`` (so a pickle of either package, or
of the reference, loads). ``python -m reprover_tpu_torch.retrieval.evaluate
--preds-file <predictions.pickle> --data-path <split dir>`` prints one line
per split, as the JAX CLI does. Host-side numpy: it needs no device.

Exact metric semantics of `/root/reference/retrieval/evaluate.py:13-43`:
per tactic, R@k = |top-k ∩ positives| / |positives| (NOT capped at k), MRR =
1/rank of the first positive; tactics with no positives are skipped; results
averaged per split and reported as percentages (R@k) / fraction (MRR).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def build_preds_map(preds: List[Dict[str, Any]]) -> Dict[Tuple, Dict[str, Any]]:
    """Key predictions by (file_path, full_name, start, tactic_idx),
    asserting uniqueness (`retrieval/evaluate.py:66-71`)."""
    preds_map = {
        (p["file_path"], p["full_name"], tuple(p["start"]), p["tactic_idx"]): p
        for p in preds
    }
    assert len(preds) == len(preds_map), "Duplicate predictions found!"
    return preds_map


def evaluate_split(
    data: List[Dict[str, Any]], preds_map: Dict[Tuple, Dict[str, Any]]
) -> Tuple[float, float, float]:
    """(R@1 %, R@10 %, MRR) over one split (`retrieval/evaluate.py:13-43`)."""
    r1: List[float] = []
    r10: List[float] = []
    mrr: List[float] = []

    for thm in data:
        for i, _ in enumerate(thm["traced_tactics"]):
            pred = preds_map[
                (thm["file_path"], thm["full_name"], tuple(thm["start"]), i)
            ]
            all_pos = set(pred["all_pos_premises"])
            if not all_pos:
                continue
            retrieved = pred["retrieved_premises"]
            r1.append(float(retrieved[0] in all_pos) / len(all_pos))
            r10.append(len(all_pos.intersection(retrieved[:10])) / len(all_pos))
            for j, p in enumerate(retrieved):
                if p in all_pos:
                    mrr.append(1.0 / (j + 1))
                    break
            else:
                mrr.append(0.0)

    return 100 * float(np.mean(r1)), 100 * float(np.mean(r10)), float(np.mean(mrr))


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Evaluate the premise retriever.")
    parser.add_argument("--preds-file", type=str, required=True)
    parser.add_argument("--data-path", type=str, required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from reprover_tpu_torch.data.interop import load_reference_pickle

    preds = load_reference_pickle(args.preds_file)
    preds_map = build_preds_map(preds)

    for split in ("train", "val", "test"):
        path = os.path.join(args.data_path, f"{split}.json")
        with open(path) as f:
            data = json.load(f)
        r1, r10, mrr = evaluate_split(data, preds_map)
        logger.info("%s: R@1 = %.4f %%, R@10 = %.4f %%, MRR = %.4f", split, r1, r10, mrr)
        print(f"{split}: R@1 = {r1} %, R@10 = {r10} %, MRR = {mrr}")


if __name__ == "__main__":
    main()
