"""Dataset statistics (parity with `/root/reference/scripts/data_stats.py`).

A copy of ``scripts/data_stats.py:1-64`` over the port's ``data/`` (that
script imports the JAX package). Its log lines are the same; host-side only::

    python -m reprover_tpu_torch.scripts.data_stats --data-path <benchmark dir>
"""

import argparse
import json
import logging
from collections import defaultdict
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-path", type=Path, default="data/leandojo_benchmark_4/")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from reprover_tpu_torch.data import Corpus, Pos

    corpus = Corpus(str(args.data_path / "corpus.jsonl"))
    logger.info("number of files: %d", corpus.num_files)
    logger.info("number of premises: %d", len(corpus))

    splits = {
        s: json.load(open(args.data_path / "random" / f"{s}.json"))
        for s in ("train", "val", "test")
    }
    for name, data in splits.items():
        logger.info("number of %s theorems: %d", name, len(data))

    tactics = []
    num_accessible = []
    theorems_by_topic = defaultdict(int)
    for data in splits.values():
        for ex in data:
            parts = ex["file_path"].split("/")
            theorems_by_topic[parts[1] if len(parts) > 1 else parts[0]] += 1
            num_accessible.append(
                len(corpus.get_accessible_premises(ex["file_path"], Pos.of(ex["start"])))
            )
            for t in ex["traced_tactics"]:
                tactics.append(t["annotated_tactic"][0])

    logger.info("number of tactics: %d", len(tactics))
    with_premises = [t for t in tactics if "</a>" in t]
    logger.info("number of tactics with premises: %d", len(with_premises))
    if with_premises:
        logger.info(
            "average premises per tactic (with premises): %s",
            np.mean([t.count("</a>") for t in with_premises]),
        )
    logger.info(
        "average accessible premises per theorem: %s", np.mean(num_accessible)
    )
    logger.info("theorems by topic: %s", dict(theorems_by_topic))


if __name__ == "__main__":
    main()
