"""Export state-tactic pairs in LLaMA-Factory instruction format: a copy of
the JAX package's ``generation/preprocess.py``.

Parity with `reference/generation/preprocess.py:30-37`: the
``[GOAL]\\n{state}\\n[PROOFSTEP]\\n`` template (same template as the
reference's decoder-only serving path, `prover/tactic_generator.py:302`).
:data:`TEMPLATE` is the one copy the port's fine-tuning data module and
decoder-only generator read.

    python -m reprover_tpu_torch.generation.preprocess --data-path DIR --dst-path PREFIX
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random

logger = logging.getLogger(__name__)

TEMPLATE = "[GOAL]\n%s\n[PROOFSTEP]\n"


def preprocess_split(data_path: str, dst_path: str, seed: int = 0) -> int:
    """Shuffle the (state, tactic) pairs of one split (``seed``) and write them
    to ``dst_path`` as LLaMA-Factory instructions; returns their count."""
    with open(data_path) as f:
        theorems = json.load(f)
    pairs = [
        {"state": tac["state_before"], "output": tac["tactic"]}
        for thm in theorems
        for tac in thm["traced_tactics"]
    ]
    random.Random(seed).shuffle(pairs)
    data = [
        {
            "instruction": TEMPLATE % pair["state"],
            "input": "",
            "output": pair["output"],
        }
        for pair in pairs
    ]
    with open(dst_path, "w") as f:
        json.dump(data, f)
    logger.info("%d pairs -> %s", len(data), dst_path)
    return len(data)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--data-path", type=str, default="./data/leandojo_benchmark_4/random"
    )
    parser.add_argument("--dst-path", type=str, default="state_tactic_pairs")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO, force=True)
    for split in ("train", "val"):
        preprocess_split(
            os.path.join(args.data_path, f"{split}.json"),
            f"{args.dst_path}_{split}.json",
        )


if __name__ == "__main__":
    main()
