"""Convert a training checkpoint of the port to an HF-format directory.

The counterpart of ``scripts/convert_checkpoint.py:1-57`` (parity with
`/root/reference/scripts/convert_checkpoint.py`, Lightning / DeepSpeed -> HF
``save_pretrained``): it reads a checkpoint that the port's
``utils/checkpoint.CheckpointManager`` wrote (``retrieval.main fit`` or
``generation.main fit``: ``<src>/<step>/state.pt``) and writes
``model.safetensors`` and ``config.json`` through
:func:`reprover_tpu_torch.models.hf_import.export_hf_t5`, which
``models/hf_import.load_hf_t5`` and the JAX package's loader read. The
geometry comes from ``--hf-config``, a directory holding an HF
``config.json`` (its weights, if any, are not read). Host-side only::

    python -m reprover_tpu_torch.scripts.convert_checkpoint retriever \
        --src runs/exp/ckpts --hf-config <HF dir> --dst out_dir
"""

import argparse
import json
import logging
import os
from typing import List, Optional

import torch

logger = logging.getLogger(__name__)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("model_type", choices=["generator", "retriever"])
    parser.add_argument("--src", type=str, required=True, help="CheckpointManager directory")
    parser.add_argument(
        "--hf-config",
        type=str,
        required=True,
        help="HF checkpoint dir providing the model geometry (config.json)",
    )
    parser.add_argument("--dst", type=str, required=True)
    parser.add_argument("--step", type=int, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from reprover_tpu_torch.models.hf_import import config_from_hf, export_hf_t5
    from reprover_tpu_torch.utils import CheckpointManager

    encoder_only = args.model_type == "retriever"
    with open(os.path.join(args.hf_config, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    step = args.step if args.step is not None else CheckpointManager(args.src).latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {args.src}")
    saved = torch.load(os.path.join(args.src, str(step), "state.pt"), map_location="cpu",
                       weights_only=True)
    export_hf_t5(saved["params"], cfg, args.dst, encoder_only=encoder_only)
    logger.info("saved HF-format model of step %d to %s", step, args.dst)


if __name__ == "__main__":
    main()
