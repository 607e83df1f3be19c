"""Pass@1 prover evaluation CLI on the port's models.

Same flags and defaults as ``python -m reprover_tpu.prover.evaluate``, plus
``--device`` (default ``cuda``; raises when there is no card). The harness
(``evaluate``), the search, the worker pool and the shared
``InferenceService`` are the JAX package's host-side modules, reused as
they are; only the models come from this package.

Not ported yet, and raising ``NotImplementedError`` when asked for:
``--quantize`` (ROADMAP.md Queue 1 item 8), ``--streaming`` (Queue 1 item
6), decoder-only checkpoints (Queue 1 item 7) and ``--approx`` (exact
retrieval only).
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, List, Optional

from reprover_tpu.prover.evaluate import evaluate
from reprover_tpu.prover.tactic_generator import FixedTacticGenerator, TacticGenerator
from reprover_tpu_torch.generation.generator import QUANTIZE_TODO
from reprover_tpu_torch.retrieval.retriever import APPROX_TODO

logger = logging.getLogger(__name__)

STREAMING_TODO = "ROADMAP.md Queue 1 item 6 (streaming serving engine)"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate the prover (Pass@1) on the PyTorch port.")
    parser.add_argument("--data-path", type=str, required=True)
    parser.add_argument("--exp-id", type=str)
    parser.add_argument("--split", choices=["train", "val", "test"], default="val")
    parser.add_argument("--file-path", type=str)
    parser.add_argument("--full-name", type=str)
    parser.add_argument("--name-filter", type=str)
    parser.add_argument("--num-theorems", type=int)
    parser.add_argument("--gen_ckpt_path", type=str)
    parser.add_argument("--ret_ckpt_path", type=str)
    parser.add_argument("--indexed-corpus-path", type=str)
    parser.add_argument("--max-inp-seq-len", type=int, default=2048)
    parser.add_argument("--max-oup-seq-len", type=int, default=512)
    parser.add_argument("--length-penalty", type=float, default=0.0)
    parser.add_argument("--tactic", type=str)
    parser.add_argument("--module", type=str)
    parser.add_argument("--num-sampled-tactics", type=int, default=64)
    parser.add_argument("--timeout", type=int, default=600)
    parser.add_argument("--max-expansions", type=int, default=None)
    parser.add_argument("--num-workers", type=int, default=1)
    parser.add_argument("--save-results", action="store_true")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--quantize", nargs="?", const="int8", default=False, choices=("int8", "int4"),
                        help="not ported yet: raises")
    parser.add_argument("--approx", action="store_true", help="not ported: raises")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="inference-service coalescing cap (requests per device batch)")
    parser.add_argument("--batch-window-ms", type=float, default=5.0,
                        help="inference-service request-coalescing window")
    parser.add_argument("--streaming", action="store_true", help="not ported yet: raises")
    parser.add_argument("--num-slots", type=int, default=8, help="for --streaming")
    parser.add_argument("--chunk-size", type=int, default=8, help="for --streaming")
    parser.add_argument("--chunk-burst", type=int, default=4, help="for --streaming")
    parser.add_argument("--pipeline-depth", type=int, default=4, help="for --streaming")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for the models (default cuda; raises without a card)")
    return parser


def main(argv: Optional[List[str]] = None) -> float:
    args = build_parser().parse_args(argv)
    if not (args.gen_ckpt_path or args.tactic):
        raise SystemExit("one of --gen_ckpt_path or --tactic is required")
    if args.streaming:
        raise NotImplementedError(f"--streaming is not ported yet: {STREAMING_TODO}")
    if args.quantize:
        raise NotImplementedError(f"--quantize is not ported yet: {QUANTIZE_TODO}")
    if args.approx:
        raise NotImplementedError(APPROX_TODO)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from reprover_tpu.prover.environment import LeanDojoEnvironment

    from reprover_tpu_torch.models.t5 import resolve_device

    if args.gen_ckpt_path is not None:
        resolve_device(args.device)
    environment = LeanDojoEnvironment(
        args.timeout, additional_imports=[args.module] if args.module else []
    )
    common = dict(
        exp_id=args.exp_id,
        split=args.split,
        file_path=args.file_path,
        full_name=args.full_name,
        name_filter=args.name_filter,
        num_theorems=args.num_theorems,
        num_sampled_tactics=args.num_sampled_tactics,
        timeout=args.timeout,
        max_expansions=args.max_expansions,
        save_results=args.save_results,
        debug=args.verbose,
    )

    if args.gen_ckpt_path is None:
        # Fixed tactic: no device work — workers run it directly.
        pass_1 = evaluate(
            args.data_path,
            environment,
            FixedTacticGenerator(args.tactic, args.module),
            num_workers=args.num_workers,
            **common,
        )
    elif args.num_workers > 1:
        # One device owner in this process; the searches run in worker
        # processes and reach the models through the shared service.
        from reprover_tpu.prover.service import InferenceService

        from reprover_tpu_torch.generation import TacticGeneratorModel
        from reprover_tpu_torch.retrieval import PremiseRetriever

        model = TacticGeneratorModel.load_hf(
            args.gen_ckpt_path,
            args.max_inp_seq_len,
            args.max_oup_seq_len,
            args.length_penalty,
            quantize=args.quantize,
            device=args.device,
        )
        retriever: Any = None
        if args.indexed_corpus_path is not None:
            retriever = PremiseRetriever.load_hf(
                args.ret_ckpt_path, args.max_inp_seq_len, approximate=args.approx, device=args.device
            )
            retriever.load_corpus(args.indexed_corpus_path)
        service = InferenceService(
            model,
            retriever=retriever,
            max_batch=args.max_batch,
            batch_window_s=args.batch_window_ms / 1000.0,
        )
        service.start()
        try:
            pass_1 = evaluate(
                args.data_path,
                environment,
                FixedTacticGenerator("unused"),  # replaced per worker
                num_workers=args.num_workers,
                make_client=service.client,
                **common,
            )
        finally:
            service.stop()
            logger.info("inference service stats: %s", service.stats_snapshot())
    else:
        from reprover_tpu_torch.prover.tactic_generator import (
            LocalTacticGenerator,
            RetrievalAugmentedTacticGenerator,
        )

        tac_gen: TacticGenerator = LocalTacticGenerator(
            args.gen_ckpt_path,
            args.max_inp_seq_len,
            args.max_oup_seq_len,
            args.length_penalty,
            quantize=args.quantize,
            device=args.device,
        )
        if args.indexed_corpus_path is not None:
            tac_gen = RetrievalAugmentedTacticGenerator(
                tac_gen,
                args.ret_ckpt_path,
                args.indexed_corpus_path,
                args.max_inp_seq_len,
                approximate=args.approx,
                device=args.device,
            )
        pass_1 = evaluate(args.data_path, environment, tac_gen, num_workers=1, **common)

    logger.info("Pass@1: %s", pass_1)
    print(f"Pass@1: {pass_1}")
    return pass_1


if __name__ == "__main__":
    main()
