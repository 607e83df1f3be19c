"""Pass@1 prover evaluation: the harness and its CLI on the port's models.

The harness (:func:`get_theorems`, :func:`aggregate_pass1`,
:func:`evaluate`) is a copy of the JAX package's ``prover/evaluate.py``.
Parity with `reference/prover/evaluate.py`:

- theorem selection with ``file_path`` / ``full_name`` / md5-prefix
  ``name_filter`` / ``num_theorems`` filters (`evaluate.py:59-71`);
- deterministic md5-based shuffle-sort of (file_path, full_name) so
  distributed eval runs are shardable without coordination
  (`evaluate.py:72-81`);
- Pass@1 = proved / (proved + failed); ``None`` results (init failures)
  discarded from the denominator (`evaluate.py:146-162`);
- optional results pickle (`evaluate.py:164-170`).

The environment is injected (real LeanDojo or a fake), so the harness runs
unmodified in tests and in production.

The CLI has the JAX one's flags and defaults, plus ``--device`` (default
``cuda``; raises when there is no card): ByT5 and decoder-only (LLaMA-family)
checkpoints, ``--quantize [int8|int4]``, ``--streaming`` (token-level
continuous batching through :class:`StreamingInferenceService`) and
``--approx`` (the JAX package's ``lax.approx_max_k`` retrieval; exact, as
XLA computes it off a TPU: ``PremiseRetriever.load_hf``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import pickle
import uuid
from typing import Any, List, Optional, Tuple

from reprover_tpu_torch.data import Pos
from reprover_tpu_torch.prover.distributed import DistributedProver
from reprover_tpu_torch.prover.environment import Environment, RepoSpec, Theorem
from reprover_tpu_torch.prover.proof_search import SearchResult
from reprover_tpu_torch.prover.search_tree import Status
from reprover_tpu_torch.prover.tactic_generator import FixedTacticGenerator, TacticGenerator

logger = logging.getLogger(__name__)


def get_theorems(
    data_path: str,
    split: str = "val",
    file_path: Optional[str] = None,
    full_name: Optional[str] = None,
    name_filter: Optional[str] = None,
    num_theorems: Optional[int] = None,
) -> Tuple[List[Theorem], List[Pos]]:
    """Load + filter + md5-sort theorems from a LeanDojo benchmark split."""
    with open(os.path.join(data_path, f"{split}.json")) as f:
        data = json.load(f)

    selected = []
    for t in data:
        if file_path is not None and t["file_path"] != file_path:
            continue
        if full_name is not None and t["full_name"] != full_name:
            continue
        if name_filter is not None and not hashlib.md5(
            t["full_name"].encode()
        ).hexdigest().startswith(name_filter):
            continue
        repo = RepoSpec(t["url"], t["commit"])
        selected.append(
            (Theorem(repo, t["file_path"], t["full_name"]), Pos.of(t["start"]))
        )
    assert len(selected) > 0, "no theorems matched the filters"

    # Deterministic shuffle: sort by md5("file_path:full_name")
    # (`evaluate.py:72-81`).
    selected.sort(
        key=lambda tp: hashlib.md5(
            f"{tp[0].file_path}:{tp[0].full_name}".encode()
        ).hexdigest()
    )
    if num_theorems is not None:
        selected = selected[:num_theorems]
    logger.info("%d theorems loaded from %s", len(selected), data_path)

    theorems = [t for t, _ in selected]
    positions = [p for _, p in selected]
    return theorems, positions


def aggregate_pass1(results: List[Optional[SearchResult]]) -> float:
    """Pass@1 with init-failure discards (`evaluate.py:146-162`)."""
    num_proved = num_failed = num_discarded = 0
    for r in results:
        if r is None:
            num_discarded += 1
        elif r.status == Status.PROVED:
            num_proved += 1
        else:
            num_failed += 1
    logger.info(
        "evaluation done: %d proved, %d failed, %d discarded",
        num_proved,
        num_failed,
        num_discarded,
    )
    if num_proved + num_failed == 0:
        return float("nan")
    return num_proved / (num_proved + num_failed)


def evaluate(
    data_path: str,
    environment: Environment,
    tac_gen: TacticGenerator,
    exp_id: Optional[str] = None,
    split: str = "val",
    file_path: Optional[str] = None,
    full_name: Optional[str] = None,
    name_filter: Optional[str] = None,
    num_theorems: Optional[int] = None,
    num_sampled_tactics: int = 64,
    timeout: float = 600,
    max_expansions: Optional[int] = None,
    num_workers: int = 1,
    save_results: bool = False,
    debug: bool = False,
    make_client: Any = None,
    return_results: bool = False,
) -> Any:
    """End-to-end prover evaluation -> Pass@1 (`evaluate.py:94-172`).

    ``return_results=True`` returns ``(pass_1, results)`` so callers (e.g.
    the failure-attribution harness, the JAX package's
    ``prover.attribution``)
    can inspect per-theorem :class:`SearchResult` records without a pickle
    round-trip."""
    theorems, positions = get_theorems(
        data_path, split, file_path, full_name, name_filter, num_theorems
    )
    prover = DistributedProver(
        tac_gen,
        environment,
        num_workers,
        timeout=timeout,
        max_expansions=max_expansions,
        num_sampled_tactics=num_sampled_tactics,
        debug=debug,
        make_client=make_client,
    )
    results = prover.search_unordered(theorems, positions)
    pass_1 = aggregate_pass1(results)

    if save_results:
        exp_id = exp_id or str(uuid.uuid4())
        pickle_path = f"{exp_id}_results.pickle"
        with open(pickle_path, "wb") as f:
            pickle.dump(results, f)
        logger.info("results saved to %s", pickle_path)
    if return_results:
        return pass_1, results
    return pass_1


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's flags and defaults, plus ``--device``."""
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
                        help="weight-only quantized generator serving: bare flag or 'int8' "
                        "(half the weight bytes), 'int4' (a quarter)")
    parser.add_argument("--approx", action="store_true",
                        help="approximate top-k retrieval (exact off a TPU, as in the JAX package)")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="inference-service coalescing cap (requests per device batch)")
    parser.add_argument("--batch-window-ms", type=float, default=5.0,
                        help="inference-service request-coalescing window")
    parser.add_argument("--streaming", action="store_true",
                        help="token-level continuous batching (the stepwise engine) instead of "
                        "request coalescing")
    parser.add_argument("--num-slots", type=int, default=8,
                        help="concurrent decode slots for --streaming")
    parser.add_argument("--chunk-size", type=int, default=8,
                        help="decoder steps per chunk for --streaming (admission latency vs "
                        "per-chunk host round trips)")
    parser.add_argument("--chunk-burst", type=int, default=4,
                        help="backlog-empty step horizon = chunk-size * chunk-burst for "
                        "--streaming (a chunk stops early on a finish event)")
    parser.add_argument("--pipeline-depth", type=int, default=4,
                        help="chunks dispatched ahead of status retirement for --streaming")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for the models (default cuda; raises without a card)")
    return parser


def build_service(args: argparse.Namespace, model: Any, retriever: Any = None) -> Any:
    """The inference service the CLI's flags ask for: the streaming one
    (``--streaming``, its slots, chunk, burst and depth; beam width
    ``--num-sampled-tactics``) or the request-coalescing one."""
    from reprover_tpu_torch.prover.service import InferenceService, StreamingInferenceService

    if args.streaming:
        return StreamingInferenceService(
            model,
            retriever=retriever,
            num_slots=args.num_slots,
            num_beams=args.num_sampled_tactics,
            chunk_size=args.chunk_size,
            chunk_burst=args.chunk_burst,
            pipeline_depth=args.pipeline_depth,
        )
    return InferenceService(
        model,
        retriever=retriever,
        max_batch=args.max_batch,
        batch_window_s=args.batch_window_ms / 1000.0,
    )


def main(argv: Optional[List[str]] = None) -> float:
    args = build_parser().parse_args(argv)
    if not (args.gen_ckpt_path or args.tactic):
        raise SystemExit("one of --gen_ckpt_path or --tactic is required")
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    from reprover_tpu_torch.models.t5 import resolve_device
    from reprover_tpu_torch.prover.environment import LeanDojoEnvironment

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
        from reprover_tpu_torch.prover.tactic_generator import load_generator_model
        from reprover_tpu_torch.retrieval import PremiseRetriever

        # Decoder-only checkpoints get the causal wrapper; both service
        # modes serve either family.
        model = load_generator_model(
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
        service = build_service(args, model, retriever)
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
