"""Generation CLI on the port: fit / validate.

The counterpart of ``reprover_tpu.generation.main``: the same dataclasses,
flags and ``confs/generation_*.yaml``, plus ``--device`` (default ``cuda``;
a CUDA device with no card raises). Examples::

    python -m reprover_tpu_torch.generation.main fit \
        --config confs/generation_lean4_random.yaml --trainer.max_steps 1000
    python -m reprover_tpu_torch.generation.main validate \
        --config confs/generation_lean4_random.yaml --ckpt_dir runs/exp1/ckpts
    python -m reprover_tpu_torch.generation.main fit --device cpu \
        --model.tiny true --data.data_path <benchmark split dir> ...

On a card the model computes in bfloat16 over float32 master parameters;
the encoder's self-attention and the teacher-forced decoder's causal self-
and cross-attention, forward and backward, run through the port's CUDA
kernels. On the CPU it computes in float32 (the JAX package's TPU/CPU
rule). Optional end-to-end Pass@1 validation runs when
``eval.num_theorems > 0`` and LeanDojo (or an injected environment) is
available, served by the port's ``InferenceService`` when
``eval.num_workers > 1``.

``--model.remat_policy`` takes ``full``, ``lite`` or ``offload`` and
``--model.offload_optimizer true`` keeps Adam's moments in host memory.
``fit`` is data-parallel by default, as ``retrieval.main fit`` is: on ``n``
cards it launches ``gcd(batch_size, n)`` ranks itself (or joins the group
``torchrun`` gives it), and the cross-entropy is weighted by the global
count of valid tokens; validation runs on the first rank.
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from reprover_tpu_torch.training.loop import TrainerConfig
from reprover_tpu_torch.utils.config import config_to_dict, parse_config

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class ModelConfig:
    model_name: str = "google/byt5-small"
    lr: float = 5e-4
    warmup_steps: int = 2000
    num_beams: int = 1  # beams for validation Top-k accuracy
    length_penalty: float = 0.0
    ret_ckpt_path: Optional[str] = None  # frozen retriever (HF dir)
    random_init: bool = False
    tiny: bool = False  # tiny geometry smoke model
    # Activation checkpointing per layer, default ON as in the JAX package:
    # byt5-small at the reference batch keeps far fewer activations with it.
    remat: bool = True
    remat_policy: str = "full"  # "full", "lite" or "offload" (models/t5.py)
    # Adam's moments in pinned host memory, streamed in for each update.
    offload_optimizer: bool = False


@dataclasses.dataclass
class DataConfig:
    data_path: str = ""
    corpus_path: Optional[str] = None
    preds_path: Optional[str] = None  # retriever predictions.pickle
    batch_size: int = 8
    eval_batch_size: int = 64
    max_inp_seq_len: int = 2300
    max_oup_seq_len: int = 512
    p_drop: float = 0.5


@dataclasses.dataclass
class EndToEndEvalConfig:
    """In-training prover eval (`generation/model.py:212-262`)."""

    num_theorems: int = 0  # 0 disables
    num_workers: int = 5
    timeout: int = 600
    num_sampled_tactics: int = 64


@dataclasses.dataclass
class GenerationConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    eval: EndToEndEvalConfig = dataclasses.field(default_factory=EndToEndEvalConfig)
    seed: int = 3407
    log_dir: Optional[str] = None
    ckpt_dir: Optional[str] = None
    limit_val_batches: Optional[int] = None
    data_parallel: bool = True
    device: str = "cuda"


def _build(cfg: GenerationConfig) -> Tuple[Any, Any, Any]:
    """(data module, generator over float32 master params on the device,
    model config)."""
    from reprover_tpu_torch.generation.datamodule import GeneratorDataModule
    from reprover_tpu_torch.generation.generator import TacticGeneratorModel
    from reprover_tpu_torch.models.hf_import import load_hf_t5
    from reprover_tpu_torch.models.t5 import (
        T5Config,
        byt5_small,
        check_remat_policy,
        default_dtype,
        fuse_mlp_params,
        init_params,
        place_master_params,
        resolve_device,
    )

    device = resolve_device(cfg.device)
    dm = GeneratorDataModule(
        data_path=cfg.data.data_path,
        batch_size=cfg.data.batch_size,
        eval_batch_size=cfg.data.eval_batch_size,
        max_inp_seq_len=cfg.data.max_inp_seq_len,
        max_oup_seq_len=cfg.data.max_oup_seq_len,
        p_drop=cfg.data.p_drop,
        corpus_path=cfg.data.corpus_path,
        preds_path=cfg.data.preds_path,
        seed=cfg.seed,
    )
    dtype = default_dtype(device)
    if cfg.model.tiny:
        model_cfg = T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                             num_decoder_layers=1, compute_dtype=dtype)
        params = init_params(model_cfg, torch.Generator().manual_seed(cfg.seed))
    elif cfg.model.random_init:
        model_cfg = byt5_small(compute_dtype=dtype)
        params = init_params(model_cfg, torch.Generator().manual_seed(cfg.seed))
    else:
        params, model_cfg = load_hf_t5(cfg.model.model_name, compute_dtype=dtype)
    if cfg.model.remat:
        model_cfg = dataclasses.replace(model_cfg, remat=True,
                                        remat_policy=cfg.model.remat_policy)
        check_remat_policy(model_cfg)
    # Fused gate|up MLP layout: one wide matrix product per layer.
    params = place_master_params(fuse_mlp_params(params), device)
    model = TacticGeneratorModel(params, model_cfg, cfg.data.max_inp_seq_len,
                                 cfg.data.max_oup_seq_len, cfg.model.length_penalty)
    return dm, model, model_cfg


def _end_to_end_pass1(
    cfg: GenerationConfig, model: Any, environment: Any = None, retriever: Any = None
) -> float:
    """Run the prover on ``eval.num_theorems`` theorems with the current
    weights; returns Pass@1 (`generation/model.py:227-254`).

    With ``eval.num_workers > 1``, Lean interaction runs in worker processes
    while this process keeps the card and serves all searches through one
    :class:`~reprover_tpu_torch.prover.service.InferenceService`
    (retrieval-augmented when a frozen retriever is configured)."""
    from reprover_tpu_torch.prover.evaluate import evaluate
    from reprover_tpu_torch.prover.tactic_generator import (
        FixedTacticGenerator,
        LocalTacticGenerator,
        RetrievalAugmentedTacticGenerator,
        TacticGenerator,
    )

    if environment is None:
        from reprover_tpu_torch.prover.environment import (
            LeanDojoEnvironment,
            lean_dojo_available,
        )

        if not lean_dojo_available():
            logger.warning("lean_dojo unavailable; skipping end-to-end eval")
            return float("nan")
        environment = LeanDojoEnvironment(cfg.eval.timeout)

    common = dict(
        split="val",
        num_theorems=cfg.eval.num_theorems,
        num_sampled_tactics=cfg.eval.num_sampled_tactics,
        timeout=cfg.eval.timeout,
    )
    if cfg.eval.num_workers > 1:
        from reprover_tpu_torch.prover.service import InferenceService

        service = InferenceService(model, retriever=retriever)
        service.start()
        try:
            return evaluate(
                cfg.data.data_path,
                environment,
                FixedTacticGenerator("unused"),  # replaced per worker
                num_workers=cfg.eval.num_workers,
                make_client=service.client,
                **common,
            )
        finally:
            service.stop()

    tac_gen: TacticGenerator = LocalTacticGenerator(model)
    if retriever is not None:
        tac_gen = RetrievalAugmentedTacticGenerator(tac_gen, retriever)
    return evaluate(cfg.data.data_path, environment, tac_gen, num_workers=1, **common)


def run_fit(cfg: GenerationConfig, environment: Any = None) -> Any:
    """Train; returns the final ``TrainState``. ``environment`` replaces
    LeanDojo in the end-to-end evaluation (tests inject a fake one)."""
    from reprover_tpu_torch.generation.validate import validation_metrics
    from reprover_tpu_torch.parallel.mesh import fit_mesh, is_first_rank
    from reprover_tpu_torch.training.loop import Trainer
    from reprover_tpu_torch.training.tasks import (
        generation_loss,
        init_train_state,
        make_train_step,
        offload_opt_state,
    )
    from reprover_tpu_torch.utils.metrics import MultiWriter, make_writer

    mesh = fit_mesh(cfg.data_parallel, cfg.data.batch_size, cfg.device)
    dm, model, model_cfg = _build(cfg)
    dm.setup("fit")
    state = init_train_state(model.params, cfg.model.lr, cfg.model.warmup_steps)
    if cfg.model.offload_optimizer:
        state = offload_opt_state(state, mesh)
    step_fn = make_train_step(generation_loss, model_cfg, mesh=mesh,
                              offload_opt=cfg.model.offload_optimizer)
    first = is_first_rank(mesh)
    writer = (make_writer(cfg.log_dir, stdout_every=cfg.trainer.log_interval) if first
              else MultiWriter([]))
    writer.write_hparams(config_to_dict(cfg))

    # Frozen retriever for retrieval-augmented end-to-end eval
    # (`generation/model.py:78-84`).
    retriever = None
    if cfg.model.ret_ckpt_path and cfg.data.corpus_path:
        from reprover_tpu_torch.retrieval import PremiseRetriever

        retriever = PremiseRetriever.load_hf(
            cfg.model.ret_ckpt_path, cfg.data.max_inp_seq_len, device=cfg.device
        )
        retriever.load_corpus(cfg.data.corpus_path)

    def validate(train_state: Any, step: int) -> Any:
        model.params = train_state.params
        if not first:
            return {}  # the first rank's metrics reach every rank (Trainer)
        metrics = validation_metrics(
            model,
            dm.val_dataloader(),
            num_beams=cfg.model.num_beams,
            limit_batches=cfg.limit_val_batches,
            writer=writer,
            step=step,
        )
        if cfg.eval.num_theorems > 0:
            metrics["Pass@1_val"] = _end_to_end_pass1(cfg, model, environment, retriever)
        return metrics

    trainer = Trainer(cfg.trainer, step_fn, writer, validate_fn=validate, device=model.device,
                      mesh=mesh)
    try:
        return trainer.fit(state, dm.train_dataloader())
    finally:
        writer.close()


def run_validate(cfg: GenerationConfig) -> Tuple[Any, Any]:
    """Validate (restoring ``cfg.ckpt_dir`` first); returns (metrics,
    generator)."""
    from reprover_tpu_torch.generation.validate import validation_metrics
    from reprover_tpu_torch.training.tasks import TrainState
    from reprover_tpu_torch.utils.checkpoint import CheckpointManager

    dm, model, _ = _build(cfg)
    dm.setup("validate")
    if cfg.ckpt_dir:
        CheckpointManager(cfg.ckpt_dir).restore(TrainState(0, model.params))
    metrics = validation_metrics(
        model,
        dm.val_dataloader(),
        num_beams=cfg.model.num_beams,
        limit_batches=cfg.limit_val_batches,
    )
    for k, v in metrics.items():
        print(f"{k}: {v}")
    return metrics, model


def main(argv: Optional[List[str]] = None) -> Any:
    """Run a subcommand; returns what it returns."""
    from reprover_tpu_torch.parallel.mesh import launch_count, launch_ranks

    logging.basicConfig(level=logging.INFO, force=True)
    argv = list(argv if argv is not None else sys.argv[1:])
    subcommand, cfg = parse_config(GenerationConfig, argv)
    np.random.seed(cfg.seed)
    if subcommand == "fit":
        ranks = launch_count(cfg.data_parallel, cfg.data.batch_size, cfg.device)
        if ranks > 1:
            return launch_ranks(main, argv, ranks, cfg.device)
        return run_fit(cfg)
    if subcommand == "validate":
        return run_validate(cfg)
    raise SystemExit(f"unknown subcommand {subcommand!r} (fit|validate)")


if __name__ == "__main__":
    main()
