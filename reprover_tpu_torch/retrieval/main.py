"""Retrieval CLI on the port: fit / validate / predict.

The counterpart of ``reprover_tpu.retrieval.main``: the same dataclasses,
flags, field link (data.max_seq_len -> model.max_seq_len) and
``confs/retrieval_*.yaml``, plus ``--device`` (default ``cuda``; a CUDA
device with no card raises). Examples::

    python -m reprover_tpu_torch.retrieval.main fit \
        --config confs/retrieval_lean4_random_infonce.yaml --trainer.max_steps 1000
    python -m reprover_tpu_torch.retrieval.main validate --config conf.yaml \
        --ckpt_dir runs/exp1/ckpts
    python -m reprover_tpu_torch.retrieval.main predict --config conf.yaml \
        --ckpt_dir runs/exp1/ckpts --preds_out predictions.pickle

On a card the encoder computes in bfloat16 over float32 master parameters
and its attention (forward and backward) runs through the port's CUDA
kernels; on the CPU it computes in float32 (the JAX package's TPU/CPU
rule). The data module is the port's copy of the JAX package's. Only the
encoder's parameters are built and trained.

Not ported (each raises with a pointer into ROADMAP.md): ``--model.approx``,
``--model.offload_optimizer``, remat policies other than ``full``, and
``--data_parallel`` over more than one card.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from reprover_tpu_torch.training.loop import TrainerConfig
from reprover_tpu_torch.utils.config import config_to_dict, parse_config

logger = logging.getLogger(__name__)

DATA_PARALLEL_TODO = (
    "data-parallel training over {} cards is not ported; pass --data_parallel false "
    "(ROADMAP.md Queue 1 item 10)"
)


@dataclasses.dataclass
class ModelConfig:
    model_name: str = "google/byt5-small"
    lr: float = 1e-4
    warmup_steps: int = 2000
    max_seq_len: int = 1024  # linked from data
    num_retrieved: int = 100
    random_init: bool = False  # skip HF weights (tests/smoke)
    tiny: bool = False  # tiny geometry smoke model (cli_dummy.yaml analog)
    approx: bool = False  # approximate top-k: not ported, raises
    # Activation checkpointing per encoder layer (default ON, as in the JAX
    # package: byt5-small at the reference batch needs it to fit).
    remat: bool = True
    remat_policy: str = "full"  # "lite" and "offload" are not ported
    offload_optimizer: bool = False  # not ported, raises
    # "mse" = the reference's label-matrix MSE; "infonce" = multi-positive
    # contrastive (the recipe that trains from random init).
    loss: str = "mse"


@dataclasses.dataclass
class DataConfig:
    data_path: str = ""
    corpus_path: str = ""
    num_negatives: int = 3
    num_in_file_negatives: int = 1
    batch_size: int = 8
    eval_batch_size: int = 64
    max_seq_len: int = 1024
    strict_negatives: bool = False


@dataclasses.dataclass
class RetrievalConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    seed: int = 3407
    log_dir: Optional[str] = None
    ckpt_dir: Optional[str] = None  # restore-from for validate/predict
    preds_out: str = "predictions.pickle"
    data_parallel: bool = True
    device: str = "cuda"


LINKS = [("data.max_seq_len", "model.max_seq_len")]


def _build(cfg: RetrievalConfig) -> Tuple[Any, Any, Any]:
    """(data module, retriever over float32 master params on the device,
    model config)."""
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
    from reprover_tpu_torch.retrieval.datamodule import RetrievalDataModule
    from reprover_tpu_torch.retrieval.retriever import APPROX_TODO, PremiseRetriever
    from reprover_tpu_torch.training.tasks import OFFLOAD_OPT_TODO

    if cfg.model.approx:
        raise NotImplementedError(APPROX_TODO)
    if cfg.model.offload_optimizer:
        raise NotImplementedError(OFFLOAD_OPT_TODO)
    if cfg.model.loss not in ("mse", "infonce"):
        raise ValueError(f"--model.loss must be 'mse' or 'infonce', got {cfg.model.loss!r}")
    device = resolve_device(cfg.device)
    if cfg.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(DATA_PARALLEL_TODO.format(torch.cuda.device_count()))
    dtype = default_dtype(device)
    if cfg.model.tiny:
        model_cfg = T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                             num_decoder_layers=1, compute_dtype=dtype)
        params = init_params(model_cfg, torch.Generator().manual_seed(cfg.seed))
    elif cfg.model.random_init:
        model_cfg = byt5_small(compute_dtype=dtype)
        params = init_params(model_cfg, torch.Generator().manual_seed(cfg.seed))
    else:
        params, model_cfg = load_hf_t5(cfg.model.model_name, encoder_only=True,
                                       compute_dtype=dtype)
    params = {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}
    if cfg.model.remat:
        model_cfg = dataclasses.replace(model_cfg, remat=True,
                                        remat_policy=cfg.model.remat_policy)
        check_remat_policy(model_cfg)

    dm = RetrievalDataModule(
        data_path=cfg.data.data_path,
        corpus_path=cfg.data.corpus_path,
        num_negatives=cfg.data.num_negatives,
        num_in_file_negatives=cfg.data.num_in_file_negatives,
        batch_size=cfg.data.batch_size,
        eval_batch_size=cfg.data.eval_batch_size,
        max_seq_len=cfg.data.max_seq_len,
        seed=cfg.seed,
        strict_negatives=cfg.data.strict_negatives,
    )
    # Fused gate|up MLP layout: one wide matrix product per layer.
    params = place_master_params(fuse_mlp_params(params), device)
    retriever = PremiseRetriever(params, model_cfg, max_seq_len=cfg.model.max_seq_len,
                                 num_retrieved=cfg.model.num_retrieved)
    retriever.load_corpus(dm.corpus)
    return dm, retriever, model_cfg


def run_fit(cfg: RetrievalConfig) -> Any:
    """Train; returns the final ``TrainState``."""
    from reprover_tpu_torch.retrieval.prediction import validation_metrics
    from reprover_tpu_torch.training.loop import Trainer
    from reprover_tpu_torch.training.tasks import (
        init_train_state,
        make_train_step,
        retrieval_infonce_loss,
        retrieval_loss,
    )
    from reprover_tpu_torch.utils.metrics import make_writer

    dm, retriever, model_cfg = _build(cfg)
    dm.setup("fit")
    state = init_train_state(retriever.params, cfg.model.lr, cfg.model.warmup_steps)
    loss_fn = retrieval_loss if cfg.model.loss == "mse" else retrieval_infonce_loss
    step_fn = make_train_step(loss_fn, model_cfg)
    writer = make_writer(cfg.log_dir, stdout_every=cfg.trainer.log_interval)
    writer.write_hparams(config_to_dict(cfg))

    def validate(train_state: Any, step: int) -> Any:
        retriever.params = train_state.params
        retriever.mark_stale()
        return validation_metrics(retriever, dm.val_dataloader(), cfg.model.num_retrieved)

    trainer = Trainer(cfg.trainer, step_fn, writer, validate_fn=validate,
                      on_train_batch_end=retriever.mark_stale, device=retriever.device)
    try:
        return trainer.fit(state, dm.train_dataloader())
    finally:
        writer.close()


def _restore_params(cfg: RetrievalConfig, retriever: Any) -> None:
    """Load ``cfg.ckpt_dir``'s latest parameters into the retriever's."""
    if cfg.ckpt_dir:
        from reprover_tpu_torch.training.tasks import TrainState
        from reprover_tpu_torch.utils.checkpoint import CheckpointManager

        CheckpointManager(cfg.ckpt_dir).restore(TrainState(0, retriever.params))
        retriever.mark_stale()


def run_validate(cfg: RetrievalConfig) -> Tuple[Any, Any]:
    """Validate (restoring ``cfg.ckpt_dir`` first); returns (metrics,
    retriever)."""
    from reprover_tpu_torch.retrieval.prediction import validation_metrics

    dm, retriever, _ = _build(cfg)
    dm.setup("validate")
    _restore_params(cfg, retriever)
    metrics = validation_metrics(retriever, dm.val_dataloader(), cfg.model.num_retrieved)
    for k in ("Recall@1_val", "Recall@10_val", "MRR"):
        print(f"{k}: {metrics.get(k)}")
    return metrics, retriever


def run_predict(cfg: RetrievalConfig) -> List[Any]:
    """Write the predictions pickle; returns its records."""
    from reprover_tpu_torch.retrieval.prediction import predict, save_predictions

    dm, retriever, _ = _build(cfg)
    dm.setup("predict")
    _restore_params(cfg, retriever)
    outputs = predict(retriever, dm.predict_dataloader(), cfg.model.num_retrieved)
    out = os.path.join(cfg.log_dir, cfg.preds_out) if cfg.log_dir else cfg.preds_out
    save_predictions(outputs, out)
    return outputs


def main(argv: Optional[List[str]] = None) -> Any:
    """Run a subcommand; returns what it returns."""
    logging.basicConfig(level=logging.INFO, force=True)
    subcommand, cfg = parse_config(
        RetrievalConfig, argv if argv is not None else sys.argv[1:], links=LINKS
    )
    np.random.seed(cfg.seed)
    if subcommand == "fit":
        return run_fit(cfg)
    if subcommand == "validate":
        return run_validate(cfg)
    if subcommand == "predict":
        return run_predict(cfg)
    raise SystemExit(f"unknown subcommand {subcommand!r} (fit|validate|predict)")


if __name__ == "__main__":
    main()
