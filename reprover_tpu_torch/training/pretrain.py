"""T5 span-corruption pretraining (the ByT5 objective) from corpus text, on
the port: the counterpart of :mod:`reprover_tpu.training.pretrain`.

The reference fine-tunes pretrained ``google/byt5-small``; offline that init
is unavailable, and fine-tuning from random init plateaus. This stage runs
the denoising objective ByT5 was pretrained with (T5 §3.1.4: noise density
15%, mean span 20 bytes) over the premise corpus and exports an HF-layout
directory that the fine-tune CLIs load with ``--model.model_name <dir>``.
Examples::

    python -m reprover_tpu_torch.training.pretrain fit \\
        --data.data_path <benchmark>/corpus.jsonl --trainer.max_steps 1000 \\
        --model.remat_policy lite --export_dir runs/pretrained
    python -m reprover_tpu_torch.training.pretrain fit --device cpu \\
        --model.tiny true --data.data_path corpus.jsonl --data.batch_size 2 \\
        --data.max_inp_seq_len 128 --data.max_oup_seq_len 64

The span corruption and the data module are copies of the JAX package's
(pure numpy, the same RNG streams, so the batches are bit-equal). On a card
the model computes in bfloat16 over float32 master parameters, as
``generation.main`` does, and every attention runs through the kernels at
any geometry (they take any length and head width 64 or 128);
``--model.flash false`` runs the plain attention instead, the JAX package's
A/B switch, never a fallback. ``--model.remat_policy`` (``full``, ``lite``,
``offload``; the JAX package's pretraining has only ``full``) and
``--model.offload_optimizer`` are the other CLIs' options. ``fit`` is
data-parallel by default, as ``retrieval.main fit`` is (``gcd(batch_size,
cards)`` ranks, or the group ``torchrun`` gives it); the first rank alone
probes, logs and exports.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import sys
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from reprover_tpu_torch.tokenizer import BYTE_OFFSET, EOS_ID, VOCAB_SIZE
from reprover_tpu_torch.training.loop import TrainerConfig

logger = logging.getLogger(__name__)

# First sentinel id: <extra_id_0> is the LAST vocab id (HF ByT5 convention),
# successive sentinels descend.
SENTINEL_START = VOCAB_SIZE - 1


# ------------------------------------------------------------------ #
# Span corruption
# ------------------------------------------------------------------ #


def _random_segmentation(num_items: int, num_segments: int, rng: np.random.Generator) -> np.ndarray:
    """Partition ``num_items`` into ``num_segments`` positive integers,
    uniformly over compositions (T5's ``_random_segmentation`` semantics)."""
    assert 1 <= num_segments <= num_items
    # Choose segment boundaries among the num_items-1 gaps.
    cuts = rng.choice(num_items - 1, size=num_segments - 1, replace=False) + 1
    cuts = np.sort(cuts)
    return np.diff(np.concatenate([[0], cuts, [num_items]])).astype(np.int64)


def span_corrupt(
    tokens: np.ndarray,
    rng: np.random.Generator,
    noise_density: float = 0.15,
    mean_span_length: float = 20.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Corrupt a 1-D token window into (inputs, targets).

    Noise tokens are grouped into spans; each span is replaced in the
    inputs by one sentinel, and the targets are the sentinel-delimited
    spans followed by EOS. For a window of W tokens, inputs ~
    W*(1-density)+spans+1 and targets ~ W*density+spans+1.
    """
    length = len(tokens)
    num_noise = int(np.round(length * noise_density))
    num_noise = min(max(num_noise, 1), length - 1)
    num_spans = int(np.round(num_noise / mean_span_length))
    num_spans = min(max(num_spans, 1), num_noise, length - num_noise)

    noise_lens = _random_segmentation(num_noise, num_spans, rng)
    keep_lens = _random_segmentation(length - num_noise, num_spans, rng)

    inputs: List[int] = []
    targets: List[int] = []
    pos = 0
    for k in range(num_spans):
        keep, noise = int(keep_lens[k]), int(noise_lens[k])
        sentinel = SENTINEL_START - k
        inputs.extend(tokens[pos : pos + keep])
        inputs.append(sentinel)
        targets.append(sentinel)
        targets.extend(tokens[pos + keep : pos + keep + noise])
        pos += keep + noise
    inputs.append(EOS_ID)
    targets.append(EOS_ID)
    return np.asarray(inputs, np.int32), np.asarray(targets, np.int32)


def window_length_for(
    max_inp: int, max_tgt: int, noise_density: float, mean_span_length: float
) -> int:
    """Largest window W whose corrupted (inputs, targets) always fit
    (max_inp, max_tgt): the T5 ``random_spans_helper`` role."""

    def lens(w: int) -> Tuple[int, int]:
        num_noise = min(max(int(np.round(w * noise_density)), 1), w - 1)
        num_spans = min(max(int(np.round(num_noise / mean_span_length)), 1), num_noise,
                        w - num_noise)
        return w - num_noise + num_spans + 1, num_noise + num_spans + 1

    w = 2
    while True:
        inp, tgt = lens(w + 1)
        if inp > max_inp or tgt > max_tgt:
            return w
        w += 1


# ------------------------------------------------------------------ #
# Data pipeline
# ------------------------------------------------------------------ #


def corpus_text(data_path: str) -> str:
    """All premise serializations of a LeanDojo-format ``corpus.jsonl``,
    newline-joined in file order."""
    chunks: List[str] = []
    with open(data_path) as f:
        for line in f:
            rec = json.loads(line)
            for prem in rec["premises"]:
                chunks.append(prem["code"])
    return "\n\n".join(chunks)


class PretrainDataModule:
    """Fixed-shape span-corruption batches from one byte stream.

    The corpus is tokenized once into a flat id array; each example is a
    random window, corrupted on the host and padded to the static
    (max_inp, max_tgt) shapes. A held-out tail of the stream feeds
    validation; it must hold more than one window, or drawing a val batch
    raises (as in the JAX package).
    """

    def __init__(
        self,
        data_path: str,
        batch_size: int = 8,
        max_inp_seq_len: int = 1024,
        max_oup_seq_len: int = 256,
        noise_density: float = 0.15,
        mean_span_length: float = 20.0,
        val_fraction: float = 0.01,
        steps_per_epoch: int = 1000,
        seed: int = 0,
    ) -> None:
        self.batch_size = batch_size
        self.max_inp = max_inp_seq_len
        self.max_tgt = max_oup_seq_len
        self.noise_density = noise_density
        self.mean_span_length = mean_span_length
        self.steps_per_epoch = steps_per_epoch
        self.seed = seed

        text = corpus_text(data_path)
        ids = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)
        ids += BYTE_OFFSET
        split = int(len(ids) * (1.0 - val_fraction))
        self.train_ids = ids[:split]
        self.val_ids = ids[split:]
        self.window = window_length_for(self.max_inp, self.max_tgt, noise_density,
                                        mean_span_length)
        logger.info("pretrain stream: %.1f MB train, %.1f MB val, window %d bytes",
                    len(self.train_ids) / 1e6, len(self.val_ids) / 1e6, self.window)

    def _batch(self, ids: np.ndarray, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        b = self.batch_size
        inp = np.zeros((b, self.max_inp), np.int32)
        mask = np.zeros((b, self.max_inp), np.int32)
        tgt = np.full((b, self.max_tgt), -100, np.int32)  # -100 = CE-masked
        starts = rng.integers(0, len(ids) - self.window, b)
        for i, s in enumerate(starts):
            x, y = span_corrupt(ids[s : s + self.window], rng, self.noise_density,
                                self.mean_span_length)
            inp[i, : len(x)] = x
            mask[i, : len(x)] = 1
            tgt[i, : len(y)] = y
        return {"state_ids": inp, "state_mask": mask, "tactic_ids": tgt}

    def train_dataloader(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        while True:  # infinite stream; the Trainer stops at max_steps
            yield self._batch(self.train_ids, rng)

    def val_batches(self, num_batches: int = 8) -> List[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + 1)  # fixed val sample
        return [self._batch(self.val_ids, rng) for _ in range(num_batches)]


# ------------------------------------------------------------------ #
# CLI
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class PretrainModelConfig:
    lr: float = 1e-3
    warmup_steps: int = 1000
    tiny: bool = False
    remat: bool = True
    remat_policy: str = "full"  # "full", "lite" or "offload" (models/t5.py)
    offload_optimizer: bool = False
    # Bug-isolation A/B (--model.flash false): pretrain with the plain
    # attention instead of the kernels.
    flash: bool = True
    # Custom geometry (None -> google/byt5-small value); pretraining must
    # match the geometry the fine-tune will load.
    d_model: Optional[int] = None
    d_kv: Optional[int] = None
    d_ff: Optional[int] = None
    num_heads: Optional[int] = None
    num_encoder_layers: Optional[int] = None
    num_decoder_layers: Optional[int] = None


@dataclasses.dataclass
class PretrainDataConfig:
    data_path: str = ""  # corpus.jsonl
    batch_size: int = 8
    max_inp_seq_len: int = 1024
    max_oup_seq_len: int = 256
    noise_density: float = 0.15
    mean_span_length: float = 20.0


def _default_trainer() -> TrainerConfig:
    return TrainerConfig(
        max_steps=100_000,
        val_interval=2_000,
        monitor="loss_val",
        monitor_mode="min",
        patience=10,
        # Pretraining is where the warmup-peak blow-up happened (lr 1e-3 at
        # 300M, training/health.py); the guard is on by default.
        divergence_factor=1.5,
    )


@dataclasses.dataclass
class PretrainConfig:
    model: PretrainModelConfig = dataclasses.field(default_factory=PretrainModelConfig)
    data: PretrainDataConfig = dataclasses.field(default_factory=PretrainDataConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=_default_trainer)
    seed: int = 3407
    log_dir: Optional[str] = None
    export_dir: Optional[str] = None  # HF-layout dir for the fine-tune CLIs
    data_parallel: bool = True
    device: str = "cuda"


GEOMETRY = ("d_model", "d_kv", "d_ff", "num_heads", "num_encoder_layers", "num_decoder_layers")


def _model_config(cfg: PretrainConfig, dtype: Any) -> Any:
    from reprover_tpu_torch.models.t5 import T5Config, byt5_small, check_remat_policy

    if cfg.model.tiny:
        model_cfg = T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                             num_decoder_layers=1, compute_dtype=dtype)
    else:
        overrides = {k: v for k in GEOMETRY if (v := getattr(cfg.model, k)) is not None}
        model_cfg = byt5_small(compute_dtype=dtype, **overrides)
    if cfg.model.remat:
        model_cfg = dataclasses.replace(model_cfg, remat=True,
                                        remat_policy=cfg.model.remat_policy)
        check_remat_policy(model_cfg)
    return model_cfg


def run_fit(cfg: PretrainConfig) -> Any:
    """Pretrain; export to ``cfg.export_dir`` if set; returns the final
    ``TrainState``."""
    import torch

    from reprover_tpu_torch.models.t5 import (
        default_dtype,
        encode,
        fuse_mlp_params,
        init_params,
        place_master_params,
        resolve_device,
    )
    from reprover_tpu_torch.ops.flash_attention import (
        encoder_attention_reference,
        encoder_flash_attention,
    )
    from reprover_tpu_torch.ops.pooling import masked_mean_normalize
    from reprover_tpu_torch.parallel.mesh import fit_mesh, is_first_rank
    from reprover_tpu_torch.training.health import embedding_anisotropy, embedding_eff_rank
    from reprover_tpu_torch.training.loop import Trainer
    from reprover_tpu_torch.training.tasks import (
        generation_loss,
        init_train_state,
        make_eval_step,
        make_train_step,
        numeric_batch,
        offload_opt_state,
    )
    from reprover_tpu_torch.utils.config import config_to_dict
    from reprover_tpu_torch.utils.metrics import MultiWriter, make_writer

    mesh = fit_mesh(cfg.data_parallel, cfg.data.batch_size, cfg.device)
    device = resolve_device(cfg.device)
    dm = PretrainDataModule(
        data_path=cfg.data.data_path,
        batch_size=cfg.data.batch_size,
        max_inp_seq_len=cfg.data.max_inp_seq_len,
        max_oup_seq_len=cfg.data.max_oup_seq_len,
        noise_density=cfg.data.noise_density,
        mean_span_length=cfg.data.mean_span_length,
        seed=cfg.seed,
    )
    model_cfg = _model_config(cfg, default_dtype(device))
    params = init_params(model_cfg, torch.Generator().manual_seed(cfg.seed))
    # Fused gate|up MLP layout: one wide matrix product per layer (the
    # export splits it again).
    params = place_master_params(fuse_mlp_params(params), device)

    state = init_train_state(params, cfg.model.lr, cfg.model.warmup_steps)
    if cfg.model.offload_optimizer:
        state = offload_opt_state(state, mesh)
    loss_fn = functools.partial(generation_loss, flash_attention=cfg.model.flash)
    step_fn = make_train_step(loss_fn, model_cfg, mesh=mesh,
                              offload_opt=cfg.model.offload_optimizer)
    eval_step = make_eval_step(loss_fn, model_cfg, mesh=mesh)
    first = is_first_rank(mesh)
    writer = (make_writer(cfg.log_dir, stdout_every=cfg.trainer.log_interval) if first
              else MultiWriter([]))
    writer.write_hparams(config_to_dict(cfg))
    val_batches = [numeric_batch(b, device) for b in dm.val_batches()]

    # Representation-health probe (training/health.py): the pooled
    # embeddings of one fixed val batch, every validation. A healthy encoder
    # probes an effective rank >> 1 and cos_offdiag_std ~0.03; a collapsed
    # one ~1.2 and < 0.001.
    attention_fn = encoder_flash_attention if cfg.model.flash else encoder_attention_reference

    def validate(train_state: Any, step: int) -> Dict[str, float]:
        losses = [float(eval_step(train_state.params, b)) for b in val_batches]
        if not first:
            return {}  # the first rank's metrics reach every rank (Trainer)
        metrics = {"loss_val": float(np.mean(losses))}
        if val_batches:
            probe = val_batches[0]
            with torch.no_grad():
                hidden = encode(train_state.params, model_cfg, probe["state_ids"],
                                probe["state_mask"], attention_fn)
                emb = masked_mean_normalize(hidden, probe["state_mask"]).float().cpu().numpy()
            metrics["emb_eff_rank"] = embedding_eff_rank(emb)
            metrics.update(embedding_anisotropy(emb))
        return metrics

    trainer = Trainer(cfg.trainer, step_fn, writer, validate_fn=validate, device=device,
                      mesh=mesh)
    try:
        state = trainer.fit(state, dm.train_dataloader())
    finally:
        writer.close()
    if cfg.export_dir and first:
        export(state.params, model_cfg, cfg.export_dir)
    return state


def export(params: Dict, model_cfg: Any, out_dir: str) -> None:
    """HF-layout export (float32) that the fine-tune CLIs load through
    ``--model.model_name <out_dir>``."""
    from reprover_tpu_torch.models.hf_import import export_hf_t5

    export_hf_t5(params, model_cfg, out_dir)
    logger.info("exported pretrained checkpoint to %s", out_dir)


def main(argv: Optional[List[str]] = None) -> Any:
    """Run a subcommand; returns what it returns."""
    from reprover_tpu_torch.utils.config import parse_config

    from reprover_tpu_torch.parallel.mesh import launch_count, launch_ranks

    logging.basicConfig(level=logging.INFO, force=True)
    argv = list(argv if argv is not None else sys.argv[1:])
    subcommand, cfg = parse_config(PretrainConfig, argv)
    np.random.seed(cfg.seed)
    if subcommand == "fit":
        ranks = launch_count(cfg.data_parallel, cfg.data.batch_size, cfg.device)
        if ranks > 1:
            return launch_ranks(main, argv, ranks, cfg.device)
        return run_fit(cfg)
    raise SystemExit(f"unknown subcommand {subcommand!r} (fit)")


if __name__ == "__main__":
    main()
