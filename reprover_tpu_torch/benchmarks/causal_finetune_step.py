"""Decoder-only fine-tuning step: plain against fused attention.

The port's counterpart of the JAX package's
``benchmarks/causal_finetune_step.py``: one AdamW step
(:func:`~reprover_tpu_torch.training.tasks.init_train_state`, global-norm
clipping then AdamW) over
:func:`~reprover_tpu_torch.models.causal_lm.causal_lm_loss`, first with the
plain ``[B, H, T, T]`` attention and then with ``flash_attention=True`` (the
scaled causal CUDA kernels, forward and backward), repeated ``--steps``
times on one fixed batch from the same seeded weights.

    python -m reprover_tpu_torch.benchmarks.causal_finetune_step [--batch 8] [--seq 2048]
        [--steps 8] [--geometry jax|llama7b] [--layers N] [--ragged] [--device cuda]

Geometries: ``jax`` is the JAX benchmark's (vocab 4096, d_model 1024, 8
layers, 16 heads x 64, 8 KV heads, d_ff 2816); ``llama7b`` is LLaMA-7B's
width (vocab 32000, d_model 4096, 32 heads x 128, 32 KV heads, d_ff 11008)
at ``--layers`` (default 4 of its 32: float32 masters, gradients and Adam's
two moments take 16 bytes a parameter, ~108 GB at full depth, more than one
80 GB card). Weights are float32 masters, products in bf16 on the card
(float32 on the CPU). Each run prints one JSON line: steps/s, ms/step split
into forward, backward and optimizer by CUDA events (means over the steps
after the first), the first step's ms, peak device memory, and the losses.
A run that does not fit prints the error instead, as the JAX benchmark does
(the fused attention making a shape fit is then the result). The bound
beside the model's operations is the H100's 989 TFLOP/s bf16 dense rate.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from reprover_tpu_torch.models.causal_lm import CausalLMConfig, causal_lm_loss, init_params
from reprover_tpu_torch.models.t5 import default_dtype, resolve_device
from reprover_tpu_torch.training.tasks import (
    TrainState, init_train_state, param_leaves, timed_train_steps,
)

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
LR, SEED = 1e-4, 0
GEOMETRIES = {
    "jax": dict(vocab_size=4096, d_model=1024, num_layers=8, num_heads=16, num_kv_heads=8,
                   d_ff=2816),
    "llama7b": dict(vocab_size=32000, d_model=4096, num_layers=4, num_heads=32,
                    num_kv_heads=32, d_ff=11008),
}

Batch = Dict[str, torch.Tensor]


def batch_loss(params: Any, cfg: CausalLMConfig, batch: Batch) -> torch.Tensor:
    """:func:`causal_lm_loss` on a batch dict (``input_ids``,
    ``attention_mask``, ``labels``), the loss-function form that the train
    step takes."""
    return causal_lm_loss(params, cfg, batch["input_ids"], batch["attention_mask"],
                          batch["labels"])


def make_config(geometry: str, flash: bool, device: torch.device,
                layers: Optional[int] = None) -> CausalLMConfig:
    kw = dict(GEOMETRIES[geometry])
    if layers:
        kw["num_layers"] = layers
    return CausalLMConfig(**kw, compute_dtype=default_dtype(device), flash_attention=flash)


def make_batch(cfg: CausalLMConfig, b: int, t: int, ragged: bool, seed: int,
               device: torch.device) -> Batch:
    """One random batch from a numpy seed: ids in ``[3, vocab)``; with
    ``ragged`` each row but the first right-padded to a length in ``[t/2,
    t]``, labels -100 on the padding (else every token real, labels = ids,
    the JAX benchmark's batch)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, (b, t))
    lengths = rng.integers(t // 2, t + 1, b) if ragged else np.full(b, t)
    lengths[0] = t
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int64)
    ids = np.where(mask == 1, ids, cfg.pad_token_id)
    labels = np.where(mask == 1, ids, -100)
    return {k: torch.from_numpy(v).to(device) for k, v in
            (("input_ids", ids), ("attention_mask", mask), ("labels", labels))}


def setup(geometry: str, flash: bool, device: Any, layers: Optional[int], batch: int, seq: int,
          ragged: bool, seed: int, lr: float) -> Tuple[TrainState, CausalLMConfig, Batch]:
    """Seeded float32 masters made on ``device``, their AdamW state and the
    fixed batch: the same weights and batch for both attentions."""
    dev = resolve_device(device)
    cfg = make_config(geometry, flash, dev, layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    state = init_train_state(params, lr, warmup_steps=0)
    return state, cfg, make_batch(cfg, batch, seq, ragged, seed, dev)


def run_steps(state: TrainState, cfg: CausalLMConfig, batch: Batch,
              steps: int) -> Dict[str, Any]:
    """``steps`` train steps on ``batch``, each timed by part
    (:func:`~reprover_tpu_torch.training.tasks.timed_train_steps`) -> losses,
    the first step's ms and the means of the later ones, peak device
    memory."""
    device = batch["input_ids"].device
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    timed = timed_train_steps(state, batch_loss, cfg, batch, steps)
    losses = [float(s[0]) for s in timed]
    warm = timed[1:] or timed
    fwd, bwd, opt = (sum(s[i] for s in warm) / len(warm) for i in range(1, 4))
    row: Dict[str, Any] = dict(
        first_step_ms=sum(timed[0][1:]), forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
        ms_per_step=fwd + bwd + opt, steps_per_s=1e3 / (fwd + bwd + opt), losses=losses)
    if cuda:
        row["peak_GiB"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return row


def model_flops(cfg: CausalLMConfig, n_params: int, b: int, t: int) -> float:
    """Operations of one step: 6 per parameter and token (forward and
    backward products) plus the attention's, ``3 * 4 * B * H * T^2 * d / 2``
    for the causal half (the JAX benchmark's count halved)."""
    return 6.0 * n_params * b * t + 3 * 4 * b * cfg.num_heads * t * t * cfg.head_dim / 2


def bench(flash: bool, args: argparse.Namespace) -> Dict[str, Any]:
    """One geometry, one attention -> the JSON row (or the error that stopped
    it)."""
    head = {"flash": flash, "geometry": args.geometry, "batch": args.batch, "seq": args.seq}
    try:
        state, cfg, batch = setup(args.geometry, flash, args.device, args.layers, args.batch,
                                  args.seq, args.ragged, SEED, LR)
        head.update(layers=cfg.num_layers, head_dim=cfg.head_dim,
                    compute_dtype=str(cfg.compute_dtype).replace("torch.", ""))
        row = {**head, **run_steps(state, cfg, batch, args.steps)}
        n_params = sum(t.numel() for t in param_leaves(state.params))
        row["params"] = n_params
        if batch["input_ids"].device.type == "cuda":
            flops = model_flops(cfg, n_params, args.batch, args.seq)
            row["model_tflops_per_s"] = flops / (row["ms_per_step"] * 1e-3) / 1e12
            row["share_of_989_tflops"] = row["model_tflops_per_s"] * 1e12 / PEAK_BF16_FLOPS
            row["device"] = torch.cuda.get_device_name(batch["input_ids"].device)
        return row
    except torch.cuda.OutOfMemoryError as ex:
        return {**head, "error": f"{type(ex).__name__}: {str(ex)[:200]}"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="jax")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (default: the geometry's: 8 for jax, 4 for llama7b)")
    ap.add_argument("--ragged", action="store_true",
                    help="right-pad rows to random lengths (labels -100 on the padding)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    args = parser().parse_args(argv)
    resolve_device(args.device)
    rows = []
    for flash in (False, True):
        row = bench(flash, args)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
