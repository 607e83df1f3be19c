"""Train state, losses and the train step: the counterpart of
:mod:`reprover_tpu.training.tasks` for the retriever and the tactic
generator on one device.

The JAX package builds a pure loss and one donated, jitted update; here the
loss runs eagerly, ``backward`` fills the float32 master parameters'
gradients (the attention backward through the CUDA kernels on a card), and :class:`~reprover_tpu_torch.training.optim.AdamWClip` updates the
parameters in place. The step returns the loss as a device tensor; nothing
syncs with the host until a caller reads it. Adam's moments can live in
host memory (:func:`offload_opt_state` with ``make_train_step(...,
offload_opt=True)``), streamed to the device leaf by leaf for each update.

Not ported: the mesh (data parallelism, ZeRO-sharded moments, Megatron
specs).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from reprover_tpu_torch.models.t5 import Params, T5Config, encode, forward_loss
from reprover_tpu_torch.ops.pooling import masked_mean_normalize
from reprover_tpu_torch.training.optim import AdamWClip

MESH_TODO = (
    "multi-device training (mesh, data parallelism, ZeRO-sharded moments) is not "
    "ported (ROADMAP.md Queue 1 item 7)"
)

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[Params, T5Config, Batch], torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Step counter, parameters (float32 leaves) and their optimizer."""

    step: int
    params: Params
    optimizer: Optional[AdamWClip] = None


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The tensors of a parameter tree, in its key order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params]


def init_train_state(
    params: Params, lr: float, warmup_steps: int, **optimizer_kwargs: Any
) -> TrainState:
    """Make every leaf of ``params`` require grad and bind an optimizer to
    them (:class:`AdamWClip`'s keyword arguments pass through)."""
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    return TrainState(0, params, AdamWClip(leaves, lr, warmup_steps, **optimizer_kwargs))


def offload_opt_state(state: TrainState, mesh: Any = None) -> TrainState:
    """Keep the optimizer's moments in host memory (pinned on a card) from
    now on; pair with ``make_train_step(..., offload_opt=True)``."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)
    if state.optimizer is None:
        raise ValueError("the train state has no optimizer (use init_train_state)")
    state.optimizer.offload()
    return state


# ------------------------------------------------------------------ #
# Loss functions
# ------------------------------------------------------------------ #


def _embed_pair(params: Params, cfg: T5Config, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Context and premise embeddings. The encoder runs once over the
    stacked ``[B + B*(1+n), L]`` tensor when both sides share a length,
    else twice (the JAX package's rule)."""
    ctx_ids, ctx_mask = batch["context_ids"], batch["context_mask"]
    prem_ids, prem_mask = batch["premise_ids"], batch["premise_mask"]
    if ctx_ids.shape[1] == prem_ids.shape[1]:
        ids = torch.cat([ctx_ids, prem_ids], dim=0)
        mask = torch.cat([ctx_mask, prem_mask], dim=0)
        emb = masked_mean_normalize(encode(params, cfg, ids, mask), mask)
        return emb[: ctx_ids.shape[0]], emb[ctx_ids.shape[0] :]
    ctx_emb = masked_mean_normalize(encode(params, cfg, ctx_ids, ctx_mask), ctx_mask)
    prem_emb = masked_mean_normalize(encode(params, cfg, prem_ids, prem_mask), prem_mask)
    return ctx_emb, prem_emb


def retrieval_loss(params: Params, cfg: T5Config, batch: Batch) -> torch.Tensor:
    """In-batch-negative MSE against the multi-positive label matrix
    (the reference's objective, `retrieval/model.py:116-140`)."""
    ctx_emb, prem_emb = _embed_pair(params, cfg, batch)
    similarity = ctx_emb.float() @ prem_emb.float().t()
    return torch.mean(torch.square(similarity - batch["label"].float()))


def retrieval_infonce_loss(
    params: Params, cfg: T5Config, batch: Batch, temperature: float = 0.05
) -> torch.Tensor:
    """Multi-positive InfoNCE over the in-batch similarity matrix:
    ``-log(sum_pos exp(s/t) / sum_all exp(s/t))`` per context, averaged over
    the contexts that have a positive."""
    ctx_emb, prem_emb = _embed_pair(params, cfg, batch)
    logits = (ctx_emb.float() @ prem_emb.float().t()) / temperature
    labels = batch["label"].float()
    log_z = torch.logsumexp(logits, dim=1)
    has_pos = labels.sum(dim=1) > 0
    pos_logits = torch.where(labels > 0, logits, torch.full_like(logits, float("-inf")))
    # A row with no positive contributes 0; its logsumexp runs on zeros so
    # that autograd sees no -inf - -inf there.
    pos_logits = torch.where(has_pos[:, None], pos_logits, torch.zeros_like(logits))
    log_pos = torch.logsumexp(pos_logits, dim=1)
    nll = torch.where(has_pos, log_z - log_pos, torch.zeros_like(log_z))
    return nll.sum() / has_pos.sum().clamp_min(1)


def generation_loss(
    params: Params, cfg: T5Config, batch: Batch, flash_attention: bool = True
) -> torch.Tensor:
    """Teacher-forced seq2seq CE with -100 masking
    (`reference/generation/model.py:101-111`); ``flash_attention=False`` runs
    the plain attention (:func:`~reprover_tpu_torch.models.t5.forward_loss`)."""
    return forward_loss(
        params, cfg, batch["state_ids"], batch["state_mask"], batch["tactic_ids"],
        flash_attention,
    )


# ------------------------------------------------------------------ #
# Train step
# ------------------------------------------------------------------ #


def make_train_step(
    loss_fn: LossFn,
    cfg: T5Config,
    mesh: Any = None,
    offload_opt: bool = False,
) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """Build ``(state, batch) -> (state, loss)``: forward, backward, clip and
    AdamW update in place; the loss is a detached device tensor. With
    ``offload_opt`` the state's moments must be in host memory
    (:func:`offload_opt_state`)."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        if state.optimizer is None:
            raise ValueError("the train state has no optimizer (use init_train_state)")
        if offload_opt and not state.optimizer.offload_moments:
            raise ValueError("offload_opt needs the moments in host memory (offload_opt_state)")
        state.optimizer.zero_grad()
        loss = loss_fn(state.params, cfg, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_eval_step(
    loss_fn: LossFn, cfg: T5Config, mesh: Any = None
) -> Callable[[Params, Batch], torch.Tensor]:
    """Build ``(params, batch) -> loss`` under ``torch.no_grad()`` (the loss
    a detached device tensor)."""
    if mesh is not None:
        raise NotImplementedError(MESH_TODO)

    def step(params: Params, batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            return loss_fn(params, cfg, batch)

    return step


def _mark(cuda: bool) -> Any:
    """A point in time: a recorded CUDA event on the card, else the host clock."""
    if not cuda:
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _ms_between(a: Any, b: Any, cuda: bool) -> float:
    return a.elapsed_time(b) if cuda else 1e3 * (b - a)


def timed_train_steps(
    state: TrainState, loss_fn: LossFn, cfg: Any, batch: Batch, n: int,
    after_backward: Optional[Callable[[int, TrainState], None]] = None,
) -> List[Tuple[torch.Tensor, float, float, float]]:
    """``n`` steps of :func:`make_train_step`'s update on one batch, each
    split by CUDA events on the card (the host clock on the CPU) and synced
    -> per step (detached loss, forward ms, backward ms, optimizer ms).
    ``after_backward(i, state)`` runs between step ``i``'s backward and its
    update (to read the gradients), outside both times."""
    device = next(iter(batch.values())).device
    cuda = device.type == "cuda"
    out = []
    for i in range(n):
        m0 = _mark(cuda)
        state.optimizer.zero_grad()
        loss = loss_fn(state.params, cfg, batch)
        m1 = _mark(cuda)
        loss.backward()
        m2 = _mark(cuda)
        if after_backward is not None:
            after_backward(i, state)
        m2b = _mark(cuda) if after_backward is not None else m2
        state.optimizer.step()
        state.step += 1
        m3 = _mark(cuda)
        if cuda:
            torch.cuda.synchronize(device)
        out.append((loss.detach(), _ms_between(m0, m1, cuda), _ms_between(m1, m2, cuda),
                    _ms_between(m2b, m3, cuda)))
    return out


def numeric_batch(batch: Dict[str, Any], device: Any = "cpu") -> Batch:
    """The array fields of a collated batch as tensors on ``device``
    (integer arrays as int64)."""
    out: Batch = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
            out[k] = t.to(device)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
    return out
