"""Train state, losses and the train step: the counterpart of
:mod:`reprover_tpu.training.tasks` for the retriever and the tactic
generator, on one device or data-parallel over a mesh.

The JAX package builds a pure loss and one donated, jitted update; here the
loss runs eagerly, ``backward`` fills the float32 master parameters'
gradients (the attention backward through the CUDA kernels on a card), and :class:`~reprover_tpu_torch.training.optim.AdamWClip` updates the
parameters in place. The step returns the loss as a device tensor; nothing
syncs with the host until a caller reads it. Adam's moments can live in
host memory (:func:`offload_opt_state` with ``make_train_step(...,
offload_opt=True)``), streamed to the device leaf by leaf for each update.

Under a mesh (``make_train_step(..., mesh=...)``) every rank is given the
same global batch and keeps its rows (:func:`~reprover_tpu_torch.parallel.
sharding.local_rows`); its loss is its share of the global batch's loss,
the one GSPMD's step computes, not a per-rank mean: the retrieval losses
compare each context with every premise of the global batch (gathered with
their gradient across ranks), and the cross-entropy divides by the global
count of valid tokens. The optimizer sums the shares' gradients over
``data`` and keeps ZeRO-sharded moments
(:meth:`~reprover_tpu_torch.training.optim.AdamWClip.shard`). Every rank
runs the port's CUDA kernels as one card does; the JAX package turns its
Pallas kernels off under a mesh (a ``pallas_call`` is not
SPMD-partitionable). Not ported: tensor parallelism (a mesh with
``model > 1``, ``model_parallel=True``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from reprover_tpu_torch.models.t5 import Params, T5Config, encode, forward_loss
from reprover_tpu_torch.ops.pooling import masked_mean_normalize
from reprover_tpu_torch.parallel.collectives import gather_rows, global_sum
from reprover_tpu_torch.parallel.mesh import TENSOR_PARALLEL_TODO, Mesh
from reprover_tpu_torch.parallel.sharding import local_rows
from reprover_tpu_torch.training.optim import AdamWClip

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


def _spans(mesh: Optional[Mesh]) -> bool:
    """Whether a step over ``mesh`` runs collectives (a ``data`` axis of
    more than one rank)."""
    return mesh is not None and mesh.spans("data")


def offload_opt_state(state: TrainState, mesh: Optional[Mesh] = None) -> TrainState:
    """Keep the optimizer's moments in host memory (pinned on a card) from
    now on; pair with ``make_train_step(..., offload_opt=True)``. Under a
    mesh each rank keeps only its ZeRO shard of them."""
    if state.optimizer is None:
        raise ValueError("the train state has no optimizer (use init_train_state)")
    if mesh is not None:
        _check_mesh(mesh)
        state.optimizer.shard(mesh)
    state.optimizer.offload()
    return state


def _check_mesh(mesh: Optional[Mesh], cfg: Any = None, model_parallel: bool = False) -> None:
    """Raise for what the port's steps do not run: tensor parallelism, and
    ``remat_policy='offload'`` under a mesh."""
    if model_parallel or (mesh is not None and mesh.shape["model"] > 1):
        raise NotImplementedError(TENSOR_PARALLEL_TODO)
    if mesh is not None and getattr(cfg, "remat", False) and cfg.remat_policy == "offload":
        # The JAX package's rule (XLA's partitioner rejects the policy's
        # placement calls); activation offload is a per-device memory knob.
        raise ValueError(
            "remat_policy='offload' is single-device only; use remat_policy='lite' under "
            "a mesh, or disable data_parallel"
        )


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


def _similarity(params: Params, cfg: T5Config, batch: Batch,
                mesh: Optional[Mesh]) -> torch.Tensor:
    """fp32 cosine similarity of this rank's contexts with every premise
    of the global batch ``[b, B*(1+n)]`` (its rows of the label matrix)."""
    ctx_emb, prem_emb = _embed_pair(params, cfg, batch)
    prem = prem_emb.float()
    if _spans(mesh):
        prem = gather_rows(prem, mesh)
    return ctx_emb.float() @ prem.t()


def retrieval_loss(params: Params, cfg: T5Config, batch: Batch,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """In-batch-negative MSE against the multi-positive label matrix
    (the reference's objective, `retrieval/model.py:116-140`); under a mesh,
    this rank's share of the global batch's mean."""
    sq = torch.square(_similarity(params, cfg, batch, mesh) - batch["label"].float())
    if not _spans(mesh):
        return torch.mean(sq)
    return sq.sum() / (sq.numel() * mesh.shape["data"])


def retrieval_infonce_loss(
    params: Params, cfg: T5Config, batch: Batch, temperature: float = 0.05,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Multi-positive InfoNCE over the in-batch similarity matrix:
    ``-log(sum_pos exp(s/t) / sum_all exp(s/t))`` per context, averaged over
    the contexts that have a positive (under a mesh: this rank's share of
    that average over the global batch)."""
    logits = _similarity(params, cfg, batch, mesh) / temperature
    labels = batch["label"].float()
    log_z = torch.logsumexp(logits, dim=1)
    has_pos = labels.sum(dim=1) > 0
    pos_logits = torch.where(labels > 0, logits, torch.full_like(logits, float("-inf")))
    # A row with no positive contributes 0; its logsumexp runs on zeros so
    # that autograd sees no -inf - -inf there.
    pos_logits = torch.where(has_pos[:, None], pos_logits, torch.zeros_like(logits))
    log_pos = torch.logsumexp(pos_logits, dim=1)
    nll = torch.where(has_pos, log_z - log_pos, torch.zeros_like(log_z))
    count = has_pos.sum()
    if _spans(mesh):
        count = global_sum(count, mesh)
    return nll.sum() / count.clamp_min(1)


def token_share(loss: torch.Tensor, count: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A token-mean loss over this rank's ``count`` valid tokens as its
    share of the global token mean: ranks with more tokens weigh more."""
    if not _spans(mesh):
        return loss
    return loss * count / global_sum(count, mesh).clamp_min(1)


def generation_loss(
    params: Params, cfg: T5Config, batch: Batch, flash_attention: bool = True,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Teacher-forced seq2seq CE with -100 masking
    (`reference/generation/model.py:101-111`); ``flash_attention=False`` runs
    the plain attention (:func:`~reprover_tpu_torch.models.t5.forward_loss`).
    Under a mesh, this rank's share of the global batch's token mean."""
    loss = forward_loss(
        params, cfg, batch["state_ids"], batch["state_mask"], batch["tactic_ids"],
        flash_attention,
    )
    return token_share(loss, (batch["tactic_ids"] != -100).sum(), mesh)


# ------------------------------------------------------------------ #
# Train step
# ------------------------------------------------------------------ #


def rank_loss(loss_fn: LossFn, cfg: Any, mesh: Optional[Mesh]) -> Callable:
    """``(params, global batch) -> this rank's loss``: the loss itself on
    one device; under a mesh, this rank's share over its rows (the loss
    functions take the mesh by keyword)."""
    if not _spans(mesh):
        return lambda params, batch: loss_fn(params, cfg, batch)
    return lambda params, batch: loss_fn(params, cfg, local_rows(batch, mesh), mesh=mesh)


def make_train_step(
    loss_fn: LossFn,
    cfg: T5Config,
    mesh: Optional[Mesh] = None,
    offload_opt: bool = False,
    model_parallel: bool = False,
) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """Build ``(state, batch) -> (state, loss)``: forward, backward, clip and
    AdamW update in place; the loss is a detached device tensor. With
    ``offload_opt`` the state's moments must be in host memory
    (:func:`offload_opt_state`).

    Under a ``data`` mesh every rank passes the same global batch and gets
    the global batch's loss; the first step shards the optimizer's moments
    (ZeRO-2). A mesh with ``model > 1``, ``model_parallel=True`` and
    ``remat_policy='offload'`` under a mesh raise."""
    _check_mesh(mesh, cfg, model_parallel)
    local_loss = rank_loss(loss_fn, cfg, mesh)

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        if state.optimizer is None:
            raise ValueError("the train state has no optimizer (use init_train_state)")
        if offload_opt and not state.optimizer.offload_moments:
            raise ValueError("offload_opt needs the moments in host memory (offload_opt_state)")
        if mesh is not None:
            state.optimizer.shard(mesh)
        state.optimizer.zero_grad()
        loss = local_loss(state.params, batch)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, global_sum(loss, mesh) if _spans(mesh) else loss.detach()

    return step


def make_eval_step(
    loss_fn: LossFn, cfg: T5Config, mesh: Optional[Mesh] = None
) -> Callable[[Params, Batch], torch.Tensor]:
    """Build ``(params, batch) -> loss`` under ``torch.no_grad()`` (the loss
    a detached device tensor); under a mesh every rank passes the same
    global batch and gets its loss."""
    _check_mesh(mesh)
    local_loss = rank_loss(loss_fn, cfg, mesh)

    def step(params: Params, batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            loss = local_loss(params, batch)
        return global_sum(loss, mesh) if _spans(mesh) else loss

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
