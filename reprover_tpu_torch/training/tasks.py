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
SPMD-partitionable).

Over a ``(data, model)`` mesh with ``model`` > 1, the first step
cuts the state into each rank's Megatron part (:func:`shard_train_state`:
the T5 or causal specs, checked for divisibility), the loss is taken over
the gathered logits, gradients are summed over ``data`` only (the
replicated leaves' are already whole and equal on every ``model`` rank),
and a checkpoint is written in the one-card layout.
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
from reprover_tpu_torch.parallel.mesh import Mesh
from reprover_tpu_torch.parallel.sharding import (
    check_model_divides,
    local_rows,
    model_blocks,
    shard_for_model,
)
from reprover_tpu_torch.training.optim import AdamWClip

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[Params, T5Config, Batch], torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Step counter, parameters (float32 leaves) and their optimizer; after
    :func:`shard_train_state`, the tensor-parallel ``mesh`` and the specs
    the parameters (this rank's shards) were cut by."""

    step: int
    params: Params
    optimizer: Optional[AdamWClip] = None
    mesh: Optional[Mesh] = None
    param_specs: Any = None


def param_leaves(params: Params, spec: bool = False) -> List[Any]:
    """The tensors of a parameter tree, in its key order (with ``spec``, the
    specs of a spec tree, whose leaves are tuples)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v, spec)]
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
    mesh each rank keeps only its ZeRO shard of them (of its tensor-parallel
    shards, once the first step has cut them)."""
    if state.optimizer is None:
        raise ValueError("the train state has no optimizer (use init_train_state)")
    if mesh is not None:
        _check_mesh(mesh)
        state.optimizer.shard(mesh)
    state.optimizer.offload()
    return state


def shard_train_state(state: TrainState, cfg: Any, mesh: Mesh) -> TrainState:
    """Cut a one-card train state into this rank's tensor-parallel part, in
    place: each parameter becomes its Megatron shard (the T5 or causal
    specs, a new float32 leaf) and the optimizer is rebound to them, its
    moments sliced. A state already cut, or a mesh whose ``model`` axis is
    one rank, is left as it is."""
    if state.param_specs is not None or not mesh.spans("model"):
        return state
    with torch.no_grad():
        whole = _map_leaves(lambda t: t.detach(), state.params)
        local, specs = shard_for_model(whole, cfg, mesh)
        local = _map_leaves(lambda t: t.clone().requires_grad_(True), local)
    state.params, state.param_specs, state.mesh = local, specs, mesh
    if state.optimizer is not None:
        state.optimizer.split_model(param_leaves(local), param_leaves(specs, spec=True), mesh,
                                    param_leaves(model_blocks(whole), spec=True))
    return state


def _map_leaves(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _check_mesh(mesh: Optional[Mesh], cfg: Any = None) -> None:
    """Raise for what the port's steps do not run: a ``model`` axis whose
    degree does not divide the heads and hidden units (``ValueError``), a
    mesh without the process groups its axes need, and
    ``remat_policy='offload'`` under a mesh."""
    if mesh is None:
        return
    if mesh.spans("model") and cfg is not None:
        check_model_divides(cfg, mesh.shape["model"])
    if getattr(cfg, "remat", False) and cfg.remat_policy == "offload":
        # The JAX package's rule (XLA's partitioner rejects the policy's
        # placement calls); activation offload is a per-device memory knob.
        raise ValueError(
            "remat_policy='offload' is single-device only; use remat_policy='lite' under "
            "a mesh, or disable data_parallel"
        )
    for axis in ("data", "model"):
        if mesh.spans(axis):
            mesh.group(axis)  # raises for a mesh built without process groups


# ------------------------------------------------------------------ #
# Loss functions
# ------------------------------------------------------------------ #


def _embed_pair(params: Params, cfg: T5Config, batch: Batch, mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Context and premise embeddings. The encoder runs once over the
    stacked ``[B + B*(1+n), L]`` tensor when both sides share a length,
    else twice (the JAX package's rule)."""
    ctx_ids, ctx_mask = batch["context_ids"], batch["context_mask"]
    prem_ids, prem_mask = batch["premise_ids"], batch["premise_mask"]
    if ctx_ids.shape[1] == prem_ids.shape[1]:
        ids = torch.cat([ctx_ids, prem_ids], dim=0)
        mask = torch.cat([ctx_mask, prem_mask], dim=0)
        emb = masked_mean_normalize(encode(params, cfg, ids, mask, mesh=mesh), mask)
        return emb[: ctx_ids.shape[0]], emb[ctx_ids.shape[0] :]
    ctx_emb = masked_mean_normalize(encode(params, cfg, ctx_ids, ctx_mask, mesh=mesh), ctx_mask)
    prem_emb = masked_mean_normalize(encode(params, cfg, prem_ids, prem_mask, mesh=mesh),
                                     prem_mask)
    return ctx_emb, prem_emb


def _similarity(params: Params, cfg: T5Config, batch: Batch,
                mesh: Optional[Mesh]) -> torch.Tensor:
    """fp32 cosine similarity of this rank's contexts with every premise
    of the global batch ``[b, B*(1+n)]`` (its rows of the label matrix)."""
    ctx_emb, prem_emb = _embed_pair(params, cfg, batch, mesh)
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
        flash_attention, mesh=mesh,
    )
    return token_share(loss, (batch["tactic_ids"] != -100).sum(), mesh)


def causal_loss(params: Params, cfg: Any, batch: Batch, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """Decoder-only next-token cross-entropy over ``input_ids`` /
    ``attention_mask`` (labels the ids, -100 on padding); under a mesh, this
    rank's share of the global token mean."""
    from reprover_tpu_torch.models.causal_lm import causal_lm_loss

    labels = torch.where(batch["attention_mask"] > 0, batch["input_ids"], -100)
    loss = causal_lm_loss(params, cfg, batch["input_ids"], batch["attention_mask"], labels,
                          mesh=mesh)
    return token_share(loss, (labels[:, 1:] != -100).sum(), mesh)


# ------------------------------------------------------------------ #
# Train step
# ------------------------------------------------------------------ #


def rank_loss(loss_fn: LossFn, cfg: Any, mesh: Optional[Mesh]) -> Callable:
    """``(params, global batch) -> this rank's loss``: the loss itself on
    one device; under a mesh, this rank's share over its rows (the loss
    functions take the mesh by keyword, and run a tensor-parallel forward
    when its ``model`` axis spans ranks)."""
    if mesh is None or not (mesh.spans("data") or mesh.spans("model")):
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
    (ZeRO-2). Over a ``model`` axis of more than one rank the first step
    also cuts the state into this rank's tensor-parallel part
    (:func:`shard_train_state`); ``model_parallel`` is the JAX package's
    flag for it, accepted and not needed, since the mesh says it. A degree
    that does not divide the heads and hidden units and
    ``remat_policy='offload'`` under a mesh raise ``ValueError``."""
    _check_mesh(mesh, cfg)
    local_loss = rank_loss(loss_fn, cfg, mesh)
    tensor_parallel = mesh is not None and mesh.spans("model")

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        if state.optimizer is None:
            raise ValueError("the train state has no optimizer (use init_train_state)")
        if offload_opt and not state.optimizer.offload_moments:
            raise ValueError("offload_opt needs the moments in host memory (offload_opt_state)")
        if tensor_parallel:
            shard_train_state(state, cfg, mesh)
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
    global batch and gets its loss. Over a ``model`` axis of more than one
    rank the params are a tensor-parallel state's (its shards)."""
    _check_mesh(mesh, cfg if mesh is not None and mesh.spans("model") else None)
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
