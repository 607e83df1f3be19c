"""The collectives of data-, tensor- and sequence-parallel training and
serving over a mesh (the JAX package gets them implied by GSPMD from its
shardings, and writes its one ``ppermute`` by hand).

Every one but the ring's is built on ``all_reduce``, so NCCL between cards
and gloo between ranks sharing one card run one algorithm (PyTorch's
backend table promises gloo only ``all_reduce`` and ``broadcast`` on CUDA
tensors). A gather is an ``all_reduce`` of a zero-filled buffer in which
each rank has written its own part: a sum of one value and zeros, exact in
every dtype, for a shard along any axis (the ZeRO axis is seldom axis 0,
where an ``all_gather`` would need the shards packed and unpacked). It
moves twice the bytes of an ``all_gather``; ``PERF.md`` has its time.

- :func:`reduce_gradients_`: the gradients summed over ``data``. Each rank's
  loss is its share of the global batch's loss (the steps of
  :mod:`reprover_tpu_torch.training.tasks`), so the sum is the global
  batch's gradient, as GSPMD's step computes it.
- :func:`gather_rows`: every rank's rows, in rank order, with gradient (the
  in-batch negatives of the retrieval losses).
- :func:`gather_shards_`: a tensor whose ranks each updated their own shard
  along one axis of ``data`` made whole on every rank (the parameters
  after the ZeRO update, the moments for a checkpoint).
- :func:`gather_model`: the whole tensor of which each rank holds its
  ``model`` shard (a tensor-parallel leaf for a checkpoint in the one-card
  layout, a vocabulary split's logits); :func:`gather_axis` the same along
  any mesh axis (a sequence-parallel encoder's output, to compare it).
- :func:`ring_shift`: the JAX package's ``ppermute`` with the permutation
  ``i -> i + 1`` along a mesh axis (the ring of
  :mod:`reprover_tpu_torch.ops.ring_attention`), differentiable: its
  backward sends the gradient ``i -> i - 1``, ``ppermute``'s transpose.
  It is an ``all_to_all_single`` whose split sizes send the whole tensor
  to the next rank and take the previous rank's (:data:`RING_TRANSPORT`),
  so it moves one shard: gloo runs no peer-to-peer op on CUDA tensors (the
  multichip dry run's probe), and ``all_to_all_single`` is the one form
  both backends run on the ranks' device. It never falls back to an
  ``all_reduce``, which would hand every rank the whole sequence.

Megatron's conjugate operators on the ``model`` axis (tensor parallelism),
each the identity when the mesh is None or its ``model`` axis one rank:

- :func:`copy_to_model`: identity forward, the gradient summed over
  ``model`` backward. It goes at the input of every column-parallel product
  (and before a replicated leaf of which each rank reads a slice, T5's
  ``rel_bias``): without it the replicated leaves upstream get each rank's
  partial gradient and the ranks drift apart silently.
- :func:`reduce_from_model`: the partial outputs summed over ``model``
  forward, identity backward; after every row-parallel product.
- :func:`gather_from_model`: every rank's slice of the last axis (a
  vocabulary-split ``lm_head``'s logits) concatenated forward, the rank's
  slice of the gradient backward.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from reprover_tpu_torch.parallel.mesh import Mesh


def _all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, group=mesh.group(axis))
    return t


def reduce_gradients_(grads: Sequence[torch.Tensor], mesh: Mesh, axis: str = "data") -> None:
    """Sum ``grads`` over ``axis`` in place (in one order on every rank: the
    callers pass the parameters' order); over ``seq``, the parameter
    gradients of a sequence-parallel forward, each rank's a partial sum."""
    import torch.distributed as dist

    works = [dist.all_reduce(g, group=mesh.group(axis), async_op=True) for g in grads]
    for work in works:
        work.wait()


def global_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ``data`` axis (a new tensor, no gradient)."""
    return _all_reduce_(x.detach().clone(), mesh)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh, rows = mesh, x.shape[0]
        out = x.new_zeros((mesh.shape["data"] * rows,) + tuple(x.shape[1:]))
        out.narrow(0, mesh.coord("data") * rows, rows).copy_(x)
        return _all_reduce_(out, mesh)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        # Every rank's loss reads every row: a row's gradient is their sum.
        mesh = ctx.mesh
        rows = grad.shape[0] // mesh.shape["data"]
        total = _all_reduce_(grad.contiguous().clone(), mesh)
        return total.narrow(0, mesh.coord("data") * rows, rows), None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked along axis 0 in rank order,
    differentiable: the gradient of a rank's rows is the sum of every
    rank's gradient for them."""
    if not mesh.spans("data"):
        return x
    return _GatherRows.apply(x, mesh)


def gather_shards_(full: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """Make ``full`` whole on every rank, where each rank holds the right
    values only in its own shard along ``axis`` (the ``data`` coordinate's
    slice of ``full.shape[axis] / data``); in place, no gradient."""
    n, r = mesh.shape["data"], mesh.coord("data")
    size = full.shape[axis] // n
    with torch.no_grad():
        own = full.narrow(axis, r * size, size).clone()
        full.zero_()
        full.narrow(axis, r * size, size).copy_(own)
        return _all_reduce_(full, mesh)


def gather_axis(local: torch.Tensor, dim: int, mesh: Mesh, mesh_axis: str) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's shard along
    ``dim``, split over ``mesh_axis`` in coordinate order (a new tensor on
    every rank, no gradient)."""
    n = mesh.shape[mesh_axis]
    shape = list(local.shape)
    shape[dim] *= n
    full = local.new_zeros(shape)
    size = local.shape[dim]
    full.narrow(dim, mesh.coord(mesh_axis) * size, size).copy_(local.detach())
    return _all_reduce_(full, mesh, mesh_axis)


def gather_model(local: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's ``model`` shard
    along ``axis`` (a new tensor on every rank, no gradient)."""
    return gather_axis(local, axis, mesh, "model")


def raise_everywhere(mesh: Mesh, failed: bool, what: str) -> None:
    """After a step that may raise on some ranks and not on others: one
    all-reduce of the ranks' failure flags over the mesh's ``control``
    group, then raise on each rank that did not fail if any did (a rank
    that failed calls this on its way out and re-raises its own error)."""
    import torch.distributed as dist

    if mesh.size < 2:
        return
    group = mesh.group("control")
    flags = torch.zeros(dist.get_world_size(group), dtype=torch.long)
    flags[dist.get_rank(group)] = int(failed)
    dist.all_reduce(flags, group=group)
    if flags.any() and not failed:
        ranks = [dist.get_global_rank(group, i) for i in flags.nonzero().flatten().tolist()]
        raise RuntimeError(f"{what} raised on rank(s) {ranks}")


def broadcast_object(obj: Any, mesh: Mesh, src: int = 0) -> Any:
    """``obj`` of the ``data`` group's rank ``src`` on every rank (the
    mesh's coordinate ``src`` when it lists its ranks in order, as
    ``make_mesh`` does by default): validation metrics, stop decisions,
    where every rank must take the same branch."""
    import torch.distributed as dist

    if not mesh.spans("data"):
        return obj
    group = mesh.group("data")
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src), group=group)
    return box[0]


# ------------------------------------------------------------------ #
# Tensor parallelism: Megatron's operators on the ``model`` axis
# ------------------------------------------------------------------ #


def model_parallel(mesh: Any) -> bool:
    """Whether a forward under ``mesh`` is tensor-parallel (``model`` > 1)."""
    return mesh is not None and mesh.spans("model")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        return _all_reduce_(grad.contiguous().clone(), ctx.mesh, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        return _all_reduce_(x.contiguous().clone(), mesh, "model")

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return gather_model(x, x.dim() - 1, mesh)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        w = ctx.width
        return grad.narrow(-1, ctx.mesh.coord("model") * w, w).contiguous(), None


def copy_to_model(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``model`` (the input of a
    column-parallel product)."""
    return _CopyToModel.apply(x, mesh) if model_parallel(mesh) else x


def reduce_from_model(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """``x`` summed over ``model`` (the partial outputs of a row-parallel
    product); the gradient passes unchanged."""
    return _ReduceFromModel.apply(x, mesh) if model_parallel(mesh) else x


def gather_from_model(x: torch.Tensor, mesh: Any) -> torch.Tensor:
    """Every ``model`` rank's ``x`` concatenated along the last axis in rank
    order (a vocabulary-split projection's logits); the gradient of this
    rank's slice passes back."""
    return _GatherFromModel.apply(x, mesh) if model_parallel(mesh) else x


# ------------------------------------------------------------------ #
# Sequence parallelism: the ring's shift on the ``seq`` axis
# ------------------------------------------------------------------ #

RING_TRANSPORT = "all_to_all_single"


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, step: int, async_op: bool) -> Any:
    """``x`` of the rank ``step`` places before this one on ``axis`` (a new
    tensor), sent by one ``all_to_all_single`` whose only non-empty splits
    are this rank's whole ``x`` to the rank ``step`` places after and the
    one ``step`` places before's into the output -> ``(out, work)``, the
    work None unless ``async_op``."""
    import torch.distributed as dist

    n, r = mesh.shape[axis], mesh.coord(axis)
    group = mesh.group(axis)
    if dist.get_rank(group) != r:
        raise ValueError(f"ring_shift needs the {axis!r} axis's ranks in increasing order: "
                         f"coordinate {r} is rank {dist.get_rank(group)} of its group")
    flat = x.detach().contiguous().view(-1)
    out = torch.empty_like(flat)
    send, recv = [0] * n, [0] * n
    send[(r + step) % n] = recv[(r - step) % n] = flat.numel()
    work = dist.all_to_all_single(out, flat, output_split_sizes=recv, input_split_sizes=send,
                                  group=group, async_op=async_op)
    return out.view(x.shape), work


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, mesh: Mesh, axis: str, works: list) -> torch.Tensor:
        ctx.mesh, ctx.axis = mesh, axis
        out, work = _shift(x, mesh, axis, 1, async_op=True)
        works.append(work)
        return out

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Any:
        return _shift(grad, ctx.mesh, ctx.axis, -1, async_op=False)[0], None, None, None


def ring_shift(x: torch.Tensor, mesh: Mesh, axis: str = "seq", async_op: bool = False) -> Any:
    """The previous rank's ``x`` along ``axis`` on every rank (rank ``i``'s
    goes to ``i + 1``, the last's to the first): ``ppermute`` over the ring.
    Every rank's ``x`` has one shape. Differentiable: the gradient travels
    back ``i -> i - 1``, synchronously. With ``async_op`` it returns
    ``(out, work)`` as soon as the transfer is posted: ``out`` may be read
    once ``work.wait()`` has returned, and the caller computes meanwhile.
    On an axis of one rank ``x`` is its own shift."""
    if not mesh.spans(axis):
        return (x, None) if async_op else x
    works: list = []
    out = _RingShift.apply(x, mesh, axis, works)
    if async_op:
        return out, works[0]
    works[0].wait()
    return out
