"""Ring attention: the sequence-parallel T5 encoder self-attention, the
counterpart of :mod:`reprover_tpu.ops.ring_attention`.

Each rank of a mesh's ``seq`` axis holds one shard of the sequence: its
queries, keys, values and key mask. Step ``t`` of ``n`` attends the local
queries to the k/v shard that started ``t`` ranks before, merging it into
an fp32 online softmax (running max, denominator and output), then passes
the k/v shard on to the next rank (:func:`~reprover_tpu_torch.parallel.
collectives.ring_shift`). After ``n`` steps every query has seen every key;
the last rotation, which the JAX scan makes after the last use, is skipped.
The next shard's transfer is posted before a step's local attention and
awaited after it, as ``ppermute`` overlaps compute on the TPU.

The JAX function is ``einsum``s inside ``shard_map`` and runs no Pallas
kernel, so this is plain PyTorch on tensors, as every XLA-lowered op of the
port is. Its numerics follow the JAX ring: scores and the softmax in fp32,
``p`` cast to ``v``'s dtype before the PV product, the accumulator fp32.
Its masking follows the port's attention (``ops/flash_attention.py``): the
row max is taken over valid keys only and a query row with no valid key
gives 0, so a k/v shard that is all padding (the last ranks' shards of a
short right-padded row) adds nothing and never computes ``exp(-inf -
-inf)``; the JAX ring's finite ``NEG_INF`` gives the mean of ``v`` there
instead. Every row with a valid key equals the JAX result.

The relative-position bias of a (query, key shard) pair comes from global
positions through the encoder's bucket table
(:func:`~reprover_tpu_torch.ops.flash_attention.bucket_table`, the plain
bucket function at every clamped offset ``k - q``): a pair whose every
offset is at or past ``max_distance`` on one side takes the saturated
bucket's per-head scalar, as the long-route kernels do, and only the near
pairs gather the table. The local step walks the queries in chunks whose
fp32 scores against a shard fill :data:`CHUNK_BYTES`, so it never holds
``[B, H, L/n, L/n]`` at once.

Differentiable: the running max is a constant of the softmax (it cancels),
the shift's backward sends gradients back around the ring, and the
parameter gradients of a sequence-parallel forward are each rank's partial
sums (:func:`~reprover_tpu_torch.parallel.collectives.reduce_gradients_`
over ``seq`` makes them whole).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from reprover_tpu_torch.ops.flash_attention import bucket_table
from reprover_tpu_torch.parallel.collectives import ring_shift

# fp32 scores of one query chunk against one k/v shard (the local step's
# largest temporary; a few of this size are live at once).
CHUNK_BYTES = 512 << 20


def _offset_bias(rel_bias: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """fp32 ``[H, 2*max_distance+1]``: the bias of relative position ``k - q``
    at index ``clamp(k - q, -max_distance, max_distance) + max_distance``
    (the encoder's bidirectional buckets); differentiable in ``rel_bias``."""
    table = bucket_table(num_buckets, max_distance, rel_bias.device).long()
    return rel_bias.float()[table].t()


def _pair_bias(table: torch.Tensor, q0: int, q1: int, k0: int, k1: int,
              max_distance: int) -> torch.Tensor:
    """The fp32 bias of global query positions ``[q0, q1)`` against keys
    ``[k0, k1)`` from :func:`_offset_bias`'s ``table``: ``[1, H, 1, 1]`` when
    every ``k - q`` is at or past ``max_distance`` on one side, else ``[1,
    H, q1 - q0, k1 - k0]``."""
    if k0 - (q1 - 1) >= max_distance:
        return table[:, -1].view(1, -1, 1, 1)
    if q0 - (k1 - 1) >= max_distance:
        return table[:, 0].view(1, -1, 1, 1)
    dev = table.device
    rel = (torch.arange(k0, k1, device=dev)[None, :] - torch.arange(q0, q1, device=dev)[:, None])
    return table[:, rel.clamp_(-max_distance, max_distance) + max_distance][None]


def _merge(state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], q32: torch.Tensor,
           k32: torch.Tensor, v: torch.Tensor, valid: torch.Tensor, bias: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One online-softmax step: the running ``(m, l, acc)`` of a query chunk
    (fp32 ``[B, H, c]``, ``[B, H, c]``, ``[B, H, c, d]``) merged with one
    k/v shard. The row max is over valid keys only and never ``-inf`` in a
    subtraction, so an all-padding shard leaves the state as it was."""
    m, l, acc = state
    s = torch.matmul(q32, k32.transpose(-1, -2)).add_(bias).masked_fill_(~valid, float("-inf"))
    m_new = torch.maximum(m, s.detach().amax(dim=-1))
    shift = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = s.sub_(shift[..., None]).exp_()  # masked keys: exp(-inf) = 0
    scale = torch.exp(m - shift)  # 0 while m is -inf
    l = l * scale + p.sum(dim=-1)
    acc = acc * scale[..., None] + torch.matmul(p.to(v.dtype).float(), v.float())
    return m_new, l, acc


def _pack(k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """k, v and the key mask in one flat buffer of k's dtype (one transfer a
    step; 0/1 is exact in every float dtype)."""
    return torch.cat([k.reshape(-1), v.reshape(-1), mask.reshape(-1).to(k.dtype)])


def _unpack(buf: torch.Tensor, shape: Tuple[int, ...]) -> Tuple[torch.Tensor, ...]:
    b, h, s, d = shape
    n = b * h * s * d
    return (buf[:n].view(shape), buf[n:2 * n].view(shape),
            buf[2 * n:].view(b, 1, 1, s) > 0.5)


def ring_encoder_attention(
    q: torch.Tensor,  # [B, H, L/n, d]: this rank's shard
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, L/n] {0,1}: this rank's shard
    rel_bias: torch.Tensor,  # [num_buckets, H] (replicated)
    mesh: Any,
    axis: str = "seq",
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Sequence-parallel unscaled T5 self-attention -> this rank's ``[B, H,
    L/n, d]`` in q's dtype. Every rank of ``axis`` calls it with its own
    shard, ``coord(axis)``'s ``L/n`` positions; on an axis of one rank it is
    the plain attention over the whole sequence."""
    n, r = mesh.shape[axis], mesh.coord(axis)
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or tuple(mask.shape) != (b, s):
        raise ValueError(f"ring attention takes one shard of q, k, v [B, H, L/n, d] and the "
                         f"mask [B, L/n]: got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} and {tuple(mask.shape)}")
    table = _offset_bias(rel_bias, num_buckets, max_distance)
    q32 = q.float()
    chunk = max(1, min(s, CHUNK_BYTES // (b * h * s * 4)))
    rows = [(a, min(a + chunk, s)) for a in range(0, s, chunk)]
    dev = q.device
    states: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = [
        (torch.full((b, h, c - a), float("-inf"), device=dev),
         torch.zeros((b, h, c - a), device=dev), torch.zeros((b, h, c - a, d), device=dev))
        for a, c in rows]
    buf = _pack(k, v, mask)
    for step in range(n):
        nxt, work = ring_shift(buf, mesh, axis, async_op=True) if step < n - 1 else (None, None)
        k_cur, v_cur, valid = _unpack(buf, (b, h, s, d))
        k32 = k_cur.float()
        k0 = ((r - step) % n) * s  # the current shard's first global position
        for i, (a, c) in enumerate(rows):
            bias = _pair_bias(table, r * s + a, r * s + c, k0, k0 + s, max_distance)
            states[i] = _merge(states[i], q32[:, :, a:c], k32, v_cur, valid, bias)
        if work is not None:
            work.wait()
            buf = nxt
    out = [acc / torch.where(l > 0, l, torch.ones_like(l))[..., None] for _, l, acc in states]
    return torch.cat(out, dim=2).to(q.dtype)
