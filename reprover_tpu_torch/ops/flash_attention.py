"""Fused attention and its gradient: CUDA kernels for Hopper and their
plain PyTorch versions, for the three attentions of T5 and the LLaMA-family
teacher-forced causal attention.

- :func:`encoder_flash_attention`: bidirectional encoder self-attention
  with the relative-position bias and the encoder's key mask;
- :func:`causal_flash_attention`: the teacher-forced decoder's
  self-attention, with the bias from unidirectional buckets and key
  ``k > q`` masked;
- :func:`cross_flash_attention`: decoder-encoder attention, no bias, the
  encoder's key mask, query length ``T`` and key length ``S`` independent;
- :func:`scaled_causal_flash_attention`: the LLaMA family's teacher-forced
  self-attention, ``softmax((q s) k^T)`` with key ``k > q`` and padded keys
  masked, no bias, head width 64 or 128 (LLaMA-7B's), the scale folded
  into q before the kernel as the JAX package folds it.

One forward kernel (``reprover_tpu_torch/csrc/encoder_attn.cu``) and two
backward kernels (``csrc/encoder_attn_bwd.cu``, dQ and dK/dV) serve all
four, each compiled once per attention (a template mode, and for the
scaled causal mode once per head width), so each attention has three
kernels with a launch count of their own in :data:`KERNEL_LAUNCHES`.
The JAX package runs the scaled causal attention through its T5 causal
kernels with a zero bias table (``scaled_causal_flash_attention``, :1589);
here it is a mode of its own with no table. They replace the Pallas TPU
kernels of ``reprover_tpu/ops/flash_attention.py``: ``_encoder_attn_kernel`` (:176,
also with ``causal=True`` behind ``causal_flash_attention``, :1553),
``_bwd_dq_kernel`` (:607) and ``_bwd_dkv_kernel`` (:715) (both also causal,
:1343, :1384), and ``_cross_attn_kernel`` (:1624), ``_cross_bwd_dq_kernel``
(:1721) and ``_cross_bwd_dkv_kernel`` (:1757). Per batch row and head on
the flat ``[B, L, H*d]`` layout they compute unscaled ``q k^T`` plus the
bias, drop masked key columns, take an exact fp32 softmax and multiply by
``v``; a query row with no valid key gives 0. Under training the forward
also stores each row's log-sum-exp.

The JAX package wires the backward kernels with ``jax.custom_vjp``; here
:func:`attention_op`, an operator of PyTorch's dispatcher (``torch.library``)
taking the attention's mode as an argument, does it for all four, with
the forward kernel as its CUDA implementation, the plain version as its
CPU one and the backward kernels (or their plain versions) as its
gradient. Being an operator, it is visible to a rematerialization policy,
which can keep its outputs (``models/t5.py``). It saves q, k, v, the mask,
the bias table, the output and the LSE (never an ``[Lq, Lk]`` tensor), and
its backward rebuilds ``P = exp(S - LSE)`` tile by tile. The
relative-bias gradient comes out of the dQ kernel as sums of dS per clamped
relative position ``k - q`` (``2*max_distance+1`` bins), which
:func:`fold_rel_bins` folds into the buckets here.

What bounds them on the H100: the score work (``4 Lq Lk d`` operations per
batch row and head forward, about 2.5x that backward) against
``O((Lq + Lk) d)`` elements moved makes them compute-bound from a few
hundred keys on; the plain version's cost is the ``[B, H, Lq, Lk]`` fp32
tensors it writes and reads back (and, under autograd, keeps). The kernels
never form them: each block owns a 64-row tile and walks the other side in
64-wide tiles in shared memory; a causal block stops at its diagonal tile.
On bf16 inputs every kernel runs its products on Hopper's tensor cores
(``wgmma``, tiles copied by TMA, one or two warpgroups per tile), rounding
P (and in the backward dS) to bf16 before the product that takes it, as the
Pallas kernels do; on fp32 inputs they run fp32 FMA loops. The bf16
kernels read q, k, v (and the backward dout) through TMA tensor maps, so
their bases must be 16-byte aligned (:data:`TMA_ALIGN`): the wrappers
refuse a misaligned q, k or v and copy a misaligned dout.

Choices that differ from the Pallas kernels on purpose:

- the row max is taken over valid keys only, so a masked score far above
  the valid ones cannot underflow the row (the Pallas forward takes it over
  all columns); the result equals the JAX package's naive path, and the
  backward agrees with it: masked keys and rows with no valid key get zero
  gradients;
- for an encoder row with no valid key the Pallas cross kernel adds the
  finite ``NEG_INF = -1e10`` to every score (``flash_attention.py:68,
  1634``) and so returns the mean of ``v``; the port returns 0, as its
  encoder kernel does (real sources always hold at least EOS);
- the relative-position buckets come from a table of ``2*max_distance+1``
  int32 values built here with the plain bucket function (bidirectional for
  the encoder, unidirectional for the decoder), indexed by
  ``clamp(k - q, -max_distance, max_distance)`` (buckets saturate beyond
  ``max_distance``), so the kernels take no float log and no bucket can
  flip at an exact boundary such as ``|k - q| = 16, 32, 64``.

A CPU tensor goes to the plain versions (:func:`encoder_attention_reference`,
:func:`causal_attention_reference`, :func:`cross_attention_reference`,
:func:`scaled_causal_attention_reference`). When a gradient is wanted it goes
through :func:`attention_op` on both devices; on the CPU that operator's
gradient is the plain forward's derivative taken step by step
(:func:`_plain_grads`, dq, dk and dv bit-equal to autograd of the plain
version, no forward rerun). The step-by-step ``*_backward_reference``
functions are the backward kernels' own algorithm (P from the LSE), which
the card's checks hold the kernels to. A CUDA tensor launches the kernels or
raises. There is no fallback between the two.

**The long route.** As the JAX package does, the four functions switch to
its KV-blocked long-context kernels when ``block_kv > 0`` or a query or key
length passes :data:`LONG_CONTEXT` (4096): ``_encoder_attn_kernel_blockwise``
(:274, kernel 2, the forward of all three attentions), then in the backward
``_bwd_lse_kernel_blockwise`` (:864, kernel 5: the LSE, which the long
forward does not save), ``delta`` in plain torch, ``_bwd_dq_kernel_blockwise``
(:934, kernel 6) and ``_bwd_dkv_kernel_blockwise`` (:1034, kernel 7). Here
they are the same CUDA sources on their ``LONG`` and ``LONG_LSE`` routes
(``csrc/encoder_attn_common.cuh``), behind :func:`long_attention_op`, with a
launch count of their own (``encoder_attn_long``, ``encoder_attn_long_lse``,
``encoder_attn_long_bwd_dq``, ``encoder_attn_long_bwd_dkv``, and the same for
``causal_``, ``cross_`` and ``scaled_causal_``). A far (query tile, key
tile) pair, every ``|k - q|`` at or past ``max_distance`` on one side of
the diagonal, takes its bias from one per-head scalar (the saturated bucket's) and sends its dS
to that bucket whole. Their plain versions (:func:`long_attention_reference`,
:func:`long_lse_reference`, :func:`long_backward_dq_reference`,
:func:`long_backward_dkv_reference`) walk the keys in the kernels' 64-wide
tiles with the same near/far split, so they hold ``O(L * 64)`` per head,
never ``[B, H, L, L]``: the CPU route and the card's checks run at 8192.
The kernels keep their 64-wide tiles whatever ``block_kv`` is (the JAX
package's blocks are 512): ``block_kv`` only selects the route, and the
result does not depend on its value.
"""

from __future__ import annotations

import ctypes
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

# The kernels' modes and routes (csrc/encoder_attn_common.cuh) and their
# count names: ``KERNEL_NAMES[mode] + ROUTE_SUFFIX[route]``, then
# ``_bwd_dq`` or ``_bwd_dkv`` for a backward kernel.
ENCODER, CAUSAL, CROSS, SCALED_CAUSAL = 0, 1, 2, 3
KERNEL_NAMES = {ENCODER: "encoder_attn", CAUSAL: "causal_attn", CROSS: "cross_attn",
                SCALED_CAUSAL: "scaled_causal_attn"}
FULL_ROW, LONG, LONG_LSE = 0, 1, 2
ROUTE_SUFFIX = {FULL_ROW: "", LONG: "_long", LONG_LSE: "_long_lse"}

# Launches of each CUDA kernel in this process: each wrapper adds one where
# it launches and nowhere else, so a run can show that its path used them.
KERNEL_LAUNCHES: Dict[str, int] = {
    name + part: 0
    for name in KERNEL_NAMES.values()
    for part in ("", "_bwd_dq", "_bwd_dkv", "_long", "_long_lse", "_long_bwd_dq",
                 "_long_bwd_dkv")
}

# A query or key length past this takes the long route (the JAX package's
# switch, flash_attention.py:527, :1305, :1675, :1809).
LONG_CONTEXT = 4096
TILE = 64  # the kernels' query and key tile
TMA_ALIGN = 16  # bytes: the bf16 kernels' tensor maps need aligned bases
OP_NAMESPACE = "reprover_torch"  # the dispatcher's namespace of the forward operators

# The head widths each mode's kernels are compiled for.
HEAD_DIMS = {ENCODER: (64,), CAUSAL: (64,), CROSS: (64,), SCALED_CAUSAL: (64, 128)}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
CrossGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_tables: Dict[Tuple[int, int, bool, torch.device], torch.Tensor] = {}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


# An attention kernel's name, attn_<part>_kernel<T, mode, route, D[, variant]>,
# as a profile prints it or mangled, as ptxas and cuobjdump print it
# (attn_fwd_kernelI13__nv_bfloat16Li3ELi0ELi128ELi0EE): each template
# argument follows ", " in the first form and "Li" in the second.
_ARG = r"(?:,\s*|Li)(\d+)E?"
_KERNEL_NAME = re.compile(
    rf"attn_(fwd|bwd_dq|bwd_dkv)_kernel(?:<|I\d*)(__nv_bfloat16|float|f){_ARG * 3}(?:{_ARG})?")


def kernel_instance(kernel_name: str) -> Optional[Tuple[str, str, int, int, int, int]]:
    """``(part, dtype, mode, route, head width, variant)`` of an attention
    kernel's profiled or mangled name (part ``fwd``, ``bwd_dq`` or
    ``bwd_dkv``; dtype ``bf16`` or ``fp32``; variant 0 for the backward), or
    None for any other kernel."""
    m = _KERNEL_NAME.search(kernel_name)
    if m is None:
        return None
    part, t, mode, route, d, variant = m.groups()
    return (part, "bf16" if t == "__nv_bfloat16" else "fp32", int(mode), int(route), int(d),
            int(variant or 0))


def launch_key(kernel_name: str) -> Optional[str]:
    """The launch-count name of a profiled attention kernel (``causal_attn``,
    ``encoder_attn_long_bwd_dq``, ...), or None for any other kernel,
    including the forward's ablation variants (a nonzero fifth parameter)."""
    inst = kernel_instance(kernel_name)
    if inst is None or inst[5]:
        return None
    part, _, mode, route = inst[:4]
    base = KERNEL_NAMES[mode] + ROUTE_SUFFIX[route]
    return base if part == "fwd" else f"{base}_{part}"


def has_bias(mode: int) -> bool:
    """Whether a mode adds the T5 relative-position bias (and has its
    gradient)."""
    return mode in (ENCODER, CAUSAL)


def is_causal(mode: int) -> bool:
    """Whether a mode masks keys ``k > q``."""
    return mode in (CAUSAL, SCALED_CAUSAL)


def bucket_table(
    num_buckets: int, max_distance: int, device: torch.device, bidirectional: bool = True
) -> torch.Tensor:
    """int32 ``[2*max_distance+1]``: the bucket of relative position ``r`` at
    index ``r + max_distance`` (bidirectional: the encoder's; else the
    decoder's, where every ``r > 0`` is bucket 0)."""
    key = (num_buckets, max_distance, bidirectional, torch.device(device))
    table = _tables.get(key)
    if table is None:
        from reprover_tpu_torch.models.t5 import relative_position_bucket

        rel = torch.arange(-max_distance, max_distance + 1)
        table = relative_position_bucket(rel, bidirectional, num_buckets, max_distance)
        table = table.to(device=device, dtype=torch.int32).contiguous()
        _tables[key] = table
    return table


def rel_index(length: int, max_distance: int, device: torch.device) -> torch.Tensor:
    """int64 ``[L, L]``: ``clamp(k - q, -max_distance, max_distance) +
    max_distance`` at ``[q, k]``, the index into :func:`bucket_table`."""
    pos = torch.arange(length, device=device)
    rel = (pos[None, :] - pos[:, None]).clamp(-max_distance, max_distance)
    return rel + max_distance


def fold_rel_bins(bins: torch.Tensor, table: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Sum ``bins`` (fp32 ``[H, 2*max_distance+1]``, dS summed per clamped
    relative position) into the buckets -> the bias gradient fp32
    ``[num_buckets, H]``."""
    out = torch.zeros((num_buckets, bins.shape[0]), dtype=torch.float32, device=bins.device)
    return out.index_add_(0, table.long(), bins.t().float())


# ------------------------------------------------------------------ #
# Plain versions
# ------------------------------------------------------------------ #


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """fp32 ``[B, H, L, d]`` from the flat ``[B, L, H*d]`` layout."""
    b, l, inner = x.shape
    return x.float().reshape(b, l, num_heads, inner // num_heads).transpose(1, 2)


def _flat(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[B, L, H*d]`` in ``dtype`` from ``[B, H, L, d]``."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d).to(dtype)


def _causal_valid(length: int, device: torch.device) -> torch.Tensor:
    """bool ``[1, 1, L, L]``: key ``k <= q``."""
    pos = torch.arange(length, device=device)
    return (pos[None, :] <= pos[:, None])[None, None]


def _plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,  # bool, broadcastable to [B, H, Lq, Lk]
    bias: Optional[torch.Tensor],  # fp32, broadcastable to [B, H, Lq, Lk]
    num_heads: int,
) -> torch.Tensor:
    """fp32 attention over the full ``[B, H, Lq, Lk]`` score tensor, output in
    q's dtype. Differentiable: the row max is detached (it cancels in the
    softmax), invalid columns enter as ``exp(-inf) = 0`` and a row with no
    valid key divides by 1, so autograd gives zero (never NaN) gradients
    there."""
    scores = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    scores = scores.masked_fill(~valid, float("-inf"))
    row_max = scores.detach().amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    p = torch.exp(scores - row_max)  # invalid columns: exp(-inf) = 0
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))  # 0 only for empty rows
    return _flat(torch.matmul(p, _heads(v, num_heads)) / denom, q.dtype)


def _bucket_bias(
    rel_bias: torch.Tensor, length: int, bidirectional: bool, num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """fp32 ``[1, H, L, L]`` bias from the plain bucket function on positions
    (the JAX package's naive path)."""
    from reprover_tpu_torch.models.t5 import relative_position_bucket

    pos = torch.arange(length, device=rel_bias.device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None], bidirectional, num_buckets,
                                       max_distance)
    return rel_bias.float()[buckets.long()].permute(2, 0, 1)[None]


def encoder_attention_reference(
    q: torch.Tensor,  # [B, L, H*d]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, L] {0,1}
    rel_bias: torch.Tensor,  # [num_buckets, H] fp32
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version of the encoder forward kernel: fp32 throughout,
    the full ``[B, H, L, L]`` score tensor, output in the input dtype;
    differentiable (see :func:`_plain_attention`)."""
    bias = _bucket_bias(rel_bias, q.shape[1], True, num_buckets, max_distance)
    return _plain_attention(q, k, v, mask.bool()[:, None, None, :], bias, num_heads)


def causal_attention_reference(
    q: torch.Tensor,  # [B, T, H*d]
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: torch.Tensor,  # [num_buckets, H] fp32
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Plain PyTorch version of the causal forward kernel: the decoder's
    unidirectional bias, key ``k > q`` masked, no padding mask (the JAX
    package's naive ``decode`` with ``decoder_mask=None``); differentiable."""
    bias = _bucket_bias(rel_bias, q.shape[1], False, num_buckets, max_distance)
    return _plain_attention(q, k, v, _causal_valid(q.shape[1], q.device), bias, num_heads)


def cross_attention_reference(
    q: torch.Tensor,  # [B, T, H*d]
    k: torch.Tensor,  # [B, S, H*d]
    v: torch.Tensor,  # [B, S, H*d]
    mask: torch.Tensor,  # [B, S] {0,1}
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of the cross forward kernel: no bias, the
    encoder's key mask; a row with no valid key gives 0; differentiable."""
    return _plain_attention(q, k, v, mask.bool()[:, None, None, :], None, num_heads)


def _scores_plain(
    mode: int, q: torch.Tensor, k: torch.Tensor, rel_bias: Optional[torch.Tensor],
    num_heads: int, num_buckets: int, max_distance: int,
) -> torch.Tensor:
    """fp32 ``[B, H, Lq, Lk]`` scores ``q k^T`` (+ the bias through the bucket
    table, as the kernels index it)."""
    scores = torch.matmul(_heads(q, num_heads), _heads(k, num_heads).transpose(-1, -2))
    if not has_bias(mode):
        return scores
    idx = rel_index(q.shape[1], max_distance, q.device)
    table = bucket_table(num_buckets, max_distance, q.device, mode == ENCODER).long()
    return scores + rel_bias.float()[table[idx]].permute(2, 0, 1)[None]


def _valid(mode: int, mask: Optional[torch.Tensor], q: torch.Tensor) -> torch.Tensor:
    """bool, broadcastable to ``[B, H, Lq, Lk]``: the pairs a kernel keeps."""
    if mode == CAUSAL:
        return _causal_valid(q.shape[1], q.device)
    valid = mask.bool()[:, None, None, :]
    if mode == SCALED_CAUSAL:
        valid = valid & _causal_valid(q.shape[1], q.device)
    return valid


def _lse_plain(
    mode: int, q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor],
    rel_bias: Optional[torch.Tensor], num_heads: int, num_buckets: int, max_distance: int,
) -> torch.Tensor:
    scores = _scores_plain(mode, q, k, rel_bias, num_heads, num_buckets, max_distance)
    scores = scores.masked_fill(~_valid(mode, mask, q), float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    return torch.where(torch.isfinite(lse), lse, torch.full_like(lse, float("inf")))


def encoder_attention_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: torch.Tensor,
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Plain version of the encoder forward kernel's LSE output: fp32
    ``[B, H, L]`` log-sum-exp of each row over its valid keys, ``+inf`` for a
    row with none."""
    return _lse_plain(ENCODER, q, k, mask, rel_bias, num_heads, num_buckets, max_distance)


def causal_attention_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    rel_bias: torch.Tensor,
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Plain version of the causal forward kernel's LSE output ``[B, H, T]``."""
    return _lse_plain(CAUSAL, q, k, None, rel_bias, num_heads, num_buckets, max_distance)


def cross_attention_lse_reference(
    q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Plain version of the cross forward kernel's LSE output ``[B, H, T]``,
    ``+inf`` for a row with no valid key."""
    return _lse_plain(CROSS, q, k, mask, None, num_heads, 32, 128)


def scale_queries(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``q * scale`` rounded once to q's dtype: the scaled causal attention's
    kernel operand, as the JAX package folds the scale
    (``(q.astype(float32) * scale).astype(q.dtype)``). At head width 128 the
    scale 1/sqrt(128) is not a power of two, so scaling the scores in fp32
    instead would round differently from it in bf16."""
    return (q.float() * scale).to(q.dtype)


def scaled_causal_attention_reference(
    q: torch.Tensor,  # [B, T, H*d]
    k: torch.Tensor,  # [B, T, H*d]
    v: torch.Tensor,  # [B, T, H*d]
    key_mask: torch.Tensor,  # [B, T] {0,1}
    num_heads: int,
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch version of the scaled causal attention: the scale folded
    into q (:func:`scale_queries`), then fp32 over the full ``[B, H, T, T]``
    score tensor with key ``k > q`` and padded keys dropped; a row with no
    valid key (a left-padded query) gives 0; differentiable."""
    qs = scale_queries(q, scale)
    return _plain_attention(qs, k, v, _valid(SCALED_CAUSAL, key_mask, qs), None, num_heads)


def scaled_causal_attention_lse_reference(
    q: torch.Tensor, k: torch.Tensor, key_mask: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Plain version of the scaled causal forward kernel's LSE output ``[B,
    H, T]`` on its operands (q already scaled), ``+inf`` for a row with no
    valid key."""
    return _lse_plain(SCALED_CAUSAL, q, k, key_mask, None, num_heads, 32, 128)


def row_delta(dout: torch.Tensor, out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` per head: fp32 ``[B, H, L]`` (plain torch
    on every device, as the JAX package computes it outside Pallas)."""
    b, l, inner = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(b, l, num_heads, inner // num_heads).sum(-1).transpose(1, 2).contiguous()


def _rel_grad(mode: int, ds: torch.Tensor, num_buckets: int, max_distance: int
              ) -> Optional[torch.Tensor]:
    """The bias gradient fp32 ``[num_buckets, H]`` of a self-attention's fp32
    dS ``[B, H, L, L]``: binned by clamped relative position, then folded
    into the buckets (None for a mode without a bias)."""
    if not has_bias(mode):
        return None
    h, l = ds.shape[1], ds.shape[2]
    idx = rel_index(l, max_distance, ds.device).flatten()
    bins = torch.zeros((h, 2 * max_distance + 1), dtype=torch.float32, device=ds.device)
    bins.index_add_(1, idx, ds.sum(0).reshape(h, l * l))
    table = bucket_table(num_buckets, max_distance, ds.device, mode == ENCODER)
    return fold_rel_bins(bins, table, num_buckets)


def _backward_plain(
    mode: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    rel_bias: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    num_buckets: int,
    max_distance: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The two backward kernels, step for step: ``P`` from the LSE,
    ``dS = P (dP - delta)``, and for the self-attentions dS binned by
    clamped relative position and folded into the buckets. Returns
    ``(dq, dk, dv, d_rel)``, d_rel None for CROSS."""
    scores = _scores_plain(mode, q, k, rel_bias, num_heads, num_buckets, max_distance)
    p = torch.where(_valid(mode, mask, q), torch.exp(scores - lse[..., None]),
                    torch.zeros_like(scores))
    gh = _heads(dout, num_heads)
    dp = torch.matmul(gh, _heads(v, num_heads).transpose(-1, -2))
    ds = p * (dp - row_delta(dout, out, num_heads)[..., None])
    d_rel = _rel_grad(mode, ds, num_buckets, max_distance)
    dq = torch.matmul(ds, _heads(k, num_heads))
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, num_heads))
    dv = torch.matmul(p.transpose(-1, -2), gh)
    return _flat(dq, q.dtype), _flat(dk, q.dtype), _flat(dv, q.dtype), d_rel


def encoder_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,  # [B, H, L] fp32
    dout: torch.Tensor,
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> Grads:
    """Plain version of the encoder's two backward kernels, step for step.
    Returns ``(dq, dk, dv, d_rel)``: dq/dk/dv in the input dtype
    ``[B, L, H*d]``, d_rel fp32 ``[num_buckets, H]``."""
    return _backward_plain(ENCODER, q, k, v, mask, rel_bias, out, lse, dout, num_heads,
                           num_buckets, max_distance)


def causal_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_bias: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,  # [B, H, T] fp32
    dout: torch.Tensor,
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> Grads:
    """Plain version of the causal backward kernels, step for step ->
    ``(dq, dk, dv, d_rel)``."""
    return _backward_plain(CAUSAL, q, k, v, None, rel_bias, out, lse, dout, num_heads,
                           num_buckets, max_distance)


def cross_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,  # [B, H, T] fp32
    dout: torch.Tensor,
    num_heads: int,
) -> CrossGrads:
    """Plain version of the cross backward kernels, step for step ->
    ``(dq [B, T, H*d], dk [B, S, H*d], dv [B, S, H*d])``."""
    dq, dk, dv, _ = _backward_plain(CROSS, q, k, v, mask, None, out, lse, dout, num_heads, 32, 128)
    return dq, dk, dv


def scaled_causal_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,  # [B, H, T] fp32
    dout: torch.Tensor,
    num_heads: int,
) -> CrossGrads:
    """Plain version of the scaled causal backward kernels on their operands
    (q already scaled), step for step -> ``(dq, dk, dv)``, dq with respect to
    the scaled q."""
    dq, dk, dv, _ = _backward_plain(SCALED_CAUSAL, q, k, v, key_mask, None, out, lse, dout,
                                    num_heads, 32, 128)
    return dq, dk, dv


# ------------------------------------------------------------------ #
# Kernel wrappers
# ------------------------------------------------------------------ #


def _check_kernel_inputs(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    num_heads: int,
    num_buckets: int,
    mode: int = ENCODER,
) -> None:
    """Raise on anything the kernels do not take."""
    name = KERNEL_NAMES[mode]
    tensors = [t for t in (q, k, v, mask, rel_bias) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: {devices}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name}: q, k, v must share one of {KERNEL_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or (
        k.shape[0], k.shape[2]) != (q.shape[0], q.shape[2]):
        raise ValueError(f"{name}: q must be [B, Lq, H*d] and k, v [B, Lk, H*d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, lq, inner = q.shape
    lk = k.shape[1]
    if mode != CROSS and lk != lq:
        raise ValueError(f"{name}: self-attention needs as many keys as queries, got {lq}, {lk}")
    if num_heads < 1 or inner % num_heads or inner // num_heads not in HEAD_DIMS[mode]:
        raise ValueError(
            f"{name}: the kernel takes head width {' or '.join(map(str, HEAD_DIMS[mode]))}, "
            f"got {inner} / {num_heads} heads"
        )
    if tuple(mask.shape) != (b, lk):
        raise ValueError(f"{name}: mask must be [{b}, {lk}], got {tuple(mask.shape)}")
    if has_bias(mode) and (rel_bias is None or tuple(rel_bias.shape) != (num_buckets, num_heads)):
        raise ValueError(
            f"{name}: rel_bias must be [{num_buckets}, {num_heads}], got "
            f"{None if rel_bias is None else tuple(rel_bias.shape)}"
        )
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        # The bf16 kernels copy their tiles by TMA, which reads from 16-byte
        # aligned bases only (a view at an odd offset of a larger tensor).
        if t.dtype == torch.bfloat16 and t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}: bf16 {arg} must start on a {TMA_ALIGN}-byte boundary, "
                             f"got address {t.data_ptr():#x}")
    if b > 65535 or num_heads > 65535:
        raise ValueError(f"{name}: batch and heads must be <= 65535")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _kernel_dout(dout: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``dout`` as the backward kernels take it: contiguous, in the inputs'
    dtype, and at a 16-byte aligned base. The caller's gradient may be a
    view at any offset (a slice of a larger gradient); the bf16 kernels read
    it through a TMA tensor map, which needs an aligned base, so a
    misaligned one is copied."""
    dout = dout.to(dtype).contiguous()
    return dout.clone() if dout.data_ptr() % TMA_ALIGN else dout


def _raise_on_error(lib: Any, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.kernel_error_string(err).decode()} ({err})"
        )


def _kernel_operands(
    mode: int, mask: torch.Tensor, rel_bias: Optional[torch.Tensor], num_buckets: int,
    max_distance: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(int32 mask, fp32 bias, int32 bucket table), contiguous on the card;
    the bias and table are None for the modes without a bias."""
    mask32 = mask.to(torch.int32).contiguous()
    if not has_bias(mode):
        return mask32, None, None
    table = bucket_table(num_buckets, max_distance, mask.device, mode == ENCODER)
    return mask32, rel_bias.to(torch.float32).contiguous(), table


def _forward_cuda(
    mode: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask32: torch.Tensor,
    rel32: Optional[torch.Tensor],
    table: Optional[torch.Tensor],
    num_heads: int,
    max_distance: int,
    with_lse: bool,
    route: int = FULL_ROW,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch a forward kernel -> (out or None, LSE ``[B, H, Lq]`` fp32 or
    None). ``route`` FULL_ROW: kernel 1, 1c or 8, with the LSE if
    ``with_lse``; LONG: kernel 2 (``with_lse`` False); LONG_LSE: kernel 5,
    the LSE alone (``with_lse`` True)."""
    from reprover_tpu_torch.ops.native import load_library

    lib = load_library()
    b, lq, _ = q.shape
    lk = k.shape[1]
    out = None if route == LONG_LSE else torch.empty_like(q)
    lse = torch.empty((b, num_heads, lq), dtype=torch.float32, device=q.device) if with_lse else None
    if b == 0 or lq == 0:
        return out, lse
    name = KERNEL_NAMES[mode] + ROUTE_SUFFIX[route]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.t5_attn_forward(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask32), _ptr(rel32), _ptr(table), _ptr(out), _ptr(lse),
        b, lq, lk, num_heads, q.shape[2] // num_heads, max_distance if has_bias(mode) else 0,
        mode, int(q.dtype == torch.bfloat16), route, ctypes.c_void_p(stream),
    )
    _raise_on_error(lib, err, name)
    KERNEL_LAUNCHES[name] += 1
    return out, lse


def _backward_cuda(
    mode: int,
    part: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    mask32: torch.Tensor,
    rel32: Optional[torch.Tensor],
    table: Optional[torch.Tensor],
    lse: torch.Tensor,
    delta: torch.Tensor,
    out_a: torch.Tensor,
    out_b: Optional[torch.Tensor],
    num_heads: int,
    max_distance: int,
    route: int = FULL_ROW,
) -> None:
    """Launch one backward kernel: ``part`` ``"dq"`` writes dq into ``out_a``
    and adds the bins into ``out_b`` (None without a bias); ``"dkv"`` writes dk
    and dv. ``route`` FULL_ROW: kernels 3/4 (and their causal and cross
    forms); LONG: kernels 6/7."""
    from reprover_tpu_torch.ops.native import load_library

    lib = load_library()
    b, lq, _ = q.shape
    lk = k.shape[1]
    if b == 0 or lq == 0 or lk == 0:
        return
    name = f"{KERNEL_NAMES[mode]}{ROUTE_SUFFIX[route]}_bwd_{part}"
    entry = {"dq": lib.t5_attn_backward_dq, "dkv": lib.t5_attn_backward_dkv}[part]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = entry(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(mask32), _ptr(rel32), _ptr(table),
        _ptr(lse), _ptr(delta), _ptr(out_a), _ptr(out_b),
        b, lq, lk, num_heads, q.shape[2] // num_heads, max_distance if has_bias(mode) else 0,
        mode, int(q.dtype == torch.bfloat16), route, ctypes.c_void_p(stream),
    )
    _raise_on_error(lib, err, name)
    KERNEL_LAUNCHES[name] += 1


def _backward_kernels(
    mode: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    num_buckets: int,
    max_distance: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Check and launch the dQ and dK/dV kernels -> ``(dq, dk, dv, d_rel)``,
    d_rel None without a bias."""
    name = KERNEL_NAMES[mode]
    _check_kernel_inputs(q, k, v, mask, rel_bias, num_heads, num_buckets, mode)
    if q.device.type != "cuda":
        raise ValueError(f"{name} backward: no kernel for device {q.device}")
    b, lq, _ = q.shape
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"{name} backward: out and dout must be shaped like q")
    if tuple(lse.shape) != (b, num_heads, lq) or lse.dtype != torch.float32:
        raise ValueError(f"{name} backward: lse must be fp32 [{b}, {num_heads}, {lq}]")
    dout = _kernel_dout(dout, q.dtype)
    lse = lse.contiguous()
    mask32, rel32, table = _kernel_operands(mode, mask, rel_bias, num_buckets, max_distance)
    delta = row_delta(dout, out, num_heads)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bins = None
    if has_bias(mode):
        bins = torch.zeros((num_heads, 2 * max_distance + 1), dtype=torch.float32,
                           device=q.device)
    common = (q, k, v, dout, mask32, rel32, table, lse, delta)
    _backward_cuda(mode, "dq", *common, dq, bins, num_heads, max_distance)
    _backward_cuda(mode, "dkv", *common, dk, dv, num_heads, max_distance)
    d_rel = None if bins is None else fold_rel_bins(bins, table, num_buckets)
    return dq, dk, dv, d_rel


def _on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def encoder_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> Grads:
    """Gradients of the encoder attention -> ``(dq, dk, dv, d_rel)``.

    CPU tensors: :func:`encoder_attention_backward_reference`. CUDA tensors:
    the dQ kernel (dq and the relative-position bins, folded here into fp32
    ``[num_buckets, H]``) and the dK/dV kernel, or an error."""
    if _on_cpu(q, k, v, mask, rel_bias, out, lse, dout):
        return encoder_attention_backward_reference(
            q, k, v, mask, rel_bias, out, lse, dout, num_heads, num_buckets, max_distance
        )
    return _backward_kernels(ENCODER, q, k, v, mask, rel_bias, out, lse, dout, num_heads,
                             num_buckets, max_distance)


def _plain_forward(
    mode: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor], num_heads: int, num_buckets: int, max_distance: int,
) -> torch.Tensor:
    """The plain version of ``mode``'s full-row forward on its operands (for
    the scaled causal mode, q already scaled)."""
    if mode == ENCODER:
        return encoder_attention_reference(q, k, v, mask, rel_bias, num_heads, num_buckets,
                                           max_distance)
    if mode == CAUSAL:
        return causal_attention_reference(q, k, v, rel_bias, num_heads, num_buckets,
                                          max_distance)
    if mode == CROSS:
        return cross_attention_reference(q, k, v, mask, num_heads)
    return scaled_causal_attention_reference(q, k, v, mask, num_heads, 1.0)


# The forwards are operators of PyTorch's dispatcher, not autograd.Functions
# around a ctypes call: a rematerialization policy (models/t5.py) sees an
# operator's call and can keep its outputs, so the backward's recompute does
# not run the forward again, where a launch from Python inside a Function
# is invisible to it. Each operator has two implementations: on CPU tensors
# the plain version, on CUDA tensors the kernel. A tensor on any other
# device has none and raises.


@torch.library.custom_op(f"{OP_NAMESPACE}::attention", mutates_args=(), device_types="cpu")
def attention_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    mode: int,
    num_heads: int,
    num_buckets: int,
    max_distance: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-row forward of ``mode`` -> (out, LSE ``[B, H, Lq]`` fp32),
    differentiable in q, k, v and ``rel_bias``; its gradient is the two
    backward kernels (their plain versions on CPU tensors). This body is the
    CPU implementation: the plain forward (for the scaled causal mode on its
    operands, the scale already in q) and the plain LSE."""
    return (_plain_forward(mode, q, k, v, mask, rel_bias, num_heads, num_buckets, max_distance),
            _lse_plain(mode, q, k, mask, rel_bias, num_heads, num_buckets, max_distance))


@attention_op.register_kernel("cuda")
def _attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor], mode: int, num_heads: int, num_buckets: int,
    max_distance: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_card(mode, q, k, v, mask, rel_bias, num_heads, num_buckets)
    mask32, rel32, table = _kernel_operands(mode, mask, rel_bias, num_buckets, max_distance)
    return _forward_cuda(mode, q, k, v, mask32, rel32, table, num_heads, max_distance, True)


def _save_residuals(ctx: Any, inputs: Tuple[Any, ...], output: Any) -> None:
    """Flash-style residuals: the inputs and the output (and the LSE on the
    full-row route), never an ``[Lq, Lk]`` tensor."""
    q, k, v, mask, rel_bias, mode, num_heads, num_buckets, max_distance = inputs
    outs = output if isinstance(output, tuple) else (output,)
    ctx.save_for_backward(q, k, v, mask, rel_bias, *outs)
    ctx.mode = mode
    ctx.geometry = (num_heads, num_buckets, max_distance)


def _plain_grads(
    mode: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor], dout: torch.Tensor, num_heads: int, num_buckets: int,
    max_distance: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The operator's gradient on CPU tensors -> ``(dq, dk, dv, d_rel)``,
    d_rel None without a bias: the derivative of :func:`_plain_attention`,
    step by step in the order autograd takes it (``out = (E V) / l`` with
    ``E = exp(S - max)``, ``l = rowsum(E)``: ``dE = (dO / l) V^T -
    rowsum(dO * (E V / l) / l)``, ``dS = E * dE``), without running the
    forward again; dq, dk and dv are bit-equal to autograd's. The kernels'
    form (:func:`_backward_plain`: ``P = exp(S - LSE)``, ``delta`` from the
    forward's output) differs from it by fp32 rounding only, but where a dq
    element cancels that rounding reaches ~1e-5, the limit that the Pallas
    interpreter is held to; against it each form misses on some seeded
    inputs, and so does the exact (fp64) gradient."""
    scores = _scores_plain(mode, q, k, rel_bias, num_heads, num_buckets, max_distance)
    scores = scores.masked_fill(~_valid(mode, mask, q), float("-inf"))
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    e = torch.exp(scores - row_max)  # invalid columns: 0
    denom = e.sum(dim=-1, keepdim=True)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    qh, kh, vh, gh = (_heads(x, num_heads) for x in (q, k, v, dout))
    g_ev = gh / denom
    g_denom = (-gh * ((torch.matmul(e, vh) / denom) / denom)).sum(dim=-1, keepdim=True)
    ds = (torch.matmul(g_ev, vh.transpose(-1, -2)) + g_denom) * e
    d_rel = _rel_grad(mode, ds, num_buckets, max_distance)
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(e.transpose(-1, -2), g_ev)
    return _flat(dq, q.dtype), _flat(dk, q.dtype), _flat(dv, q.dtype), d_rel


def _attention_grad(ctx: Any, dout: torch.Tensor, _dlse: Any) -> Tuple[Optional[torch.Tensor], ...]:
    q, k, v, mask, rel_bias, out, lse = ctx.saved_tensors
    if _on_cpu(q, k, v, mask, rel_bias, out, lse, dout):
        dq, dk, dv, d_rel = _plain_grads(ctx.mode, q, k, v, mask, rel_bias, dout,
                                         *ctx.geometry)
    else:
        dq, dk, dv, d_rel = _backward_kernels(ctx.mode, q, k, v, mask, rel_bias, out, lse, dout,
                                              *ctx.geometry)
    d_rel = None if d_rel is None else d_rel.to(rel_bias.dtype)
    return dq, dk, dv, None, d_rel, None, None, None, None


attention_op.register_autograd(_attention_grad, setup_context=_save_residuals)


def _check_card(
    mode: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor], num_heads: int, num_buckets: int,
) -> None:
    """Raise on anything the kernels do not take, a non-CUDA device included."""
    _check_kernel_inputs(q, k, v, mask, rel_bias, num_heads, num_buckets, mode)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL_NAMES[mode]}: no kernel for device {q.device}")


def _wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether autograd must record the attention: grad is on and one of
    the differentiable inputs requires it."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _kernel_attention(
    mode: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    num_heads: int,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """The full-row route of the four public functions, on either device:
    :func:`attention_op` when a gradient is wanted, else the forward alone
    (the plain version on CPU tensors, the kernel without LSE on CUDA ones)."""
    if _wants_grad(q, k, v, rel_bias):
        return attention_op(q, k, v, mask, rel_bias, mode, num_heads, num_buckets,
                            max_distance)[0]
    if _on_cpu(q, k, v, mask, rel_bias):
        return _plain_forward(mode, q, k, v, mask, rel_bias, num_heads, num_buckets,
                              max_distance)
    _check_card(mode, q, k, v, mask, rel_bias, num_heads, num_buckets)
    mask32, rel32, table = _kernel_operands(mode, mask, rel_bias, num_buckets, max_distance)
    return _forward_cuda(mode, q, k, v, mask32, rel32, table, num_heads, max_distance, False)[0]


# ------------------------------------------------------------------ #
# The long route: kernels 2, 5, 6, 7 and their plain versions
# ------------------------------------------------------------------ #


def takes_long_route(block_kv: int, q_len: int, kv_len: int) -> bool:
    """The JAX package's switch to its KV-blocked kernels: ``block_kv > 0``,
    or a query or key length past :data:`LONG_CONTEXT` (for the two
    self-attentions the two lengths are one)."""
    return block_kv > 0 or max(q_len, kv_len) > LONG_CONTEXT


LongTile = Tuple[int, int, int, torch.Tensor, torch.Tensor, Optional[Tuple[int, int]]]


def _long_tiles(
    mode: int, q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor], num_heads: int, num_buckets: int, max_distance: int,
) -> Iterator[LongTile]:
    """Walk the keys in the kernels' 64-wide tiles. Yields, per key tile
    ``[k0, k1)``: ``(k0, k1, r0, scores, valid, near)``, where

    - ``r0`` is the first query row that sees the tile (in a causal mode the
      first row of the query tile holding ``k0``: all-future tiles are
      skipped, as the kernels skip them; else 0);
    - ``scores`` fp32 ``[B, H, Lq - r0, k1 - k0]`` is ``q k^T`` plus the
      bias, decided per (query tile, key tile) pair from the tiles' clipped
      bounds as the kernels decide it: a right-far pair (every ``k - q >=
      max_distance``) adds the per-head scalar at the bucket table's right
      end, a left-far pair (every ``k - q <= -max_distance``) the one at its
      left end, a near pair reads the table;
    - ``valid`` (bool, broadcastable to ``scores``) marks the pairs the
      attention keeps;
    - ``near`` is ``(a, b)``: rows ``[r0, a)`` are right-far, ``[a, b)``
      near and ``[b, Lq)`` left-far for this key tile (None without a bias).

    Query tiles right-far of a key tile form a prefix and left-far ones a
    suffix, so the near rows are one band and only they read the table."""
    lq, lk = q.shape[1], k.shape[1]
    dev = q.device
    qh, kh = _heads(q, num_heads), _heads(k, num_heads)
    key_ok = mask.bool()[:, None, None, :]
    pos = torch.arange(max(lq, lk), device=dev)
    if has_bias(mode):
        table = bucket_table(num_buckets, max_distance, dev, mode == ENCODER).long()
        rel = rel_bias.float().t()  # [H, num_buckets]
        far_right, far_left = rel[:, table[-1]], rel[:, table[0]]
        tiles = range(0, lq, TILE)
    for k0 in range(0, lk, TILE):
        k1 = min(k0 + TILE, lk)
        r0 = k0 if is_causal(mode) else 0
        scores = torch.matmul(qh[:, :, r0:], kh[:, :, k0:k1].transpose(-1, -2))
        valid = key_ok[..., k0:k1]
        if is_causal(mode):
            valid = valid & (pos[None, k0:k1] <= pos[r0:lq, None])
        near = None
        if has_bias(mode):
            n_right = sum(k0 - (min(t + TILE, lq) - 1) >= max_distance for t in tiles)
            n_left = sum(t - (k1 - 1) >= max_distance for t in tiles)
            a = max(r0, min(lq, n_right * TILE))
            b = max(a, min(lq, (len(tiles) - n_left) * TILE))
            bias = torch.empty((num_heads, lq - r0, k1 - k0), device=dev)
            bias[:, : a - r0] = far_right[:, None, None]
            bias[:, b - r0:] = far_left[:, None, None]
            if b > a:
                idx = (pos[None, k0:k1] - pos[a:b, None]).clamp(-max_distance, max_distance)
                bias[:, a - r0 : b - r0] = rel[:, table[idx + max_distance]]
            scores = scores + bias
            near = (a, b)
        yield k0, k1, r0, scores, valid, near


@torch.no_grad()
def long_attention_reference(
    mode: int,
    q: torch.Tensor,  # [B, Lq, H*d]
    k: torch.Tensor,  # [B, Lk, H*d]
    v: torch.Tensor,  # [B, Lk, H*d]
    mask: torch.Tensor,  # [B, Lk] {0,1} (all ones for CAUSAL)
    rel_bias: Optional[torch.Tensor],  # [num_buckets, H] fp32, None without a bias
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Plain version of kernel 2 (the long-route forward of ``mode``): an
    fp32 online softmax over the 64-wide key tiles of :func:`_long_tiles`,
    the row max over valid keys only, output in q's dtype (0 for a row with
    no valid key). Not differentiable: :func:`long_attention_op` gives it the
    plain backward steps as its gradient."""
    b, lq, _ = q.shape
    vh = _heads(v, num_heads)
    m = torch.full((b, num_heads, lq), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, num_heads, lq, vh.shape[-1]), device=q.device)
    for k0, k1, r0, scores, valid, _ in _long_tiles(mode, q, k, mask, rel_bias, num_heads,
                                                    num_buckets, max_distance):
        scores = scores.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m[..., r0:], scores.amax(dim=-1))
        shift = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(scores - shift[..., None])  # invalid keys: exp(-inf) = 0
        scale = torch.exp(m[..., r0:] - shift)
        l[..., r0:] = l[..., r0:] * scale + p.sum(dim=-1)
        acc[..., r0:, :] = acc[..., r0:, :] * scale[..., None] + torch.matmul(p, vh[:, :, k0:k1])
        m[..., r0:] = m_new
    return _flat(acc / torch.where(l > 0, l, torch.ones_like(l))[..., None], q.dtype)


@torch.no_grad()
def long_lse_reference(
    mode: int, q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor], num_heads: int, num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Plain version of kernel 5: fp32 ``[B, H, Lq]`` log-sum-exp of each
    row over its valid keys by the same sweep without V, ``+inf`` for a row
    with none."""
    b, lq, _ = q.shape
    m = torch.full((b, num_heads, lq), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    for _, _, r0, scores, valid, _ in _long_tiles(mode, q, k, mask, rel_bias, num_heads,
                                                  num_buckets, max_distance):
        scores = scores.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m[..., r0:], scores.amax(dim=-1))
        shift = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        l[..., r0:] = (l[..., r0:] * torch.exp(m[..., r0:] - shift)
                       + torch.exp(scores - shift[..., None]).sum(dim=-1))
        m[..., r0:] = m_new
    return torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("inf")))


def _long_tile_grads(
    mode: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    mask: torch.Tensor, rel_bias: Optional[torch.Tensor], lse: torch.Tensor,
    delta: torch.Tensor, num_heads: int, num_buckets: int, max_distance: int,
) -> Iterator[LongTile]:
    """Per key tile of :func:`_long_tiles`: ``(k0, k1, r0, p, ds, near)``
    with ``P = exp(S - LSE)`` over the valid pairs and ``dS = P (dO v^T -
    delta)``, fp32 ``[B, H, Lq - r0, k1 - k0]``."""
    vh, gh = _heads(v, num_heads), _heads(dout, num_heads)
    for k0, k1, r0, scores, valid, near in _long_tiles(mode, q, k, mask, rel_bias, num_heads,
                                                       num_buckets, max_distance):
        p = torch.where(valid, torch.exp(scores - lse[..., r0:, None]), torch.zeros_like(scores))
        dp = torch.matmul(gh[:, :, r0:], vh[:, :, k0:k1].transpose(-1, -2))
        yield k0, k1, r0, p, p * (dp - delta[..., r0:, None]), near


@torch.no_grad()
def long_backward_dq_reference(
    mode: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    mask: torch.Tensor, rel_bias: Optional[torch.Tensor], lse: torch.Tensor,
    delta: torch.Tensor, num_heads: int, num_buckets: int = 32, max_distance: int = 128,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of kernel 6 -> ``(dq [B, Lq, H*d], bins)``: ``dq = dS
    k`` summed over the key tiles, and for the self-attentions dS summed per
    clamped relative position into fp32 ``[H, 2*max_distance+1]`` bins (a
    far pair's whole sum into the saturated end bin; :func:`fold_rel_bins`
    turns them into the bias gradient), None without a bias."""
    kh = _heads(k, num_heads)
    dq = torch.zeros(q.shape[0], num_heads, q.shape[1], kh.shape[-1], device=q.device)
    bins = None
    if has_bias(mode):
        bins = torch.zeros((num_heads, 2 * max_distance + 1), device=q.device)
    pos = torch.arange(max(q.shape[1], k.shape[1]), device=q.device)
    for k0, k1, r0, _, ds, near in _long_tile_grads(mode, q, k, v, dout, mask, rel_bias, lse,
                                                    delta, num_heads, num_buckets,
                                                    max_distance):
        dq[:, :, r0:] += torch.matmul(ds, kh[:, :, k0:k1])
        if near is not None:
            a, b = near
            per_head = ds.sum(dim=0)  # [H, Lq - r0, k1 - k0]
            bins[:, -1] += per_head[:, : a - r0].sum(dim=(1, 2))
            bins[:, 0] += per_head[:, b - r0:].sum(dim=(1, 2))
            if b > a:
                idx = (pos[None, k0:k1] - pos[a:b, None]).clamp(-max_distance, max_distance)
                bins.index_add_(1, (idx + max_distance).flatten(),
                                per_head[:, a - r0 : b - r0].reshape(num_heads, -1))
    return _flat(dq, q.dtype), bins


@torch.no_grad()
def long_backward_dkv_reference(
    mode: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    mask: torch.Tensor, rel_bias: Optional[torch.Tensor], lse: torch.Tensor,
    delta: torch.Tensor, num_heads: int, num_buckets: int = 32, max_distance: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 7 -> ``(dk, dv)`` ``[B, Lk, H*d]``: per key
    tile ``dk = dS^T q`` and ``dv = P^T dO`` over the queries that see it,
    each tile written once."""
    qh, gh = _heads(q, num_heads), _heads(dout, num_heads)
    shape = (k.shape[0], num_heads, k.shape[1], qh.shape[-1])
    dk = torch.zeros(shape, device=q.device)
    dv = torch.zeros(shape, device=q.device)
    for k0, k1, r0, p, ds, _ in _long_tile_grads(mode, q, k, v, dout, mask, rel_bias, lse,
                                                 delta, num_heads, num_buckets, max_distance):
        dk[:, :, k0:k1] = torch.matmul(ds.transpose(-1, -2), qh[:, :, r0:])
        dv[:, :, k0:k1] = torch.matmul(p.transpose(-1, -2), gh[:, :, r0:])
    return _flat(dk, k.dtype), _flat(dv, v.dtype)


def long_attention_forward(
    mode: int, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor], num_heads: int, num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """The long route's forward -> out: :func:`long_attention_reference` on
    CPU tensors, kernel 2 on CUDA tensors (or an error). Not
    differentiable; the public functions wrap it in :func:`long_attention_op`."""
    if _on_cpu(q, k, v, mask, rel_bias):
        return long_attention_reference(mode, q, k, v, mask, rel_bias, num_heads, num_buckets,
                                        max_distance)
    _check_card(mode, q, k, v, mask, rel_bias, num_heads, num_buckets)
    mask32, rel32, table = _kernel_operands(mode, mask, rel_bias, num_buckets, max_distance)
    return _forward_cuda(mode, q, k, v, mask32, rel32, table, num_heads, max_distance, False,
                         LONG)[0]


def long_attention_backward(
    mode: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    out: torch.Tensor,
    dout: torch.Tensor,
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The long route's gradient -> ``(dq, dk, dv, d_rel)``, d_rel fp32
    ``[num_buckets, H]`` or None without a bias. As the JAX package's
    ``_blockwise_backward_impl`` does: kernel 5 recomputes the LSE (the long
    forward saves none), ``delta = rowsum(dO * O)`` in plain torch, kernel 6
    gives dq and the bias-gradient bins, kernel 7 dk and dv. CPU tensors run
    each kernel's plain version; CUDA tensors the kernels, or an error."""
    dout = _kernel_dout(dout, q.dtype)
    if _on_cpu(q, k, v, mask, rel_bias, out, dout):
        table = bucket_table(num_buckets, max_distance, q.device,
                             mode == ENCODER) if has_bias(mode) else None
        geometry = (num_heads, num_buckets, max_distance)
        lse = long_lse_reference(mode, q, k, mask, rel_bias, *geometry)
        delta = row_delta(dout, out, num_heads)
        common = (mode, q, k, v, dout, mask, rel_bias, lse, delta, *geometry)
        dq, bins = long_backward_dq_reference(*common)
        dk, dv = long_backward_dkv_reference(*common)
    else:
        _check_card(mode, q, k, v, mask, rel_bias, num_heads, num_buckets)
        if dout.shape != q.shape or out.shape != q.shape:
            raise ValueError(f"{KERNEL_NAMES[mode]} backward: out and dout must be shaped like q")
        mask32, rel32, table = _kernel_operands(mode, mask, rel_bias, num_buckets, max_distance)
        lse = _forward_cuda(mode, q, k, v, mask32, rel32, table, num_heads, max_distance, True,
                            LONG_LSE)[1]
        delta = row_delta(dout, out, num_heads)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        bins = None
        if has_bias(mode):
            bins = torch.zeros((num_heads, 2 * max_distance + 1), dtype=torch.float32,
                               device=q.device)
        common = (q, k, v, dout, mask32, rel32, table, lse, delta)
        _backward_cuda(mode, "dq", *common, dq, bins, num_heads, max_distance, LONG)
        _backward_cuda(mode, "dkv", *common, dk, dv, num_heads, max_distance, LONG)
    d_rel = None if bins is None else fold_rel_bins(bins, table, num_buckets)
    return dq, dk, dv, d_rel


@torch.library.custom_op(f"{OP_NAMESPACE}::long_attention", mutates_args=(),
                         device_types="cpu")
def long_attention_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    mode: int,
    num_heads: int,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """The long route of ``mode`` -> out: kernel 2 forward, kernels 5, 6 and
    7 as its gradient, or their plain versions on CPU tensors (this body is
    the CPU implementation). Its residuals are the JAX package's: q, k, v,
    the mask, the bias table and the output, no LSE."""
    return long_attention_reference(mode, q, k, v, mask, rel_bias, num_heads, num_buckets,
                                    max_distance)


@long_attention_op.register_kernel("cuda")
def _long_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor], mode: int, num_heads: int, num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    return long_attention_forward(mode, q, k, v, mask, rel_bias, num_heads, num_buckets,
                                  max_distance)


def _long_attention_grad(ctx: Any, dout: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
    q, k, v, mask, rel_bias, out = ctx.saved_tensors
    dq, dk, dv, d_rel = long_attention_backward(ctx.mode, q, k, v, mask, rel_bias, out, dout,
                                                *ctx.geometry)
    d_rel = None if d_rel is None else d_rel.to(rel_bias.dtype)
    return dq, dk, dv, None, d_rel, None, None, None, None


long_attention_op.register_autograd(_long_attention_grad, setup_context=_save_residuals)

# The operators a rematerialization policy keeps (models/t5.py).
ATTENTION_OPS = (getattr(torch.ops, OP_NAMESPACE).attention.default,
                 getattr(torch.ops, OP_NAMESPACE).long_attention.default)


def _long_attention(
    mode: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: Optional[torch.Tensor],
    num_heads: int,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """The long route of the four public functions, on either device:
    :func:`long_attention_op` when a gradient is wanted, else the forward
    alone (each checks what the kernels take)."""
    if _wants_grad(q, k, v, rel_bias):
        return long_attention_op(q, k, v, mask, rel_bias, mode, num_heads, num_buckets,
                                 max_distance)
    return long_attention_forward(mode, q, k, v, mask, rel_bias, num_heads, num_buckets,
                                  max_distance)


def encoder_flash_attention(
    q: torch.Tensor,  # [B, L, H*d] — raw projection layout
    k: torch.Tensor,  # [B, L, H*d]
    v: torch.Tensor,  # [B, L, H*d]
    mask: torch.Tensor,  # [B, L] int {0,1}
    rel_bias: torch.Tensor,  # [num_buckets, H] fp32 (HF layout)
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
    block_kv: int = 0,
) -> torch.Tensor:
    """Bidirectional T5 self-attention -> ``[B, L, H*d]`` in the input dtype.
    Differentiable in q, k, v and ``rel_bias``.

    CPU tensors: :func:`encoder_attention_reference` (under a gradient,
    :func:`attention_op` with the plain forward's derivative). CUDA
    tensors: the forward kernel (fp32 or bf16, head width 64, contiguous
    q/k/v, one device), with the backward kernels as its gradient when grad
    is on and an input requires it, or an error. ``block_kv > 0`` or ``L >
    4096`` takes the long route (kernels 2, 5, 6, 7, or their plain versions
    on the CPU) instead; the kernels keep their 64-wide tiles whatever the
    value, so the result does not depend on it.
    """
    if takes_long_route(block_kv, q.shape[1], k.shape[1]):
        return _long_attention(ENCODER, q, k, v, mask, rel_bias, num_heads, num_buckets,
                               max_distance)
    return _kernel_attention(ENCODER, q, k, v, mask, rel_bias, num_heads, num_buckets,
                             max_distance)


def causal_flash_attention(
    q: torch.Tensor,  # [B, T, H*d] — raw projection layout
    k: torch.Tensor,  # [B, T, H*d]
    v: torch.Tensor,  # [B, T, H*d]
    rel_bias: torch.Tensor,  # [num_buckets, H] fp32 (HF layout)
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
    block_kv: int = 0,
) -> torch.Tensor:
    """Causal T5 decoder self-attention -> ``[B, T, H*d]``. Differentiable in
    q, k, v and ``rel_bias``. ``block_kv > 0`` or ``T > 4096`` takes the long
    route (see :func:`encoder_flash_attention`).

    No padding mask: HF T5 training feeds the decoder causal-only attention
    (pad positions are excluded through the -100 labels instead), as the
    JAX package's ``causal_flash_attention`` does with its all-ones key
    mask. CPU tensors: :func:`causal_attention_reference`. CUDA tensors: the
    causal kernels (unidirectional buckets, key ``k > q`` masked), or an
    error."""
    ones = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    if takes_long_route(block_kv, q.shape[1], k.shape[1]):
        return _long_attention(CAUSAL, q, k, v, ones, rel_bias, num_heads, num_buckets,
                               max_distance)
    return _kernel_attention(CAUSAL, q, k, v, ones, rel_bias, num_heads, num_buckets,
                             max_distance)


def cross_flash_attention(
    q: torch.Tensor,  # [B, T, H*d] — decoder-side queries, raw projection layout
    k: torch.Tensor,  # [B, S, H*d] — encoder-side keys
    v: torch.Tensor,  # [B, S, H*d]
    mask: torch.Tensor,  # [B, S] int {0,1} — encoder padding mask
    num_heads: int,
    block_kv: int = 0,
) -> torch.Tensor:
    """Encoder-decoder cross-attention -> ``[B, T, H*d]``. Differentiable in
    q, k and v. ``block_kv > 0``, ``S > 4096`` or ``T > 4096`` takes the
    long route (see :func:`encoder_flash_attention`).

    T5 cross-attention carries no positional bias, only the encoder padding
    mask. A query row whose source has no valid key gives 0 (the Pallas
    kernel gives the mean of ``v`` there). CPU tensors:
    :func:`cross_attention_reference`. CUDA tensors: the cross kernels, or
    an error."""
    if takes_long_route(block_kv, q.shape[1], k.shape[1]):
        return _long_attention(CROSS, q, k, v, mask, None, num_heads, 32, 128)
    return _kernel_attention(CROSS, q, k, v, mask, None, num_heads, 32, 128)


def scaled_causal_flash_attention(
    q: torch.Tensor,  # [B, T, H*d] — raw projection layout, RoPE applied
    k: torch.Tensor,  # [B, T, H*d] — GQA heads repeated to H
    v: torch.Tensor,  # [B, T, H*d]
    key_mask: torch.Tensor,  # [B, T] int {0,1} — padding mask over keys
    num_heads: int,
    scale: float,
    block_kv: int = 0,
) -> torch.Tensor:
    """Causal self-attention with the ``scale`` (1/sqrt(d)) and a key padding
    mask, no positional bias: the LLaMA family's teacher-forced form, RoPE
    applied to q and k upstream -> ``[B, T, H*d]``. Differentiable in q, k
    and v (the JAX package's ``scaled_causal_flash_attention`` without its
    TPU tiling arguments).

    The scale is folded into q first (:func:`scale_queries`), as the JAX
    package folds it. CPU tensors: the plain attention on the scaled q
    (as in :func:`encoder_flash_attention`). CUDA tensors: the ``SCALED_CAUSAL`` kernels (fp32 or
    bf16, head width 64 or 128, contiguous q/k/v), or an error. ``block_kv >
    0`` or ``T > 4096`` takes the long route (kernels 2, 5, 6, 7 in this
    mode; see :func:`encoder_flash_attention`). A query row with no valid key
    (left padding) gives 0 and zero gradients; the Pallas kernel gives it
    other values, which reach only that row's own output."""
    if takes_long_route(block_kv, q.shape[1], k.shape[1]):
        return _long_attention(SCALED_CAUSAL, scale_queries(q, scale), k, v, key_mask, None,
                               num_heads, 32, 128)
    return _kernel_attention(SCALED_CAUSAL, scale_queries(q, scale), k, v, key_mask, None,
                             num_heads, 32, 128)
