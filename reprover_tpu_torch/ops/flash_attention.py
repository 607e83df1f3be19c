"""Fused T5 attention and its gradient: CUDA kernels for Hopper and their
plain PyTorch versions, for the three attentions of T5.

- :func:`encoder_flash_attention`: bidirectional encoder self-attention
  with the relative-position bias and the encoder's key mask;
- :func:`causal_flash_attention`: the teacher-forced decoder's
  self-attention, with the bias from unidirectional buckets and key
  ``k > q`` masked;
- :func:`cross_flash_attention`: decoder-encoder attention, no bias, the
  encoder's key mask, query length ``T`` and key length ``S`` independent.

One forward kernel (``reprover_tpu_torch/csrc/encoder_attn.cu``) and two
backward kernels (``csrc/encoder_attn_bwd.cu``, dQ and dK/dV) serve all
three, each compiled once per attention (a template mode), so each
attention has three kernels with a launch count of their own in
:data:`KERNEL_LAUNCHES`. They replace the Pallas TPU kernels of
``reprover_tpu/ops/flash_attention.py``: ``_encoder_attn_kernel`` (:176,
also with ``causal=True`` behind ``causal_flash_attention``, :1553),
``_bwd_dq_kernel`` (:607) and ``_bwd_dkv_kernel`` (:715) (both also causal,
:1343, :1384), and ``_cross_attn_kernel`` (:1624), ``_cross_bwd_dq_kernel``
(:1721) and ``_cross_bwd_dkv_kernel`` (:1757). Per batch row and head on
the flat ``[B, L, H*d]`` layout they compute unscaled ``q k^T`` plus the
bias, drop masked key columns, take an exact fp32 softmax and multiply by
``v``; a query row with no valid key gives 0. Under training the forward
also stores each row's log-sum-exp.

The JAX package wires the backward kernels with ``jax.custom_vjp``; here
:class:`_KernelAttention`, a ``torch.autograd.Function`` taking the
attention as its first argument, does it for all three. It saves q, k, v,
the mask, the bias table, the output and the LSE (never an ``[Lq, Lk]``
tensor), and its backward rebuilds ``P = exp(S - LSE)`` tile by tile. The
relative-bias gradient comes out of the dQ kernel as sums of dS per clamped
relative position ``k - q`` (``2*max_distance+1`` bins), which
:func:`fold_rel_bins` folds into the buckets here.

What bounds them on the H100: the score work (``4 Lq Lk d`` operations per
batch row and head forward, about 2.5x that backward) against
``O((Lq + Lk) d)`` elements moved makes them compute-bound from a few
hundred keys on; the plain version's cost is the ``[B, H, Lq, Lk]`` fp32
tensors it writes and reads back (and, under autograd, keeps). The kernels
never form them: each block owns a 64-row tile, walks the other side in
64-wide tiles in shared memory, and runs fp32 FMA loops (tensor cores are
left for a later change); a causal block stops at its diagonal tile.

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
:func:`causal_attention_reference`, :func:`cross_attention_reference`, whose
autograd is the backward's plain version, and the step-by-step
``*_backward_reference`` functions); a CUDA tensor launches the kernels or
raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

# Launches of each CUDA kernel in this process: each wrapper adds one where
# it launches and nowhere else, so a run can show that its path used them.
KERNEL_LAUNCHES: Dict[str, int] = {
    "encoder_attn": 0,
    "encoder_attn_bwd_dq": 0,
    "encoder_attn_bwd_dkv": 0,
    "causal_attn": 0,
    "causal_attn_bwd_dq": 0,
    "causal_attn_bwd_dkv": 0,
    "cross_attn": 0,
    "cross_attn_bwd_dq": 0,
    "cross_attn_bwd_dkv": 0,
}

# The kernels' modes (csrc/encoder_attn_common.cuh) and their count names.
ENCODER, CAUSAL, CROSS = 0, 1, 2
KERNEL_NAMES = {ENCODER: "encoder_attn", CAUSAL: "causal_attn", CROSS: "cross_attn"}

HEAD_DIM = 64
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
CrossGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_tables: Dict[Tuple[int, int, bool, torch.device], torch.Tensor] = {}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


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
    if mode == CROSS:
        return scores
    idx = rel_index(q.shape[1], max_distance, q.device)
    table = bucket_table(num_buckets, max_distance, q.device, mode == ENCODER).long()
    return scores + rel_bias.float()[table[idx]].permute(2, 0, 1)[None]


def _valid(mode: int, mask: Optional[torch.Tensor], q: torch.Tensor) -> torch.Tensor:
    """bool, broadcastable to ``[B, H, Lq, Lk]``: the pairs a kernel keeps."""
    if mode == CAUSAL:
        return _causal_valid(q.shape[1], q.device)
    return mask.bool()[:, None, None, :]


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


def row_delta(dout: torch.Tensor, out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` per head: fp32 ``[B, H, L]`` (plain torch
    on every device, as the JAX package computes it outside Pallas)."""
    b, l, inner = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(b, l, num_heads, inner // num_heads).sum(-1).transpose(1, 2).contiguous()


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
    d_rel = None
    if mode != CROSS:
        l = q.shape[1]
        idx = rel_index(l, max_distance, q.device).flatten()
        bins = torch.zeros((num_heads, 2 * max_distance + 1), dtype=torch.float32, device=q.device)
        bins.index_add_(1, idx, ds.sum(0).reshape(num_heads, l * l))
        table = bucket_table(num_buckets, max_distance, q.device, mode == ENCODER)
        d_rel = fold_rel_bins(bins, table, num_buckets)
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
    if inner != num_heads * HEAD_DIM:
        raise ValueError(
            f"{name}: the kernel takes head width {HEAD_DIM}, got {inner} / {num_heads} heads"
        )
    if tuple(mask.shape) != (b, lk):
        raise ValueError(f"{name}: mask must be [{b}, {lk}], got {tuple(mask.shape)}")
    if mode != CROSS and (rel_bias is None or tuple(rel_bias.shape) != (num_buckets, num_heads)):
        raise ValueError(
            f"{name}: rel_bias must be [{num_buckets}, {num_heads}], got "
            f"{None if rel_bias is None else tuple(rel_bias.shape)}"
        )
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if b > 65535 or num_heads > 65535:
        raise ValueError(f"{name}: batch and heads must be <= 65535")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


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
    the bias and table are None for CROSS."""
    mask32 = mask.to(torch.int32).contiguous()
    if mode == CROSS:
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
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel -> (out, LSE ``[B, H, Lq]`` fp32 or None)."""
    from reprover_tpu_torch.ops.native import load_library

    lib = load_library()
    b, lq, _ = q.shape
    lk = k.shape[1]
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, lq), dtype=torch.float32, device=q.device) if with_lse else None
    if b == 0 or lq == 0:
        return out, lse
    name = KERNEL_NAMES[mode]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.t5_attn_forward(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask32), _ptr(rel32), _ptr(table), _ptr(out), _ptr(lse),
        b, lq, lk, num_heads, 0 if mode == CROSS else max_distance, mode,
        int(q.dtype == torch.bfloat16), ctypes.c_void_p(stream),
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
) -> None:
    """Launch one backward kernel: ``part`` ``"dq"`` writes dq into ``out_a``
    and adds the bins into ``out_b`` (None for CROSS); ``"dkv"`` writes dk
    and dv."""
    from reprover_tpu_torch.ops.native import load_library

    lib = load_library()
    b, lq, _ = q.shape
    lk = k.shape[1]
    if b == 0 or lq == 0 or lk == 0:
        return
    name = f"{KERNEL_NAMES[mode]}_bwd_{part}"
    entry = {"dq": lib.t5_attn_backward_dq, "dkv": lib.t5_attn_backward_dkv}[part]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = entry(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(mask32), _ptr(rel32), _ptr(table),
        _ptr(lse), _ptr(delta), _ptr(out_a), _ptr(out_b),
        b, lq, lk, num_heads, 0 if mode == CROSS else max_distance, mode,
        int(q.dtype == torch.bfloat16), ctypes.c_void_p(stream),
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
    d_rel None for CROSS."""
    name = KERNEL_NAMES[mode]
    _check_kernel_inputs(q, k, v, mask, rel_bias, num_heads, num_buckets, mode)
    if q.device.type != "cuda":
        raise ValueError(f"{name} backward: no kernel for device {q.device}")
    b, lq, _ = q.shape
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"{name} backward: out and dout must be shaped like q")
    if tuple(lse.shape) != (b, num_heads, lq) or lse.dtype != torch.float32:
        raise ValueError(f"{name} backward: lse must be fp32 [{b}, {num_heads}, {lq}]")
    dout = dout.to(q.dtype).contiguous()
    lse = lse.contiguous()
    mask32, rel32, table = _kernel_operands(mode, mask, rel_bias, num_buckets, max_distance)
    delta = row_delta(dout, out, num_heads)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bins = None
    if mode != CROSS:
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


class _KernelAttention(torch.autograd.Function):
    """The forward kernel of one attention (``mode``) with its backward
    kernels as its gradient."""

    @staticmethod
    def forward(  # type: ignore[override]
        ctx: Any,
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
        mask32, rel32, table = _kernel_operands(mode, mask, rel_bias, num_buckets, max_distance)
        out, lse = _forward_cuda(mode, q, k, v, mask32, rel32, table, num_heads, max_distance,
                                 True)
        # Flash-style residuals: inputs, output and LSE, never an [Lq, Lk] tensor.
        ctx.save_for_backward(q, k, v, mask32, rel32, out, lse)
        ctx.geometry = (num_heads, num_buckets, max_distance)
        ctx.mode = mode
        ctx.bias_dtype = None if rel_bias is None else rel_bias.dtype
        return out

    @staticmethod
    def backward(  # type: ignore[override]
        ctx: Any, dout: torch.Tensor
    ) -> Tuple[Optional[torch.Tensor], ...]:
        q, k, v, mask32, rel32, out, lse = ctx.saved_tensors
        dq, dk, dv, d_rel = _backward_kernels(
            ctx.mode, q, k, v, mask32, rel32, out, lse, dout, *ctx.geometry
        )
        d_rel = None if d_rel is None else d_rel.to(ctx.bias_dtype)
        return None, dq, dk, dv, None, d_rel, None, None, None


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
    """The card path of the three public functions: checks, then the
    autograd.Function when a gradient is wanted, else the forward kernel
    alone (no LSE)."""
    _check_kernel_inputs(q, k, v, mask, rel_bias, num_heads, num_buckets, mode)
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL_NAMES[mode]}: no kernel for device {q.device}")
    leaves = [t for t in (q, k, v, rel_bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _KernelAttention.apply(mode, q, k, v, mask, rel_bias, num_heads, num_buckets,
                                      max_distance)
    mask32, rel32, table = _kernel_operands(mode, mask, rel_bias, num_buckets, max_distance)
    return _forward_cuda(mode, q, k, v, mask32, rel32, table, num_heads, max_distance, False)[0]


def encoder_flash_attention(
    q: torch.Tensor,  # [B, L, H*d] — raw projection layout
    k: torch.Tensor,  # [B, L, H*d]
    v: torch.Tensor,  # [B, L, H*d]
    mask: torch.Tensor,  # [B, L] int {0,1}
    rel_bias: torch.Tensor,  # [num_buckets, H] fp32 (HF layout)
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Bidirectional T5 self-attention -> ``[B, L, H*d]`` in the input dtype.
    Differentiable in q, k, v and ``rel_bias``.

    CPU tensors: :func:`encoder_attention_reference` (plain autograd). CUDA
    tensors: the forward kernel (fp32 or bf16, head width 64, contiguous
    q/k/v, one device), with the backward kernels as its gradient when grad
    is on and an input requires it, or an error.
    """
    if _on_cpu(q, k, v, mask, rel_bias):
        return encoder_attention_reference(
            q, k, v, mask, rel_bias, num_heads, num_buckets, max_distance
        )
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
) -> torch.Tensor:
    """Causal T5 decoder self-attention -> ``[B, T, H*d]``. Differentiable in
    q, k, v and ``rel_bias``.

    No padding mask: HF T5 training feeds the decoder causal-only attention
    (pad positions are excluded through the -100 labels instead), as the
    JAX package's ``causal_flash_attention`` does with its all-ones key
    mask. CPU tensors: :func:`causal_attention_reference`. CUDA tensors: the
    causal kernels (unidirectional buckets, key ``k > q`` masked), or an
    error."""
    if _on_cpu(q, k, v, rel_bias):
        return causal_attention_reference(q, k, v, rel_bias, num_heads, num_buckets, max_distance)
    ones = torch.ones(q.shape[:2], dtype=torch.int32, device=q.device)
    return _kernel_attention(CAUSAL, q, k, v, ones, rel_bias, num_heads, num_buckets,
                             max_distance)


def cross_flash_attention(
    q: torch.Tensor,  # [B, T, H*d] — decoder-side queries, raw projection layout
    k: torch.Tensor,  # [B, S, H*d] — encoder-side keys
    v: torch.Tensor,  # [B, S, H*d]
    mask: torch.Tensor,  # [B, S] int {0,1} — encoder padding mask
    num_heads: int,
) -> torch.Tensor:
    """Encoder-decoder cross-attention -> ``[B, T, H*d]``. Differentiable in
    q, k and v.

    T5 cross-attention carries no positional bias, only the encoder padding
    mask. A query row whose source has no valid key gives 0 (the Pallas
    kernel gives the mean of ``v`` there). CPU tensors:
    :func:`cross_attention_reference`. CUDA tensors: the cross kernels, or
    an error."""
    if _on_cpu(q, k, v, mask):
        return cross_attention_reference(q, k, v, mask, num_heads)
    return _kernel_attention(CROSS, q, k, v, mask, None, num_heads, 32, 128)
