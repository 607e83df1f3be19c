"""Fused T5 encoder self-attention and its gradient: CUDA kernels for Hopper
and their plain PyTorch versions.

The forward kernel (``reprover_tpu_torch/csrc/encoder_attn.cu``) replaces
``reprover_tpu/ops/flash_attention.py::_encoder_attn_kernel``, the Pallas
TPU kernel behind ``encoder_flash_attention``. It computes, per batch row
and head on the flat ``[B, L, H*d]`` layout, unscaled ``q k^T`` plus the
bidirectional T5 relative-position bias, drops masked key columns, takes an
exact fp32 softmax and multiplies by ``v``. A query row with no valid key
gives 0. Under training it also stores each row's log-sum-exp.

The backward kernels (``reprover_tpu_torch/csrc/encoder_attn_bwd.cu``)
replace ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``, which the JAX package
wires with ``jax.custom_vjp``; here :class:`_KernelAttention`, a
``torch.autograd.Function``, does it. It saves q, k, v, the mask, the bias
table, the output and the LSE (never an ``[L, L]`` tensor), and its
backward rebuilds ``P = exp(S - LSE)`` tile by tile. The relative-bias
gradient comes out of the dQ kernel as sums of dS per clamped relative
position ``k - q`` (``2*max_distance+1`` bins), which :func:`fold_rel_bins`
folds into the buckets here.

What bounds them on the H100: the score work (``4 L^2 d`` operations per
batch row and head forward, about 2.5x that backward) against ``O(L d)``
elements moved makes them compute-bound from L of a few hundred on; the
plain version's cost is the ``[B, H, L, L]`` fp32 tensors it writes and
reads back (and, under autograd, keeps). The kernels never form them: each
block owns a 64-row tile, walks the other side in 64-wide tiles in shared
memory, and runs fp32 FMA loops (tensor cores are left for a later change).

Two choices differ from the Pallas kernels on purpose:

- the row max is taken over valid keys only, so a masked score far above
  the valid ones cannot underflow the row (the Pallas forward takes it over
  all columns); the result equals the JAX package's naive path, and the
  backward agrees with it: masked keys and rows with no valid key get zero
  gradients;
- the relative-position buckets come from a table of ``2*max_distance+1``
  int32 values built here with the plain bucket function, indexed by
  ``clamp(k - q, -max_distance, max_distance)`` (buckets saturate beyond
  ``max_distance``), so the kernels take no float log and no bucket can
  flip at an exact boundary such as ``|k - q| = 16, 32, 64``.

A CPU tensor goes to the plain versions (:func:`encoder_attention_reference`,
whose autograd is the backward's plain version, and
:func:`encoder_attention_backward_reference`); a CUDA tensor launches the
kernels or raises. There is no fallback between the two.
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
}

HEAD_DIM = 64
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

_tables: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def bucket_table(num_buckets: int, max_distance: int, device: torch.device) -> torch.Tensor:
    """int32 ``[2*max_distance+1]``: the bidirectional bucket of relative
    position ``r`` at index ``r + max_distance``."""
    key = (num_buckets, max_distance, torch.device(device))
    table = _tables.get(key)
    if table is None:
        from reprover_tpu_torch.models.t5 import relative_position_bucket

        rel = torch.arange(-max_distance, max_distance + 1)
        table = relative_position_bucket(rel, True, num_buckets, max_distance)
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
    """Plain PyTorch version of the forward kernel: fp32 throughout, the full
    ``[B, H, L, L]`` score tensor, output in the input dtype.

    Differentiable: the row max is detached (it cancels in the softmax),
    masked columns enter as ``exp(-inf) = 0`` and a row with no valid key
    divides by 1, so autograd gives zero (never NaN) gradients there."""
    from reprover_tpu_torch.models.t5 import relative_position_bucket

    b, l, inner = q.shape
    d = inner // num_heads

    def heads(x: torch.Tensor) -> torch.Tensor:
        return x.float().reshape(b, l, num_heads, d).transpose(1, 2)

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2))  # [B, H, L, L]
    pos = torch.arange(l, device=q.device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None], True, num_buckets, max_distance)
    scores = scores + rel_bias.float()[buckets.long()].permute(2, 0, 1)[None]
    valid = mask.bool()[:, None, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))
    row_max = scores.detach().amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    p = torch.exp(scores - row_max)  # masked columns: exp(-inf) = 0
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))  # 0 only for empty rows
    out = torch.matmul(p, heads(v)) / denom
    return out.transpose(1, 2).reshape(b, l, inner).to(q.dtype)


def _scores_plain(
    q: torch.Tensor, k: torch.Tensor, rel_bias: torch.Tensor, num_heads: int,
    num_buckets: int, max_distance: int,
) -> torch.Tensor:
    """fp32 ``[B, H, L, L]`` scores ``q k^T + bias`` through the bucket table,
    as the kernels index it."""
    b, l, inner = q.shape
    d = inner // num_heads
    qh = q.float().reshape(b, l, num_heads, d).transpose(1, 2)
    kh = k.float().reshape(b, l, num_heads, d).transpose(1, 2)
    idx = rel_index(l, max_distance, q.device)
    table = bucket_table(num_buckets, max_distance, q.device).long()
    bias = rel_bias.float()[table[idx]].permute(2, 0, 1)[None]  # [1, H, L, L]
    return torch.matmul(qh, kh.transpose(-1, -2)) + bias


def encoder_attention_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: torch.Tensor,
    num_heads: int,
    num_buckets: int = 32,
    max_distance: int = 128,
) -> torch.Tensor:
    """Plain version of the forward kernel's LSE output: fp32 ``[B, H, L]``
    log-sum-exp of each row over its valid keys, ``+inf`` for a row with
    none."""
    scores = _scores_plain(q, k, rel_bias, num_heads, num_buckets, max_distance)
    scores = scores.masked_fill(~mask.bool()[:, None, None, :], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    return torch.where(torch.isfinite(lse), lse, torch.full_like(lse, float("inf")))


def row_delta(dout: torch.Tensor, out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` per head: fp32 ``[B, H, L]`` (plain torch
    on every device, as the JAX package computes it outside Pallas)."""
    b, l, inner = out.shape
    prod = dout.float() * out.float()
    return prod.reshape(b, l, num_heads, inner // num_heads).sum(-1).transpose(1, 2).contiguous()


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
    """Plain version of the two backward kernels, step for step: ``P`` from
    the LSE, ``dS = P (dP - delta)``, dS binned by clamped relative position
    and folded into the buckets. Returns ``(dq, dk, dv, d_rel)``: dq/dk/dv in
    the input dtype ``[B, L, H*d]``, d_rel fp32 ``[num_buckets, H]``."""
    b, l, inner = q.shape
    d = inner // num_heads

    def heads(x: torch.Tensor) -> torch.Tensor:
        return x.float().reshape(b, l, num_heads, d).transpose(1, 2)

    def flat(x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2).reshape(b, l, inner).to(q.dtype)

    scores = _scores_plain(q, k, rel_bias, num_heads, num_buckets, max_distance)
    valid = mask.bool()[:, None, None, :]
    p = torch.where(valid, torch.exp(scores - lse[..., None]), torch.zeros_like(scores))
    gh = heads(dout)
    dp = torch.matmul(gh, heads(v).transpose(-1, -2))
    ds = p * (dp - row_delta(dout, out, num_heads)[..., None])
    idx = rel_index(l, max_distance, q.device).flatten()
    bins = torch.zeros((num_heads, 2 * max_distance + 1), dtype=torch.float32, device=q.device)
    bins.index_add_(1, idx, ds.sum(0).reshape(num_heads, l * l))
    d_rel = fold_rel_bins(bins, bucket_table(num_buckets, max_distance, q.device), num_buckets)
    dq = torch.matmul(ds, heads(k))
    dk = torch.matmul(ds.transpose(-1, -2), heads(q))
    dv = torch.matmul(p.transpose(-1, -2), gh)
    return flat(dq), flat(dk), flat(dv), d_rel


def _check_kernel_inputs(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: torch.Tensor,
    num_heads: int,
    num_buckets: int,
) -> None:
    """Raise on anything the kernels do not take."""
    devices = {t.device for t in (q, k, v, mask, rel_bias)}
    if len(devices) != 1:
        raise ValueError(f"encoder_flash_attention: tensors on several devices: {devices}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"encoder_flash_attention: q, k, v must share one of {KERNEL_DTYPES}, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"encoder_flash_attention: q, k, v must be [B, L, H*d] alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, l, inner = q.shape
    if inner != num_heads * HEAD_DIM:
        raise ValueError(
            f"encoder_flash_attention: the kernel takes head width {HEAD_DIM}, got "
            f"{inner} / {num_heads} heads"
        )
    if tuple(mask.shape) != (b, l):
        raise ValueError(f"encoder_flash_attention: mask must be [{b}, {l}], got {tuple(mask.shape)}")
    if tuple(rel_bias.shape) != (num_buckets, num_heads):
        raise ValueError(
            f"encoder_flash_attention: rel_bias must be [{num_buckets}, {num_heads}], "
            f"got {tuple(rel_bias.shape)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"encoder_flash_attention: {name} must be contiguous")
    if b > 65535 or num_heads > 65535:
        raise ValueError("encoder_flash_attention: batch and heads must be <= 65535")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _raise_on_error(lib: Any, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.kernel_error_string(err).decode()} ({err})"
        )


def _kernel_operands(
    mask: torch.Tensor, rel_bias: torch.Tensor, num_buckets: int, max_distance: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(int32 mask, fp32 bias, int32 bucket table), contiguous on the card."""
    return (
        mask.to(torch.int32).contiguous(),
        rel_bias.to(torch.float32).contiguous(),
        bucket_table(num_buckets, max_distance, mask.device),
    )


def _forward_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask32: torch.Tensor,
    rel32: torch.Tensor,
    table: torch.Tensor,
    num_heads: int,
    max_distance: int,
    with_lse: bool,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel -> (out, LSE ``[B, H, L]`` fp32 or None)."""
    from reprover_tpu_torch.ops.native import load_library

    lib = load_library()
    b, l, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, l), dtype=torch.float32, device=q.device) if with_lse else None
    if b == 0 or l == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.encoder_attn_forward(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask32), _ptr(rel32), _ptr(table), _ptr(out), _ptr(lse),
        b, l, num_heads, max_distance, int(q.dtype == torch.bfloat16), ctypes.c_void_p(stream),
    )
    _raise_on_error(lib, err, "encoder_attn")
    KERNEL_LAUNCHES["encoder_attn"] += 1
    return out, lse


def _backward_cuda(
    name: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    mask32: torch.Tensor,
    rel32: torch.Tensor,
    table: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    out_a: torch.Tensor,
    out_b: torch.Tensor,
    num_heads: int,
    max_distance: int,
) -> None:
    """Launch one backward kernel (``name`` is ``encoder_attn_bwd_dq``, which
    writes dq into ``out_a`` and adds the bins into ``out_b``, or
    ``encoder_attn_bwd_dkv``, which writes dk and dv)."""
    from reprover_tpu_torch.ops.native import load_library

    lib = load_library()
    b, l, _ = q.shape
    if b == 0 or l == 0:
        return
    entry = {"encoder_attn_bwd_dq": lib.encoder_attn_backward_dq,
             "encoder_attn_bwd_dkv": lib.encoder_attn_backward_dkv}[name]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = entry(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(mask32), _ptr(rel32), _ptr(table),
        _ptr(lse), _ptr(delta), _ptr(out_a), _ptr(out_b),
        b, l, num_heads, max_distance, int(q.dtype == torch.bfloat16), ctypes.c_void_p(stream),
    )
    _raise_on_error(lib, err, name)
    KERNEL_LAUNCHES[name] += 1


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
    tensors = (q, k, v, mask, rel_bias, out, lse, dout)
    if all(t.device.type == "cpu" for t in tensors):
        return encoder_attention_backward_reference(
            q, k, v, mask, rel_bias, out, lse, dout, num_heads, num_buckets, max_distance
        )
    _check_kernel_inputs(q, k, v, mask, rel_bias, num_heads, num_buckets)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention_backward: no kernel for device {q.device}")
    b, l, _ = q.shape
    if dout.shape != q.shape or out.shape != q.shape:
        raise ValueError("encoder_attention_backward: out and dout must be shaped like q")
    if tuple(lse.shape) != (b, num_heads, l) or lse.dtype != torch.float32:
        raise ValueError(f"encoder_attention_backward: lse must be fp32 [{b}, {num_heads}, {l}]")
    dout = dout.to(q.dtype).contiguous()
    lse = lse.contiguous()
    mask32, rel32, table = _kernel_operands(mask, rel_bias, num_buckets, max_distance)
    delta = row_delta(dout, out, num_heads)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bins = torch.zeros((num_heads, 2 * max_distance + 1), dtype=torch.float32, device=q.device)
    common = (q, k, v, dout, mask32, rel32, table, lse, delta)
    _backward_cuda("encoder_attn_bwd_dq", *common, dq, bins, num_heads, max_distance)
    _backward_cuda("encoder_attn_bwd_dkv", *common, dk, dv, num_heads, max_distance)
    return dq, dk, dv, fold_rel_bins(bins, table, num_buckets)


class _KernelAttention(torch.autograd.Function):
    """The forward kernel with the backward kernels as its gradient."""

    @staticmethod
    def forward(  # type: ignore[override]
        ctx: Any,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        mask: torch.Tensor,
        rel_bias: torch.Tensor,
        num_heads: int,
        num_buckets: int,
        max_distance: int,
    ) -> torch.Tensor:
        mask32, rel32, table = _kernel_operands(mask, rel_bias, num_buckets, max_distance)
        out, lse = _forward_cuda(q, k, v, mask32, rel32, table, num_heads, max_distance, True)
        # Flash-style residuals: inputs, output and LSE, never an [L, L] tensor.
        ctx.save_for_backward(q, k, v, mask32, rel32, out, lse)
        ctx.geometry = (num_heads, num_buckets, max_distance)
        ctx.bias_dtype = rel_bias.dtype
        return out

    @staticmethod
    def backward(  # type: ignore[override]
        ctx: Any, dout: torch.Tensor
    ) -> Tuple[Optional[torch.Tensor], ...]:
        q, k, v, mask32, rel32, out, lse = ctx.saved_tensors
        dq, dk, dv, d_rel = encoder_attention_backward(
            q, k, v, mask32, rel32, out, lse, dout, *ctx.geometry
        )
        return dq, dk, dv, None, d_rel.to(ctx.bias_dtype), None, None, None


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
    tensors = (q, k, v, mask, rel_bias)
    if all(t.device.type == "cpu" for t in tensors):
        return encoder_attention_reference(
            q, k, v, mask, rel_bias, num_heads, num_buckets, max_distance
        )
    _check_kernel_inputs(q, k, v, mask, rel_bias, num_heads, num_buckets)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, rel_bias)):
        return _KernelAttention.apply(q, k, v, mask, rel_bias, num_heads, num_buckets, max_distance)
    mask32, rel32, table = _kernel_operands(mask, rel_bias, num_buckets, max_distance)
    return _forward_cuda(q, k, v, mask32, rel32, table, num_heads, max_distance, False)[0]
