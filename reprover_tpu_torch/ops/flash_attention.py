"""Fused T5 encoder self-attention: a CUDA kernel for Hopper and its plain
PyTorch version.

The kernel (``reprover_tpu_torch/csrc/encoder_attn.cu``) replaces
``reprover_tpu/ops/flash_attention.py::_encoder_attn_kernel``, the Pallas
TPU kernel behind ``encoder_flash_attention``. It computes, per batch row
and head on the flat ``[B, L, H*d]`` layout, unscaled ``q k^T`` plus the
bidirectional T5 relative-position bias, drops masked key columns, takes an
exact fp32 softmax and multiplies by ``v``. A query row with no valid key
gives 0.

What bounds it on the H100: the score work (``4 L^2 d`` operations per
batch row and head) against ``4 L d`` elements moved makes it compute-bound
from L of a few hundred on; the plain version's cost is the ``[B, H, L, L]``
fp32 score tensor it writes and reads back. The kernel never forms that
tensor: one block per (64-query tile, head, batch row) walks 64-key tiles
with a running row max and sum, with its tiles in shared memory and fp32
FMA loops (tensor cores are left for a later change).

Two choices differ from the Pallas kernel on purpose:

- the row max is taken over valid keys only, so a masked score far above
  the valid ones cannot underflow the row (the Pallas kernel takes it over
  all columns); the result equals the JAX package's naive path;
- the relative-position buckets come from a table of ``2*max_distance+1``
  int32 values built here with the plain bucket function, indexed by
  ``clamp(k - q, -max_distance, max_distance)`` (buckets saturate beyond
  ``max_distance``), so the kernel takes no float log and no bucket can
  flip at an exact boundary such as ``|k - q| = 16, 32, 64``.

A CPU tensor goes to :func:`encoder_attention_reference`; a CUDA tensor
launches the kernel or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

# Launches of the CUDA kernel in this process: the wrapper adds one where it
# launches and nowhere else, so a run can show that its path used the kernel.
KERNEL_LAUNCHES = 0

HEAD_DIM = 64
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

_tables: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}


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
    """Plain PyTorch version of the kernel: fp32 throughout, the full
    ``[B, H, L, L]`` score tensor, output in the input dtype."""
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
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    p = torch.exp(scores - row_max)  # masked columns: exp(-inf) = 0
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)  # 0 only for rows with no valid key
    out = torch.matmul(p, heads(v)) / denom
    return out.transpose(1, 2).reshape(b, l, inner).to(q.dtype)


def _check_kernel_inputs(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: torch.Tensor,
    num_heads: int,
    num_buckets: int,
) -> None:
    """Raise on anything the kernel does not take."""
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

    CPU tensors: :func:`encoder_attention_reference`. CUDA tensors: the
    kernel (fp32 or bf16, head width 64, contiguous q/k/v, one device), or
    an error. Forward only.
    """
    global KERNEL_LAUNCHES
    tensors = (q, k, v, mask, rel_bias)
    if all(t.device.type == "cpu" for t in tensors):
        return encoder_attention_reference(
            q, k, v, mask, rel_bias, num_heads, num_buckets, max_distance
        )
    _check_kernel_inputs(q, k, v, mask, rel_bias, num_heads, num_buckets)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_flash_attention: no kernel for device {q.device}")

    from reprover_tpu_torch.ops.native import load_library

    lib = load_library()
    b, l, _ = q.shape
    out = torch.empty_like(q)
    if b == 0 or l == 0:
        return out
    mask32 = mask.to(torch.int32).contiguous()
    rel32 = rel_bias.to(torch.float32).contiguous()
    table = bucket_table(num_buckets, max_distance, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.encoder_attn_forward(
        ptr(q), ptr(k), ptr(v), ptr(mask32), ptr(rel32), ptr(table), ptr(out),
        b, l, num_heads, max_distance, int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(
            f"encoder_attn kernel launch failed: {lib.kernel_error_string(err).decode()} ({err})"
        )
    KERNEL_LAUNCHES += 1
    return out
