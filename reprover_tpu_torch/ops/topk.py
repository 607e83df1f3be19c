"""Masked top-k premise query: the counterpart of :mod:`reprover_tpu.ops.topk`.

Exact only. Ties break toward the lowest index, as ``lax.top_k`` breaks
them and as a stable descending argsort does (the reference's
filter-after-argsort ranking); ``torch.topk`` promises no order among ties,
so the top ``k`` come from a stable sort.
"""

from __future__ import annotations

from typing import Tuple

import torch


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last axis, descending, equal values in index
    order -> (values, int64 indices)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def masked_topk(
    scores: torch.Tensor,  # [B, N] fp32
    mask: torch.Tensor,  # [B, N] bool / {0,1}
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over ``scores`` restricted to ``mask`` -> (values, indices).

    Masked-out entries score ``-inf``; if fewer than ``k`` entries are
    accessible the trailing values are ``-inf``.
    """
    masked = scores.masked_fill(~mask.bool(), float("-inf"))
    return stable_topk(masked, k)


def cosine_topk(
    context_emb: torch.Tensor,  # [B, D] unit-norm
    premise_emb: torch.Tensor,  # [N, D] unit-norm
    mask: torch.Tensor,  # [B, N]
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cosine-similarity masked top-k: one fp32 matrix product + top-k."""
    sims = torch.matmul(context_emb.float(), premise_emb.float().t())
    return masked_topk(sims, mask, k)
