"""Sequence pooling for the premise retriever: the counterpart of
:mod:`reprover_tpu.ops.pooling`.

Masked mean over real tokens, then L2 normalization, in fp32 whatever the
encoder's activation dtype.
"""

from __future__ import annotations

import torch


def masked_mean_normalize(
    hidden: torch.Tensor,  # [B, L, D]
    mask: torch.Tensor,  # [B, L] {0,1}
    eps: float = 1e-12,
) -> torch.Tensor:
    """Masked mean-pool + L2 normalize -> unit-norm embeddings ``[B, D]`` fp32."""
    h = hidden.float()
    m = mask.float()
    summed = torch.einsum("bld,bl->bd", h, m)
    lens = m.sum(dim=1, keepdim=True).clamp_min(1.0)
    mean = summed / lens
    norm = torch.linalg.vector_norm(mean, dim=1, keepdim=True).clamp_min(eps)
    return mean / norm
