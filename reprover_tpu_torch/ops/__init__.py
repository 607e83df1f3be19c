"""Device ops: the T5 attention kernels (encoder, causal decoder, cross),
pooling and masked top-k."""

from reprover_tpu_torch.ops.flash_attention import (
    causal_attention_reference,
    causal_flash_attention,
    cross_attention_reference,
    cross_flash_attention,
    encoder_attention_reference,
    encoder_flash_attention,
)
from reprover_tpu_torch.ops.pooling import masked_mean_normalize
from reprover_tpu_torch.ops.topk import cosine_topk, masked_topk

__all__ = [
    "causal_attention_reference",
    "causal_flash_attention",
    "cross_attention_reference",
    "cross_flash_attention",
    "encoder_attention_reference",
    "encoder_flash_attention",
    "masked_mean_normalize",
    "cosine_topk",
    "masked_topk",
]
