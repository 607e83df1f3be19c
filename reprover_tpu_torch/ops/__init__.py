"""Device ops: the encoder-attention kernel, pooling and masked top-k."""

from reprover_tpu_torch.ops.flash_attention import (
    encoder_attention_reference,
    encoder_flash_attention,
)
from reprover_tpu_torch.ops.pooling import masked_mean_normalize
from reprover_tpu_torch.ops.topk import cosine_topk, masked_topk

__all__ = [
    "encoder_attention_reference",
    "encoder_flash_attention",
    "masked_mean_normalize",
    "cosine_topk",
    "masked_topk",
]
