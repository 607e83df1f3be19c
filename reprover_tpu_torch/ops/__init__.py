"""Device ops: the T5 attention kernels (encoder, causal decoder, cross),
the sequence-parallel ring attention, pooling and masked top-k."""

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
    "ring_encoder_attention",
]


def __getattr__(name: str) -> object:
    # Lazy, as in the JAX package: the ring imports the mesh's collectives,
    # whose package imports the quantized weights, which import this one.
    if name == "ring_encoder_attention":
        from reprover_tpu_torch.ops.ring_attention import ring_encoder_attention

        return ring_encoder_attention
    raise AttributeError(name)
