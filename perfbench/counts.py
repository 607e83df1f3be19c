"""Operations and bytes from shapes, and the chip's published peaks.

A multiply-add counts as two operations. Counts are of the work the shapes
need, whatever kernel computes it: padded positions count where the shape
that ran holds them, since the program computed them. Bytes count each
input read once and each output written once.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the full 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _inner(s: Dict[str, Any]) -> int:
    return s["num_heads"] * s["d_kv"]


def dense_flops_per_token(s: Dict[str, Any]) -> int:
    """One encoder layer's matrix products for one token: q, k, v, o and
    the gated MLP (two input projections and the output)."""
    d, f, inner = s["d_model"], s["d_ff"], _inner(s)
    return 2 * 4 * d * inner + 2 * 3 * d * f


def attention_flops(s: Dict[str, Any], rows: int, q_len: int, k_len: int) -> int:
    """Scores and weighted values of ``rows`` sequences, ``q_len`` queries
    over ``k_len`` keys, every head."""
    return 2 * 2 * rows * q_len * k_len * _inner(s)


def encoder_flops(s: Dict[str, Any], rows: int, length: int) -> int:
    """The encoder forward of ``rows`` sequences padded to ``length``."""
    per_layer = rows * length * dense_flops_per_token(s) + attention_flops(s, rows, length, length)
    return s["num_layers"] * per_layer


def encoder_attention_bytes(s: Dict[str, Any], rows: int, length: int, elem: int = 2) -> int:
    """One encoder layer's attention forward: q, k, v read, the output
    written (``elem`` bytes each), the ``[rows, length]`` mask read as
    int32; the bias table is negligible."""
    return 4 * rows * length * _inner(s) * elem + 4 * rows * length


def encoder_attention_bound_s(s: Dict[str, Any], rows: int, length: int) -> Tuple[float, str]:
    """Least time of one encoder attention forward on the chip, and which
    peak sets it."""
    ops = attention_flops(s, rows, length, length) / PEAK_BF16_FLOPS
    mem = encoder_attention_bytes(s, rows, length) / PEAK_HBM_BYTES
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def cross_kv_flops(s: Dict[str, Any], rows: int, length: int) -> int:
    """Projecting ``rows`` encoded sources of ``length`` to every decoder
    layer's cross-attention keys and values."""
    return s["num_decoder_layers"] * 2 * 2 * rows * length * s["d_model"] * _inner(s)


def decode_step_flops(s: Dict[str, Any], rows: int, cache_len: int, src_len: int) -> int:
    """One incremental decoder step of ``rows`` (slot x beam) rows over a
    self-attention cache of ``cache_len`` columns plus the new one and a
    source of ``src_len``: self q, k, v, o, cross q and o, the MLP, both
    attentions, the output projection."""
    d, f, inner, v = s["d_model"], s["d_ff"], _inner(s), s["vocab_size"]
    per_layer = (2 * rows * d * inner * 6 + 2 * rows * 3 * d * f
                 + attention_flops(s, rows, 1, cache_len + 1)
                 + attention_flops(s, rows, 1, src_len))
    return s["num_decoder_layers"] * per_layer + 2 * rows * d * v


def mfu_pct(flops: float, seconds: float, chips: int = 1) -> float:
    """Share of the chips' bf16 peak, in percent."""
    return 100.0 * flops / (seconds * chips * PEAK_BF16_FLOPS)


def padded_length(n_tokens: int, multiple: int, cap: int) -> int:
    """The length a batch whose longest row has ``n_tokens`` is padded to:
    the next multiple of ``multiple``, at most ``cap`` rounded up to it."""
    r = ((max(n_tokens, 1) + multiple - 1) // multiple) * multiple
    top = ((cap + multiple - 1) // multiple) * multiple
    return min(r, top)


def batch_lengths(token_counts: Iterable[int], batch: int, multiple: int, cap: int) -> list:
    """Padded length of each batch when rows sorted by length are cut into
    batches of ``batch`` (the retriever's re-index)."""
    counts = sorted(token_counts)
    return [padded_length(counts[min(lo + batch, len(counts)) - 1], multiple, cap)
            for lo in range(0, len(counts), batch)]
