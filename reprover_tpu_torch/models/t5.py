"""T5 (ByT5) encoder-decoder in PyTorch: the counterpart of
:mod:`reprover_tpu.models.t5`.

Parameters are a plain nested dict of tensors in the JAX package's layout,
so one tree serves both packages through :mod:`reprover_tpu_torch.models.bridge`:

- dense weights are ``[in, out]`` (``y = x @ W``);
- per-layer weights are stacked on a leading ``[num_layers, ...]`` axis;
- the MLP is either split (``wi_0``/``wi_1``) or fused (``wi`` = gate|up).

Numerics follow the JAX package: RMSNorm statistics, softmax and the logits
run in float32; matrix products take ``compute_dtype`` inputs and accumulate
in float32 (cuBLAS does so for bfloat16, then rounds the output to bfloat16,
which is what ``preferred_element_type=float32`` followed by ``astype`` does).

The encoder's self-attention goes through
:func:`reprover_tpu_torch.ops.flash_attention.encoder_flash_attention`, and
the teacher-forced decoder's (:func:`decode`) through
``causal_flash_attention`` and ``cross_flash_attention``: on a CUDA tensor
those are the hand-written kernels, on a CPU tensor their plain versions.
The incremental decoder, and ``decode`` with a ``decoder_mask`` or with
``flash_attention=False``, use plain attention, as the JAX package leaves
it to XLA. Their attention scores are the matrix product's output in
``compute_dtype`` before the float32 softmax.

Training rematerializes each layer (``cfg.remat``) with one of the JAX
package's three policies: ``full`` recomputes the whole layer in backward;
``lite`` keeps the products the JAX package names ``qkv`` and
``mlp_hidden`` and the attention operators' outputs (``attn_out``, with its
LSE) in device memory, so the backward recomputes only the norms, the
elementwise ops, the weight casts and the output projection; ``offload``
keeps that same set in pinned host memory instead.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from reprover_tpu_torch.models.quantize import QuantWeight, quantized_dense, quantized_logits
from reprover_tpu_torch.ops.flash_attention import (
    ATTENTION_OPS,
    causal_flash_attention,
    cross_flash_attention,
    encoder_attention_reference,
    encoder_flash_attention,
)

Params = Dict[str, Any]

NEG_INF = -1e10

# Weights that feed a matrix product; the loaders store them in
# ``compute_dtype`` once instead of casting on every call.
MATMUL_WEIGHTS = frozenset(
    {"q", "k", "v", "o", "wi", "wi_0", "wi_1", "wo", "shared_embedding", "lm_head"}
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 384
    d_model: int = 1472
    d_kv: int = 64
    d_ff: int = 3584
    num_heads: int = 6
    num_encoder_layers: int = 12
    num_decoder_layers: int = 4
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    tie_word_embeddings: bool = False
    pad_token_id: int = 0
    eos_token_id: int = 1
    decoder_start_token_id: int = 0
    compute_dtype: torch.dtype = torch.float32
    # Rematerialize each encoder and teacher-forced decoder layer's
    # activations in backward (``torch.utils.checkpoint``): the JAX
    # package's ``remat``, with its policies (REMAT_POLICIES): "full"
    # recomputes the whole layer; "lite" keeps the named products and the
    # attention's outputs on the device; "offload" keeps them in pinned
    # host memory.
    remat: bool = False
    remat_policy: str = "full"
    # Send the encoder's self-attention down the long route (the KV-blocked
    # kernels 2, 5, 6, 7) at every length, as the JAX package's field does;
    # 0 leaves it to the length (past 4096). The kernels keep their 64-wide
    # tiles, so only the route depends on the value.
    flash_block_kv: int = 0

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


def byt5_small(**overrides: Any) -> T5Config:
    """google/byt5-small geometry (300M params)."""
    return T5Config(**overrides)


# ------------------------------------------------------------------ #
# Parameter init
# ------------------------------------------------------------------ #


def _normal(g: torch.Generator, shape: Tuple[int, ...], std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32) * std


def _attn_init(g: torch.Generator, cfg: T5Config) -> Params:
    # T5 init: q ~ N(0, (d_model*d_kv)^-0.5), k/v ~ N(0, d_model^-0.5),
    # o ~ N(0, inner^-0.5).
    d, inner = cfg.d_model, cfg.inner_dim
    return {
        "q": _normal(g, (d, inner), (d * cfg.d_kv) ** -0.5),
        "k": _normal(g, (d, inner), d ** -0.5),
        "v": _normal(g, (d, inner), d ** -0.5),
        "o": _normal(g, (inner, d), inner ** -0.5),
    }


def _mlp_init(g: torch.Generator, cfg: T5Config) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_0": _normal(g, (d, f), d ** -0.5),
        "wi_1": _normal(g, (d, f), d ** -0.5),
        "wo": _normal(g, (f, d), f ** -0.5),
    }


def _stack(trees: list) -> Params:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: T5Config, generator: torch.Generator) -> Params:
    """Random float32 CPU parameters with the T5 initialization scheme
    (the JAX package's ``init_params``; the draws themselves differ)."""
    g = generator
    ones = lambda: torch.ones(cfg.d_model)  # noqa: E731
    enc_layers = [
        {
            "attn": _attn_init(g, cfg),
            "attn_norm": ones(),
            "mlp": _mlp_init(g, cfg),
            "mlp_norm": ones(),
        }
        for _ in range(cfg.num_encoder_layers)
    ]
    dec_layers = [
        {
            "self_attn": _attn_init(g, cfg),
            "self_norm": ones(),
            "cross_attn": _attn_init(g, cfg),
            "cross_norm": ones(),
            "mlp": _mlp_init(g, cfg),
            "mlp_norm": ones(),
        }
        for _ in range(cfg.num_decoder_layers)
    ]
    nb, h = cfg.relative_attention_num_buckets, cfg.num_heads
    params: Params = {
        "shared_embedding": _normal(g, (cfg.vocab_size, cfg.d_model), 1.0),
        "encoder": {
            "rel_bias": _normal(g, (nb, h), cfg.d_model ** -0.5),
            "layers": _stack(enc_layers),
            "final_norm": ones(),
        },
        "decoder": {
            "rel_bias": _normal(g, (nb, h), cfg.d_model ** -0.5),
            "layers": _stack(dec_layers),
            "final_norm": ones(),
        },
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _normal(g, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5)
    return params


def fuse_mlp_params(params: Params) -> Params:
    """Concatenate each MLP's gate/up projections into one ``[D, 2F]``
    weight (one wider matrix product; numerics are unchanged)."""
    if isinstance(params, dict):
        if "wi_0" in params and "wi_1" in params:
            out = {k: v for k, v in params.items() if k not in ("wi_0", "wi_1")}
            out["wi"] = torch.cat([params["wi_0"], params["wi_1"]], dim=-1)
            return out
        return {k: fuse_mlp_params(v) for k, v in params.items()}
    return params


def place_params(params: Params, cfg: T5Config, device: Any) -> Params:
    """Move ``params`` to ``device``; matrix-product weights are stored in
    ``cfg.compute_dtype``, norms and bias tables stay float32, quantized
    weights keep their bytes."""

    def place(tree: Any, name: str) -> Any:
        if isinstance(tree, dict):
            return {k: place(v, k) for k, v in tree.items()}
        if isinstance(tree, QuantWeight):  # keeps its int8/int4 bytes and fp32 scales
            return tree.to(device)
        dtype = cfg.compute_dtype if name in MATMUL_WEIGHTS else torch.float32
        return tree.to(device=device, dtype=dtype).contiguous()

    return place(params, "")


def place_master_params(params: Params, device: Any) -> Params:
    """Move ``params`` to ``device`` as float32 leaves: the master weights of
    training, which Adam updates in float32. Each matrix product casts its
    weight to ``cfg.compute_dtype`` per call, as the JAX package's loaders
    keep float32 params and cast them in ``_dense``."""
    if isinstance(params, dict):
        return {k: place_master_params(v, device) for k, v in params.items()}
    return params.to(device=device, dtype=torch.float32).contiguous()


def default_dtype(device: torch.device) -> torch.dtype:
    """bfloat16 on a card, float32 on the CPU (the JAX loaders' TPU/CPU rule)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def resolve_device(device: Any) -> torch.device:
    """``torch.device(device)``; a CUDA device with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def layer_params(stacked: Params, i: int) -> Params:
    """Slice layer ``i`` out of a stacked ``[num_layers, ...]`` tree (views)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def unbind_layers(stacked: Params, num_layers: int) -> List[Params]:
    """All layers of a stacked tree as views, in one ``unbind`` per leaf: its
    gradient is one ``stack`` of the layers' gradients, where slicing each
    layer would add a full-size zero-filled tensor per layer."""
    if isinstance(stacked, dict):
        per_key = {k: unbind_layers(v, num_layers) for k, v in stacked.items()}
        return [{k: per_key[k][i] for k in per_key} for i in range(num_layers)]
    return list(stacked.unbind(0))


# ------------------------------------------------------------------ #
# Building blocks
# ------------------------------------------------------------------ #


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5 LayerNorm: RMS-only, no mean subtraction, fp32 statistics."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (HF 'gelu_new'), matching T5 gated-GELU."""
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * torch.pow(x, 3.0))))


def _dense(x: torch.Tensor, w: Any, dtype: torch.dtype, name: Optional[str] = None
           ) -> torch.Tensor:
    """``x @ w`` in ``dtype``; ``name`` is the JAX package's checkpoint name of
    the product, which a selective remat policy reads (:data:`SAVED_NAMES`)."""
    if isinstance(w, QuantWeight):  # weight-only int8/int4 serving
        return quantized_dense(x, w, dtype)
    if name is None:
        return torch.matmul(x.to(dtype), w.to(dtype))
    _naming.name = name
    try:
        return torch.matmul(x.to(dtype), w.to(dtype))
    finally:
        _naming.name = None


def relative_position_bucket(
    relative_position: torch.Tensor,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> torch.Tensor:
    """T5 log-binned relative position bucketing (exact HF semantics; the
    log is taken in float32, as the JAX package takes it)."""
    rel = relative_position.to(torch.int32)
    ret = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        ret = ret + (rel > 0).to(torch.int32) * num_buckets
        rp = rel.abs()
    else:
        rp = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rp < max_exact
    scale = torch.tensor(math.log(max_distance / max_exact), dtype=torch.float32)
    rp_large = max_exact + (
        torch.log(rp.float() / max_exact + 1e-20) / scale * (num_buckets - max_exact)
    ).to(torch.int32)
    rp_large = torch.clamp(rp_large, max=num_buckets - 1)
    return ret + torch.where(is_small, rp, rp_large)


def compute_position_bias(
    rel_bias: torch.Tensor,  # [num_buckets, H] fp32
    query_positions: torch.Tensor,
    key_positions: torch.Tensor,
    bidirectional: bool,
    cfg: T5Config,
) -> torch.Tensor:
    """Relative position bias ``[1, H, Q, K]`` fp32 from position vectors."""
    rel = key_positions[None, :] - query_positions[:, None]
    buckets = relative_position_bucket(
        rel,
        bidirectional,
        cfg.relative_attention_num_buckets,
        cfg.relative_attention_max_distance,
    )
    bias = rel_bias.float()[buckets.long()]  # [Q, K, H]
    return bias.permute(2, 0, 1)[None]


def _split_heads(x: torch.Tensor, num_heads: int, d_kv: int) -> torch.Tensor:
    b, l, _ = x.shape
    return x.view(b, l, num_heads, d_kv).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def attention(
    q: torch.Tensor,  # [..., Q, d]
    k: torch.Tensor,  # [..., K, d]
    v: torch.Tensor,  # [..., K, d]
    bias: Optional[torch.Tensor],  # additive fp32, broadcastable to [..., Q, K]
    dtype: torch.dtype,
) -> torch.Tensor:
    """Unscaled dot-product attention with fp32 softmax (T5 has no 1/sqrt(d))."""
    scores = torch.matmul(q.to(dtype), k.to(dtype).transpose(-1, -2)).float()
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs, v.to(dtype))


def _mlp_block(x: torch.Tensor, p: Params, cfg: T5Config) -> torch.Tensor:
    dtype = cfg.compute_dtype
    if "wi" in p:
        gate, up = _dense(x, p["wi"], dtype, "mlp_hidden").chunk(2, dim=-1)
    else:
        gate, up = _dense(x, p["wi_0"], dtype, "mlp_hidden"), _dense(x, p["wi_1"], dtype,
                                                                      "mlp_hidden")
    return _dense(gelu_new(gate) * up, p["wo"], dtype)


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """``[B, K]`` {0,1} mask -> additive fp32 bias ``[B, 1, 1, K]``."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :].bool(), zero, NEG_INF)


def _lm_logits(params: Params, cfg: T5Config, h: torch.Tensor) -> torch.Tensor:
    """Logits in float32 from ``compute_dtype`` operands, as the JAX
    package's ``preferred_element_type=float32`` gives them."""
    dtype = cfg.compute_dtype
    if cfg.tie_word_embeddings:
        h = h * (cfg.d_model ** -0.5)
        w = params["shared_embedding"].t()
    else:
        w = params["lm_head"]
    if isinstance(w, QuantWeight):
        return quantized_logits(h, w, dtype)
    return torch.matmul(h.to(dtype).float(), w.to(dtype).float())


# ------------------------------------------------------------------ #
# Rematerialization
# ------------------------------------------------------------------ #

REMAT_POLICIES = ("full", "lite", "offload")
# The products a selective policy keeps, by the JAX package's checkpoint
# names (``t5.py:310-326, 364-368``); it also keeps the outputs of the
# attention operators (ATTENTION_OPS), the JAX package's "attn_out", whose
# backward needs them (out and LSE) and would otherwise run the forward
# kernel again. The fp32 masters' casts to ``compute_dtype`` are not kept:
# each layer would hold a copy of its weights.
SAVED_NAMES = frozenset({"qkv", "mlp_hidden"})
_PRODUCTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                       torch.ops.aten.addmm.default})
_naming = threading.local()  # .name: the checkpoint name of the product being computed


def check_remat_policy(cfg: T5Config) -> None:
    """Raise ``ValueError`` for a remat policy that is not one of
    :data:`REMAT_POLICIES` (the JAX package takes any other name as
    "full")."""
    if cfg.remat and cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got "
                         f"{cfg.remat_policy!r}")


def _keeps(func: Any) -> bool:
    """Whether a selective policy keeps this operator's outputs."""
    if func in ATTENTION_OPS:
        return True
    return func in _PRODUCTS and getattr(_naming, "name", None) in SAVED_NAMES


def _park(t: torch.Tensor, offload: bool) -> Tuple[torch.Tensor, Optional[torch.device]]:
    """A kept output: the tensor itself, or with ``offload`` a CUDA tensor's
    copy in pinned host memory (asynchronous, ordered on the stream before
    anything that reuses the device memory) and the device to return it to."""
    if offload and t.is_cuda:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host, t.device
    return t.detach(), None


def _unpark(kept: Tuple[torch.Tensor, Optional[torch.device]]) -> torch.Tensor:
    t, device = kept
    return t.detach() if device is None else t.to(device, non_blocking=True)


def _park_outputs(out: Any, offload: bool) -> Tuple[bool, List[Any]]:
    """An operator's output (a tensor or a tuple of them), parked."""
    outs = out if isinstance(out, tuple) else (out,)
    return isinstance(out, tuple), [_park(t, offload) for t in outs]


def _unpark_outputs(kept: Tuple[bool, List[Any]]) -> Any:
    is_tuple, parked = kept
    outs = tuple(_unpark(x) for x in parked)
    return outs if is_tuple else outs[0]


class _KeepMode(TorchDispatchMode):
    """A layer's forward under a selective policy: every operator runs, and
    the outputs of those it keeps (:func:`_keeps`) are stored in order."""

    def __init__(self, kept: Deque[Any], offload: bool) -> None:
        super().__init__()
        self.kept, self.offload = kept, offload

    def __torch_dispatch__(self, func: Any, types: Any, args: Tuple[Any, ...] = (),
                           kwargs: Optional[Dict[str, Any]] = None) -> Any:
        out = func(*args, **(kwargs or {}))
        if _keeps(func):
            self.kept.append(_park_outputs(out, self.offload))
        return out


class _ReplayMode(TorchDispatchMode):
    """That layer's recompute in backward: a kept operator returns its stored
    outputs (back on the device) instead of running; every other one runs
    again."""

    def __init__(self, kept: Deque[Any]) -> None:
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func: Any, types: Any, args: Tuple[Any, ...] = (),
                           kwargs: Optional[Dict[str, Any]] = None) -> Any:
        if _keeps(func):
            return _unpark_outputs(self.kept.popleft())
        return func(*args, **(kwargs or {}))


def _rematerialized(layer: Callable[..., torch.Tensor], cfg: T5Config
                    ) -> Callable[..., torch.Tensor]:
    """``layer`` under ``torch.utils.checkpoint`` with ``cfg.remat_policy``
    (the JAX package's ``_layer_remat``). A selective policy is a pair of
    dispatch modes: the forward stores what it keeps, the recompute reads it
    back in the same order."""
    check_remat_policy(cfg)
    if cfg.remat_policy == "full":
        return functools.partial(torch.utils.checkpoint.checkpoint, layer, use_reentrant=False)
    offload = cfg.remat_policy == "offload"

    def run(*args: Any) -> torch.Tensor:
        kept: Deque[Any] = collections.deque()
        return torch.utils.checkpoint.checkpoint(
            layer, *args, use_reentrant=False,
            context_fn=lambda: (_KeepMode(kept, offload), _ReplayMode(kept)))

    return run


# ------------------------------------------------------------------ #
# Encoder
# ------------------------------------------------------------------ #


def encode(
    params: Params,
    cfg: T5Config,
    input_ids: torch.Tensor,  # int [B, L]
    attention_mask: torch.Tensor,  # int [B, L]
    attention_fn: Callable[..., torch.Tensor] = encoder_flash_attention,
) -> torch.Tensor:
    """Encoder forward -> last hidden states ``[B, L, d_model]``.

    Self-attention runs through ``encoder_flash_attention`` at any ``L``:
    the kernels mask their own ragged tile, so no length condition applies
    (the JAX package's flash path needs ``L % 128 == 0``). Past 4096, or at
    any length with ``cfg.flash_block_kv``, it takes the long route.
    ``attention_fn`` lets a check, or :func:`forward_loss`'s
    ``flash_attention=False``, run the plain version
    (``encoder_attention_reference``) instead. With ``cfg.remat`` and grad
    on, each layer runs under ``torch.utils.checkpoint`` with
    ``cfg.remat_policy``.
    """
    dtype = cfg.compute_dtype
    enc = params["encoder"]
    eps = cfg.layer_norm_epsilon
    route = {"block_kv": cfg.flash_block_kv} if cfg.flash_block_kv else {}

    def layer(h: torch.Tensor, lp: Params) -> torch.Tensor:
        p = lp["attn"]
        n = rms_norm(h, lp["attn_norm"], eps)
        attn = attention_fn(
            _dense(n, p["q"], dtype, "qkv"),
            _dense(n, p["k"], dtype, "qkv"),
            _dense(n, p["v"], dtype, "qkv"),
            attention_mask,
            enc["rel_bias"],
            num_heads=cfg.num_heads,
            num_buckets=cfg.relative_attention_num_buckets,
            max_distance=cfg.relative_attention_max_distance,
            **route,
        )
        h = h + _dense(attn, p["o"], dtype)
        return h + _mlp_block(rms_norm(h, lp["mlp_norm"], eps), lp["mlp"], cfg)

    if cfg.remat and torch.is_grad_enabled():
        layer = _rematerialized(layer, cfg)
    h = params["shared_embedding"].to(dtype)[input_ids]
    for lp in unbind_layers(enc["layers"], cfg.num_encoder_layers):
        h = layer(h, lp)
    return rms_norm(h, enc["final_norm"], eps)


# ------------------------------------------------------------------ #
# Decoder (teacher-forced full-sequence) and the seq2seq loss
# ------------------------------------------------------------------ #


def shift_right(ids: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """Prepend ``decoder_start_token_id``; also maps -100 label fill to pad
    (HF `T5ForConditionalGeneration._shift_right` semantics)."""
    shifted = torch.roll(ids, 1, dims=-1)
    shifted[:, 0] = cfg.decoder_start_token_id
    return torch.where(shifted == -100, torch.full_like(shifted, cfg.pad_token_id), shifted)


def _attn_block(
    x: torch.Tensor, kv_src: torch.Tensor, p: Params, bias: torch.Tensor, cfg: T5Config
) -> torch.Tensor:
    """Plain multi-head attention of ``x`` over ``kv_src`` plus the output
    projection (the naive path of :func:`decode`)."""
    dtype = cfg.compute_dtype
    q = _split_heads(_dense(x, p["q"], dtype, "qkv"), cfg.num_heads, cfg.d_kv)
    k = _split_heads(_dense(kv_src, p["k"], dtype, "qkv"), cfg.num_heads, cfg.d_kv)
    v = _split_heads(_dense(kv_src, p["v"], dtype, "qkv"), cfg.num_heads, cfg.d_kv)
    return _dense(_merge_heads(attention(q, k, v, bias, dtype)), p["o"], dtype)


def decode(
    params: Params,
    cfg: T5Config,
    encoder_hidden: torch.Tensor,  # [B, S, d_model]
    encoder_mask: torch.Tensor,  # [B, S]
    decoder_input_ids: torch.Tensor,  # int [B, T]
    decoder_mask: Optional[torch.Tensor] = None,  # [B, T] or None (causal only)
    flash_attention: bool = True,
) -> torch.Tensor:
    """Teacher-forced decoder forward -> logits ``[B, T, vocab]`` fp32.

    With ``decoder_mask=None`` (training's case: HF T5 feeds the decoder
    causal-only attention) the self- and cross-attention go through
    ``causal_flash_attention`` and ``cross_flash_attention`` at any length:
    the kernels on the card, their plain versions on the CPU; a source or
    target past 4096 takes the long route there, as in the JAX package,
    which passes no ``block_kv`` to them. With a ``decoder_mask``, or with
    ``flash_attention=False``, the naive path runs, padding keys masked
    with the finite ``NEG_INF``, as in the JAX package. With ``cfg.remat``
    and grad on, each layer runs under ``torch.utils.checkpoint`` with
    ``cfg.remat_policy``.
    """
    dtype = cfg.compute_dtype
    dec = params["decoder"]
    eps = cfg.layer_norm_epsilon
    enc_h = encoder_hidden.to(dtype)

    if decoder_mask is None and flash_attention:

        def layer(h: torch.Tensor, lp: Params) -> torch.Tensor:
            n = rms_norm(h, lp["self_norm"], eps)
            p = lp["self_attn"]
            # Flat [B, T, H*d] projection layout straight into the kernels.
            attn = causal_flash_attention(
                _dense(n, p["q"], dtype, "qkv"),
                _dense(n, p["k"], dtype, "qkv"),
                _dense(n, p["v"], dtype, "qkv"),
                dec["rel_bias"],
                num_heads=cfg.num_heads,
                num_buckets=cfg.relative_attention_num_buckets,
                max_distance=cfg.relative_attention_max_distance,
            )
            h = h + _dense(attn, p["o"], dtype)
            pc = lp["cross_attn"]
            n = rms_norm(h, lp["cross_norm"], eps)
            attn = cross_flash_attention(
                _dense(n, pc["q"], dtype, "qkv"),
                _dense(enc_h, pc["k"], dtype, "qkv"),
                _dense(enc_h, pc["v"], dtype, "qkv"),
                encoder_mask,
                num_heads=cfg.num_heads,
            )
            h = h + _dense(attn, pc["o"], dtype)
            return h + _mlp_block(rms_norm(h, lp["mlp_norm"], eps), lp["mlp"], cfg)

    else:
        positions = torch.arange(decoder_input_ids.shape[1], device=decoder_input_ids.device)
        self_bias = compute_position_bias(dec["rel_bias"], positions, positions, False, cfg)
        causal = (positions[None, :] <= positions[:, None])[None, None]
        self_bias = torch.where(causal, self_bias, torch.full_like(self_bias, NEG_INF))
        if decoder_mask is not None:
            self_bias = self_bias + _mask_bias(decoder_mask)
        cross_bias = _mask_bias(encoder_mask)

        def layer(h: torch.Tensor, lp: Params) -> torch.Tensor:
            n = rms_norm(h, lp["self_norm"], eps)
            h = h + _attn_block(n, n, lp["self_attn"], self_bias, cfg)
            n = rms_norm(h, lp["cross_norm"], eps)
            h = h + _attn_block(n, enc_h, lp["cross_attn"], cross_bias, cfg)
            return h + _mlp_block(rms_norm(h, lp["mlp_norm"], eps), lp["mlp"], cfg)

    if cfg.remat and torch.is_grad_enabled():
        layer = _rematerialized(layer, cfg)
    h = params["shared_embedding"].to(dtype)[decoder_input_ids]
    for lp in unbind_layers(dec["layers"], cfg.num_decoder_layers):
        h = layer(h, lp)
    return _lm_logits(params, cfg, rms_norm(h, dec["final_norm"], eps))


def cross_entropy_loss(
    logits: torch.Tensor,  # [B, T, V] fp32
    labels: torch.Tensor,  # [B, T] int, -100 = ignored
) -> torch.Tensor:
    """Token-mean cross entropy with -100 masking (HF ``labels`` semantics,
    `reference/generation/model.py:101-111`)."""
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)


def forward_loss(
    params: Params,
    cfg: T5Config,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    labels: torch.Tensor,
    flash_attention: bool = True,
) -> torch.Tensor:
    """Seq2seq CE loss with HF ``labels`` semantics (shift-right inside).
    ``flash_attention=False`` runs the plain attention in the encoder and the
    decoder instead of the kernels: the JAX package's naive path, an A/B
    switch (pretraining's ``--model.flash false``), never a fallback."""
    attention_fn = encoder_flash_attention if flash_attention else encoder_attention_reference
    enc = encode(params, cfg, input_ids, attention_mask, attention_fn)
    logits = decode(params, cfg, enc, attention_mask, shift_right(labels, cfg),
                    flash_attention=flash_attention)
    return cross_entropy_loss(logits, labels)


# ------------------------------------------------------------------ #
# Incremental decoding (KV cache) for beam search
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class DecodeState:
    """Decoder state for incremental decoding over ``N = B * num_beams`` rows.

    ``self_k``/``self_v``: ``[L, N, H, max_len, d_kv]`` KV cache, written in
    place by :func:`decode_step`.
    ``cross_k``/``cross_v``: ``[L, B, H, S, d_kv]``, computed once per source.
    Rows ``b * num_beams .. (b + 1) * num_beams - 1`` share source ``b``, so
    the cross cache is read once per source, not once per beam (the JAX
    package tiles it per beam; the dot products are the same).
    ``cross_bias``: ``[B, 1, 1, S]`` additive fp32 source mask.
    ``step``: number of tokens already written.
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_bias: torch.Tensor
    num_beams: int
    step: int = 0


def init_decode_state(
    params: Params,
    cfg: T5Config,
    encoder_hidden: torch.Tensor,  # [B, S, d_model]
    encoder_mask: torch.Tensor,  # [B, S]
    max_decode_len: int,
    num_beams: int = 1,
) -> DecodeState:
    """Allocate the KV cache and precompute cross-attention keys/values."""
    dtype = cfg.compute_dtype
    b = encoder_hidden.shape[0]
    dec_layers = params["decoder"]["layers"]
    enc_h = encoder_hidden.to(dtype)
    ks, vs = [], []
    for i in range(cfg.num_decoder_layers):
        ca = layer_params(dec_layers, i)["cross_attn"]
        ks.append(_split_heads(_dense(enc_h, ca["k"], dtype), cfg.num_heads, cfg.d_kv))
        vs.append(_split_heads(_dense(enc_h, ca["v"], dtype), cfg.num_heads, cfg.d_kv))
    shape = (
        cfg.num_decoder_layers,
        b * num_beams,
        cfg.num_heads,
        max_decode_len,
        cfg.d_kv,
    )
    dev = encoder_hidden.device
    return DecodeState(
        self_k=torch.zeros(shape, dtype=dtype, device=dev),
        self_v=torch.zeros(shape, dtype=dtype, device=dev),
        cross_k=torch.stack(ks),
        cross_v=torch.stack(vs),
        cross_bias=_mask_bias(encoder_mask),
        num_beams=num_beams,
    )


def _cross_attention(
    q: torch.Tensor,  # [N, H, 1, d]
    ck: torch.Tensor,  # [B, H, S, d]
    cv: torch.Tensor,  # [B, H, S, d]
    bias: torch.Tensor,  # [B, 1, 1, S]
    num_beams: int,
    dtype: torch.dtype,
) -> torch.Tensor:
    """Beams of one source attend as a ``[H, num_beams, S]`` block."""
    n, h, _, d = q.shape
    b = n // num_beams
    qb = q.view(b, num_beams, h, d).transpose(1, 2)  # [B, H, K, d]
    out = attention(qb, ck, cv, bias, dtype)  # [B, H, K, d]
    return out.transpose(1, 2).reshape(n, h, 1, d)


def decode_step(
    params: Params,
    cfg: T5Config,
    state: DecodeState,
    token: torch.Tensor,  # int [N] — token at position ``state.step``
) -> Tuple[torch.Tensor, DecodeState]:
    """One incremental decoder step -> (logits ``[N, vocab]`` fp32, state).

    The self-attention cache is updated in place (the returned state shares
    its tensors); attention reads only the ``step + 1`` filled positions,
    which is what the JAX package's masked full-length read computes.
    """
    dtype = cfg.compute_dtype
    dec = params["decoder"]
    eps = cfg.layer_norm_epsilon
    pos = state.step
    dev = token.device

    h = params["shared_embedding"].to(dtype)[token][:, None, :]  # [N, 1, D]
    self_bias = compute_position_bias(
        dec["rel_bias"],
        torch.tensor([pos], device=dev),
        torch.arange(pos + 1, device=dev),
        False,
        cfg,
    )  # [1, H, 1, pos + 1]

    for i in range(cfg.num_decoder_layers):
        lp = layer_params(dec["layers"], i)
        sa, ca = lp["self_attn"], lp["cross_attn"]

        n = rms_norm(h, lp["self_norm"], eps)
        q = _split_heads(_dense(n, sa["q"], dtype), cfg.num_heads, cfg.d_kv)
        k_new = _split_heads(_dense(n, sa["k"], dtype), cfg.num_heads, cfg.d_kv)
        v_new = _split_heads(_dense(n, sa["v"], dtype), cfg.num_heads, cfg.d_kv)
        state.self_k[i, :, :, pos] = k_new[:, :, 0]
        state.self_v[i, :, :, pos] = v_new[:, :, 0]
        attn = attention(
            q,
            state.self_k[i, :, :, : pos + 1],
            state.self_v[i, :, :, : pos + 1],
            self_bias,
            dtype,
        )
        h = h + _dense(_merge_heads(attn), sa["o"], dtype)

        n = rms_norm(h, lp["cross_norm"], eps)
        q = _split_heads(_dense(n, ca["q"], dtype), cfg.num_heads, cfg.d_kv)
        attn = _cross_attention(
            q, state.cross_k[i], state.cross_v[i], state.cross_bias, state.num_beams, dtype
        )
        h = h + _dense(_merge_heads(attn), ca["o"], dtype)

        h = h + _mlp_block(rms_norm(h, lp["mlp_norm"], eps), lp["mlp"], cfg)

    h = rms_norm(h, dec["final_norm"], eps)
    logits = _lm_logits(params, cfg, h)[:, 0, :]
    return logits, dataclasses.replace(state, step=pos + 1)


def reorder_decode_state(state: DecodeState, flat_parent: torch.Tensor) -> DecodeState:
    """Make row ``i`` of the self-attention cache a copy of row
    ``flat_parent[i]`` (beam search's per-step reorder). Only the filled
    positions are copied; parents never cross sources, so the cross cache
    stays as it is."""
    n = state.step
    state.self_k[:, :, :, :n] = state.self_k[:, flat_parent, :, :n]
    state.self_v[:, :, :, :n] = state.self_v[:, flat_parent, :, :n]
    return state
