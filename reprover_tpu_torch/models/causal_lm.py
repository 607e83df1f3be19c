"""Decoder-only (LLaMA-family) causal LM in PyTorch: the counterpart of
:mod:`reprover_tpu.models.causal_lm`.

RMSNorm pre-norm, rotary position embeddings (HF ``rotate_half``),
grouped-query attention and a SwiGLU MLP. Parameters are a nested dict in
the JAX package's layout (``[in, out]`` dense weights, per-layer weights
stacked on a leading ``[num_layers, ...]`` axis), so one tree serves both
packages through :mod:`reprover_tpu_torch.models.bridge`; matrix-product
weights may be :class:`~reprover_tpu_torch.models.quantize.QuantWeight`.
Numerics follow the port's T5: norms, softmax and logits in float32,
products of ``compute_dtype`` operands.

Prompts are LEFT-padded (the HF decoder-only convention), so every
sequence's last real token sits in the last column; RoPE positions come
from the mask; fine-tuning batches are right-padded. The full-sequence
forward (plain attention, or with ``flash_attention=True`` and ``T % 128 ==
0`` the fused scaled causal attention of
:func:`~reprover_tpu_torch.ops.flash_attention.scaled_causal_flash_attention`:
the CUDA kernels on a card, their plain version on the CPU),
``causal_lm_loss`` (decoder-only fine-tuning), ``prefill`` and the in-place
incremental ``decode_step``.

Under a tensor-parallel ``mesh`` (``model`` > 1) each rank holds its
Megatron part (:func:`~reprover_tpu_torch.parallel.sharding.shard_for_model`):
q/k/v/gate/up split by columns, o/down by rows, ``lm_head`` by the
vocabulary. The forward takes its query and KV head counts from the shards'
widths (GQA on the local KV heads), sums o and down over ``model`` and
gathers the logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from reprover_tpu_torch.models.quantize import (
    QuantWeight,
    quantize_leaf,
    quantized_dense,
    quantized_logits,
    stack_quantized,
)
from reprover_tpu_torch.models.t5 import layer_params
from reprover_tpu_torch.parallel.collectives import (
    copy_to_model,
    gather_from_model,
    model_parallel,
    reduce_from_model,
)
from reprover_tpu_torch.ops.flash_attention import scaled_causal_flash_attention

Params = Dict[str, Any]

NEG_INF = -1e10

_MATMULS = ("q", "k", "v", "o", "gate", "up", "down")


@dataclasses.dataclass(frozen=True)
class CausalLMConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32  # < num_heads => grouped-query attention
    d_ff: int = 11008
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0
    compute_dtype: torch.dtype = torch.float32
    # The fused scaled causal attention for the teacher-forced (fine-tuning)
    # forward, taken when T % 128 == 0 as in the JAX package: no [B, H, T, T]
    # score or bias tensor. Prefill and decode steps are unaffected.
    flash_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def _shapes(cfg: CausalLMConfig) -> Dict[str, Tuple[int, int]]:
    hd = cfg.num_heads * cfg.head_dim
    return {
        "q": (cfg.d_model, hd), "k": (cfg.d_model, cfg.kv_dim), "v": (cfg.d_model, cfg.kv_dim),
        "o": (hd, cfg.d_model), "gate": (cfg.d_model, cfg.d_ff), "up": (cfg.d_model, cfg.d_ff),
        "down": (cfg.d_ff, cfg.d_model),
    }


def init_params(cfg: CausalLMConfig, generator: torch.Generator) -> Params:
    """Random float32 parameters on the generator's device (the JAX
    package's init scheme: dense ``N(0, 1/in)``, embedding ``N(0, 0.02^2)``;
    the draws differ), e.g. float32 masters made on the card for training."""
    g = generator
    dev = g.device

    def dense(i: int, o: int) -> torch.Tensor:
        return torch.randn((i, o), generator=g, device=dev) * (i ** -0.5)

    layers: Params = {name: torch.empty((cfg.num_layers, i, o), device=dev)
                      for name, (i, o) in _shapes(cfg).items()}
    for n in range(cfg.num_layers):
        for name, (i, o) in _shapes(cfg).items():
            layers[name][n] = dense(i, o)
    layers["input_norm"] = torch.ones((cfg.num_layers, cfg.d_model), device=dev)
    layers["post_norm"] = torch.ones((cfg.num_layers, cfg.d_model), device=dev)
    params: Params = {
        "embedding": torch.randn((cfg.vocab_size, cfg.d_model), generator=g, device=dev) * 0.02,
        "layers": layers,
        "final_norm": torch.ones(cfg.d_model, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(cfg.d_model, cfg.vocab_size)
    return params


def init_serving_params(
    cfg: CausalLMConfig, seed: int, device: Any, bits: Optional[int] = None
) -> Params:
    """Random serving parameters made on ``device`` one layer at a time:
    each weight is drawn in float32 there and either quantized (``bits`` 8
    or 4) or stored in ``cfg.compute_dtype``, so a full-width model never
    holds more than one float32 weight at once. The same ``seed`` gives the
    same float32 weights at every ``bits``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def dense(i: int, o: int) -> Any:
        w = torch.randn((i, o), generator=g, device=dev) * (i ** -0.5)
        return quantize_leaf(w, bits) if bits else w.to(cfg.compute_dtype)

    per_layer: Dict[str, list] = {name: [] for name in _MATMULS}
    for _ in range(cfg.num_layers):
        for name, (i, o) in _shapes(cfg).items():
            per_layer[name].append(dense(i, o))
    layers: Params = {
        name: stack_quantized(ws) if bits else torch.stack(ws) for name, ws in per_layer.items()
    }
    layers["input_norm"] = torch.ones((cfg.num_layers, cfg.d_model), device=dev)
    layers["post_norm"] = torch.ones((cfg.num_layers, cfg.d_model), device=dev)
    params: Params = {
        "embedding": (torch.randn((cfg.vocab_size, cfg.d_model), generator=g, device=dev)
                      * 0.02).to(cfg.compute_dtype),
        "layers": layers,
        "final_norm": torch.ones(cfg.d_model, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(cfg.d_model, cfg.vocab_size)
    return params


def place_params(params: Params, cfg: CausalLMConfig, device: Any) -> Params:
    """Move ``params`` to ``device``: matrix-product weights and the
    embedding in ``cfg.compute_dtype``, norms in float32, quantized weights
    as they are."""

    def place(tree: Any, name: str) -> Any:
        if isinstance(tree, dict):
            return {k: place(v, k) for k, v in tree.items()}
        if isinstance(tree, QuantWeight):
            return tree.to(device)
        dtype = torch.float32 if name.endswith("norm") else cfg.compute_dtype
        return tree.to(device=device, dtype=dtype).contiguous()

    return place(params, "")


# ------------------------------------------------------------------ #
# Building blocks
# ------------------------------------------------------------------ #


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def _dense(x: torch.Tensor, w: Any, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(w, QuantWeight):  # weight-only int8/int4 serving
        return quantized_dense(x, w, dtype)
    return torch.matmul(x.to(dtype), w.to(dtype))


def local_heads(lp: Params, cfg: CausalLMConfig) -> Tuple[int, int]:
    """(query heads, KV heads) of a layer's q/k weights or their
    tensor-parallel shards: their output widths over ``head_dim``."""
    return lp["q"].shape[-1] // cfg.head_dim, lp["k"].shape[-1] // cfg.head_dim


def _lm_logits(params: Params, cfg: CausalLMConfig, h: torch.Tensor, mesh: Any = None
               ) -> torch.Tensor:
    """Final vocabulary projection -> fp32 logits ``[..., V]`` (a
    vocabulary-split ``lm_head``'s columns gathered over ``model``)."""
    w = params["embedding"].t() if cfg.tie_word_embeddings else params["lm_head"]
    split = model_parallel(mesh) and w.shape[-1] != cfg.vocab_size
    if split:
        h = copy_to_model(h, mesh)
    if isinstance(w, QuantWeight):
        logits = quantized_logits(h, w, cfg.compute_dtype)
    else:
        dt = cfg.compute_dtype
        logits = torch.matmul(h.to(dt).float(), w.to(dt).float())
    return gather_from_model(logits, mesh) if split else logits


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
          head_axis: int = 1) -> torch.Tensor:
    """Rotary embedding, HF Llama convention (rotate_half): x ``[B, H, T,
    d]`` (``head_axis`` 1) or ``[B, T, H, d]`` (``head_axis`` 2, the flash
    path's layout: heads stay slices of the flat projection), positions
    ``[B, T]`` (or ``[T]``)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, :, None].float() * inv_freq  # [B, T, d/2]
    cos = torch.cat([torch.cos(angles)] * 2, dim=-1).unsqueeze(head_axis)
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1).unsqueeze(head_axis)
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x32 * cos + rotated * sin).to(x.dtype)


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, Hkv, T, d]`` -> ``[B, Hkv*groups, T, d]`` (GQA broadcast)."""
    return x if groups == 1 else x.repeat_interleave(groups, dim=1)


def _attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
    scale: float, dtype: torch.dtype,
) -> torch.Tensor:
    scores = torch.matmul(q.to(dtype), k.to(dtype).transpose(-1, -2)).float() * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs, v.to(dtype))


def _split(x: torch.Tensor, heads: int, d: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.view(b, t, heads, d).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _mlp(h: torch.Tensor, lp: Params, cfg: CausalLMConfig, mesh: Any = None) -> torch.Tensor:
    """SwiGLU: ``down(silu(gate(n)) * up(n))`` on the post-attention norm."""
    dt = cfg.compute_dtype
    n = copy_to_model(_rms_norm(h, lp["post_norm"], cfg.rms_norm_eps), mesh)
    gate = torch.nn.functional.silu(_dense(n, lp["gate"], dt).float()).to(dt)
    return reduce_from_model(_dense(gate * _dense(n, lp["up"], dt), lp["down"], dt), mesh)


def _block(
    h: torch.Tensor, lp: Params, cfg: CausalLMConfig, positions: torch.Tensor,
    bias: torch.Tensor, mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer over a full sequence -> (h, k, v); k and v ``[B, Hkv, T,
    d]`` after RoPE (the prompt's cache; this rank's KV heads)."""
    dt = cfg.compute_dtype
    hh, hkv = local_heads(lp, cfg)
    groups = hh // hkv
    n = copy_to_model(_rms_norm(h, lp["input_norm"], cfg.rms_norm_eps), mesh)
    q = _rope(_split(_dense(n, lp["q"], dt), hh, cfg.head_dim), positions, cfg.rope_theta)
    k = _rope(_split(_dense(n, lp["k"], dt), hkv, cfg.head_dim), positions, cfg.rope_theta)
    v = _split(_dense(n, lp["v"], dt), hkv, cfg.head_dim)
    attn = _attention(q, _repeat_kv(k, groups), _repeat_kv(v, groups), bias,
                      cfg.head_dim ** -0.5, dt)
    h = h + reduce_from_model(_dense(_merge(attn), lp["o"], dt), mesh)
    return h + _mlp(h, lp, cfg, mesh), k, v


def _flash_block(
    h: torch.Tensor, lp: Params, cfg: CausalLMConfig, positions: torch.Tensor,
    key_mask: torch.Tensor, mesh: Any = None,
) -> torch.Tensor:
    """One layer over a full sequence through the fused scaled causal
    attention (the JAX package's flash layer): RoPE in ``[B, T, H, d]``, the
    GQA K/V heads repeated to H, the flat ``[B, T, H*d]`` layout into the
    kernel."""
    dt = cfg.compute_dtype
    b, t, _ = h.shape
    (hh, hkv), dh = local_heads(lp, cfg), cfg.head_dim
    n = copy_to_model(_rms_norm(h, lp["input_norm"], cfg.rms_norm_eps), mesh)
    q = _rope(_dense(n, lp["q"], dt).view(b, t, hh, dh), positions, cfg.rope_theta, 2)
    k = _rope(_dense(n, lp["k"], dt).view(b, t, hkv, dh), positions, cfg.rope_theta, 2)
    v = _dense(n, lp["v"], dt).view(b, t, hkv, dh)
    groups = hh // hkv
    k, v = (x.repeat_interleave(groups, dim=2) if groups > 1 else x for x in (k, v))
    attn = scaled_causal_flash_attention(
        q.reshape(b, t, hh * dh), k.reshape(b, t, hh * dh), v.reshape(b, t, hh * dh), key_mask,
        hh, dh ** -0.5)
    h = h + reduce_from_model(_dense(attn, lp["o"], dt), mesh)
    return h + _mlp(h, lp, cfg, mesh)


def _prompt_bias(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions ``[B, T]`` from the mask cumsum, causal + key-mask bias
    ``[B, 1, T, T]`` fp32)."""
    t = mask.shape[1]
    positions = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
    ar = torch.arange(t, device=mask.device)
    causal = (ar[None, :] <= ar[:, None])[None, None]
    key_ok = mask[:, None, None, :].bool()
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return positions, torch.where(causal & key_ok, zero, NEG_INF)


# ------------------------------------------------------------------ #
# Full-sequence forward
# ------------------------------------------------------------------ #


def forward_logits(
    params: Params,
    cfg: CausalLMConfig,
    input_ids: torch.Tensor,  # [B, T]
    attention_mask: Optional[torch.Tensor] = None,  # [B, T]; None = all real
    mesh: Any = None,
) -> torch.Tensor:
    """Causal forward -> fp32 logits ``[B, T, vocab]``; left or right
    padding (positions come from the mask, padded keys are masked).
    ``cfg.flash_attention`` with ``T % 128 == 0`` takes the fused scaled
    causal attention (the JAX package's rule, kept so that one config
    computes the same way in both packages, though the port's kernels take
    any length); otherwise the plain ``[B, H, T, T]`` attention. A query row
    with no valid key (left padding) differs between the two paths, and
    reaches only its own logits."""
    if attention_mask is None:
        attention_mask = torch.ones_like(input_ids)
    t = input_ids.shape[1]
    h = params["embedding"].to(cfg.compute_dtype)[input_ids.long()]
    if cfg.flash_attention and t % 128 == 0:
        positions = (torch.cumsum(attention_mask.long(), dim=1) - 1).clamp_min(0)
        for i in range(cfg.num_layers):
            h = _flash_block(h, layer_params(params["layers"], i), cfg, positions,
                             attention_mask, mesh)
    else:
        positions, bias = _prompt_bias(attention_mask)
        for i in range(cfg.num_layers):
            h, _, _ = _block(h, layer_params(params["layers"], i), cfg, positions, bias, mesh)
    h = _rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return _lm_logits(params, cfg, h, mesh)


def causal_lm_loss(
    params: Params, cfg: CausalLMConfig, input_ids: torch.Tensor,
    attention_mask: torch.Tensor, labels: torch.Tensor, mesh: Any = None,
) -> torch.Tensor:
    """Next-token cross entropy with -100 ignored (the HF convention),
    summed and divided by max(valid targets, 1): the in-framework
    decoder-only fine-tuning loss on the ``[GOAL]/[PROOFSTEP]`` pairs
    (:mod:`~reprover_tpu_torch.generation.causal_datamodule`); over the
    gathered logits under a tensor-parallel ``mesh``."""
    logits = forward_logits(params, cfg, input_ids, attention_mask, mesh)[:, :-1]
    targets = labels[:, 1:].long()
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1), ignore_index=-100,
        reduction="sum")
    return nll / (targets != -100).sum().clamp_min(1)


# ------------------------------------------------------------------ #
# Incremental decoding (prefill + step) for beam search / serving
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class CausalDecodeState:
    """KV cache ``[L, B, Hkv, max_len, d]`` (written in place), which cache
    columns are real ``[B, max_len]``, the next write column ``step`` and
    each row's next RoPE position ``[B]``."""

    k: torch.Tensor
    v: torch.Tensor
    key_mask: torch.Tensor
    step: int
    position: torch.Tensor


def prefill(
    params: Params,
    cfg: CausalLMConfig,
    input_ids: torch.Tensor,  # [B, P] LEFT-padded prompts
    attention_mask: torch.Tensor,  # [B, P]
    max_decode_len: int,
    mesh: Any = None,
) -> Tuple[torch.Tensor, CausalDecodeState]:
    """Process the prompt -> (next-token fp32 logits ``[B, V]``, state with
    the prompt's K/V in columns ``[0, P)``; writes continue at ``P``; this
    rank's KV heads under tensor parallelism)."""
    dt = cfg.compute_dtype
    b, p = input_ids.shape
    positions, bias = _prompt_bias(attention_mask)
    h = params["embedding"].to(dt)[input_ids.long()]
    _, hkv = local_heads(params["layers"], cfg)
    shape = (cfg.num_layers, b, hkv, p + max_decode_len, cfg.head_dim)
    ks = torch.zeros(shape, dtype=dt, device=h.device)
    vs = torch.zeros(shape, dtype=dt, device=h.device)
    for i in range(cfg.num_layers):
        h, k, v = _block(h, layer_params(params["layers"], i), cfg, positions, bias, mesh)
        ks[i, :, :, :p] = k
        vs[i, :, :, :p] = v
    logits = _lm_logits(params, cfg, _rms_norm(h[:, -1], params["final_norm"], cfg.rms_norm_eps),
                        mesh)
    key_mask = torch.zeros((b, p + max_decode_len), dtype=torch.long, device=h.device)
    key_mask[:, :p] = attention_mask.long()
    return logits, CausalDecodeState(k=ks, v=vs, key_mask=key_mask, step=p,
                                     position=positions[:, -1] + 1)


def decode_step(
    params: Params, cfg: CausalLMConfig, state: CausalDecodeState, token: torch.Tensor,
    mesh: Any = None,
) -> Tuple[torch.Tensor, CausalDecodeState]:
    """One incremental step -> (fp32 logits ``[B, V]``, state). The cache is
    written in place; attention reads the ``step + 1`` filled columns (the
    JAX package's masked full-length read gives the same sums)."""
    dt = cfg.compute_dtype
    pos = state.step
    hh, hkv = local_heads(params["layers"], cfg)
    groups = hh // hkv
    h = params["embedding"].to(dt)[token.long()][:, None, :]
    rope_pos = state.position[:, None]
    state.key_mask[:, pos] = 1
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    bias = torch.where(state.key_mask[:, None, None, : pos + 1].bool(), zero, NEG_INF)
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        n = copy_to_model(_rms_norm(h, lp["input_norm"], cfg.rms_norm_eps), mesh)
        q = _rope(_split(_dense(n, lp["q"], dt), hh, cfg.head_dim), rope_pos, cfg.rope_theta)
        k = _rope(_split(_dense(n, lp["k"], dt), hkv, cfg.head_dim), rope_pos, cfg.rope_theta)
        v = _split(_dense(n, lp["v"], dt), hkv, cfg.head_dim)
        state.k[i, :, :, pos] = k[:, :, 0]
        state.v[i, :, :, pos] = v[:, :, 0]
        attn = _attention(q, _repeat_kv(state.k[i, :, :, : pos + 1], groups),
                          _repeat_kv(state.v[i, :, :, : pos + 1], groups), bias,
                          cfg.head_dim ** -0.5, dt)
        h = h + reduce_from_model(_dense(_merge(attn), lp["o"], dt), mesh)
        h = h + _mlp(h, lp, cfg, mesh)
    logits = _lm_logits(params, cfg, _rms_norm(h[:, 0], params["final_norm"], cfg.rms_norm_eps),
                        mesh)
    return logits, dataclasses.replace(state, step=pos + 1, position=state.position + 1)


def reorder_decode_state(state: CausalDecodeState, flat_parent: torch.Tensor) -> CausalDecodeState:
    """Row ``i`` follows row ``flat_parent[i]`` (the beam reorder of the
    classic path): the filled cache columns, the key mask and the RoPE
    position."""
    n = state.step
    state.k[:, :, :, :n] = state.k[:, flat_parent, :, :n]
    state.v[:, :, :, :n] = state.v[:, flat_parent, :, :n]
    return dataclasses.replace(state, key_mask=state.key_mask[flat_parent],
                               position=state.position[flat_parent])
