"""Weight-only int8 / int4 quantization for serving: the counterpart of
:mod:`reprover_tpu.models.quantize`.

Beam-search decode is weight-read bound: every token step streams all
decoder weights while the batch (beams) is small. Matrix-product weights
become :class:`QuantWeight` (int8, per-output-channel scale) or
:class:`Quant4Weight` (packed int4, per-(K-group, channel) scales); the
models' ``_dense`` and ``_lm_logits`` consume either. Quantizing the same
weight gives the JAX package's bytes exactly (same rounding, same
``_group_for``), so one tree serves both packages through the bridge.

Routing (:func:`quantized_dense`): a 2-D weight of at least 16 Mi
parameters whose activation stays under 32 MiB goes to the hand-written
kernels of :mod:`reprover_tpu_torch.ops.quant_matmul` when the activation is
a bf16 tensor on the card (the JAX package's "the backend is a TPU"); every
other product dequantizes and multiplies in plain PyTorch, as the JAX
package leaves it to XLA. The thresholds are the JAX package's, kept for
parity. At byt5-small size nothing routes; at LLaMA-7B every projection and
the lm_head do in decode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from reprover_tpu_torch.ops.quant_matmul import (
    _block_k4,
    dequantize4_weight,
    quant4_matmul,
    quant_matmul,
)


@dataclasses.dataclass(frozen=True)
class QuantWeight:
    """int8 weight ``[..., I, O]`` + fp32 per-output-channel scale ``[..., 1, O]``.

    ``kernel_ok`` gates the kernel routing (the JAX package clears it for
    weights sharded over a mesh; the port keeps it, and each rank runs the
    kernels on its shard). ``logical_shape`` is a tensor-parallel shard's
    whole per-layer weight ``[K, N]`` (None: the weight is whole), which the
    routing reads. Indexing and ``unbind`` slice the stacked layer axis, so
    the models' per-layer views work on quantized trees."""

    q: torch.Tensor
    scale: torch.Tensor
    kernel_ok: bool = True
    logical_shape: Optional[Tuple[int, int]] = None

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def __getitem__(self, index: Any) -> "QuantWeight":
        return dataclasses.replace(self, q=self.q[index], scale=self.scale[index])

    def unbind(self, dim: int = 0) -> List["QuantWeight"]:
        """The layers of a stacked weight (the leading axis only)."""
        if dim != 0:
            raise ValueError(f"quantized weights unbind the stacked layer axis (0), not {dim}")
        return [self[i] for i in range(self.q.shape[0])]

    def to(self, device: Any) -> "QuantWeight":
        """The weight on ``device`` (the stored types are kept)."""
        return dataclasses.replace(
            self, q=self.q.to(device).contiguous(), scale=self.scale.to(device).contiguous())

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4


@dataclasses.dataclass(frozen=True)
class Quant4Weight(QuantWeight):
    """Packed int4 weight + per-K-group scales (w4a16 serving).

    ``q``: uint8 ``[..., K/2, O]``, two 4-bit two's-complement values per
    byte along the contraction axis (low nibble = even row). ``scale``: fp32
    ``[..., K/group, O]``, applied before the product."""

    group: int = 128


def resolve_quantize_bits(quantize: "bool | str") -> int:
    """``True`` / ``"int8"`` -> 8, ``"int4"`` -> 4; anything else raises
    (``"INT4"``, ``"w4a16"`` and other typos do not silently serve int8)."""
    if quantize is True or quantize == "int8":
        return 8
    if quantize == "int4":
        return 4
    raise ValueError(f"quantize must be one of True, 'int8', 'int4'; got {quantize!r}")


def _group_for(k: int, group: int) -> int:
    """Largest group size <= the requested one that divides K (halving).

    For K > 2048 the JAX package's w4a16 kernel blocks the contraction axis
    and its scale tile needs ``(K-block / group) % 8 == 0`` (the TPU's
    sublane rule), so the group must also satisfy ``K % (8*group) == 0``.
    Kept here so the packed bytes and scales are the JAX package's."""
    g = min(group, k)
    if k > 2048:
        while g > 1 and k % (8 * g):
            g //= 2
    else:
        while g > 1 and k % g:
            g //= 2
    return max(g, 1)


def quantize_weight(w: torch.Tensor, kernel_ok: bool = True) -> QuantWeight:
    """Per-output-channel symmetric int8 (output = last axis; leading axes,
    e.g. the stacked-layer axis, quantize independently)."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)  # [..., 1, O]
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantWeight(q=q, scale=scale, kernel_ok=kernel_ok)


def quantize_weight4(w: torch.Tensor, group: int = 128, kernel_ok: bool = True) -> Quant4Weight:
    """Symmetric int4 with per-(K-group, output-channel) scales; packs two
    values per byte along K."""
    w32 = w.float()
    *lead, k, o = w32.shape
    if k % 2:
        raise ValueError(f"odd contraction dim {k} cannot pack int4 pairs")
    g = _group_for(k, group)
    grp = w32.reshape(*lead, k // g, g, o)
    absmax = grp.abs().amax(dim=-2, keepdim=True)  # [..., K/g, 1, O]
    scale = absmax.clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(grp / scale), -7, 7).to(torch.int32).reshape(*lead, k, o)
    pairs = q.reshape(*lead, k // 2, 2, o)
    low, high = pairs[..., 0, :], pairs[..., 1, :]
    packed = ((low & 15) | ((high & 15) << 4)).to(torch.uint8)
    return Quant4Weight(q=packed, scale=scale[..., 0, :].contiguous(), kernel_ok=kernel_ok, group=g)


def dequantize4(w: Quant4Weight, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[..., K, O]`` reconstruction in ``dtype``."""
    return dequantize4_weight(w.q, w.scale, w.group, dtype)


# Kernel-routing thresholds (the JAX package's, ``quantize.py:177-186``):
# weights of at least 16 Mi parameters, activations of at most 32 MiB.
_KERNEL_MIN_WEIGHT_BYTES = 16 * 2 ** 20
_KERNEL_MAX_X_BYTES = 32 * 2 ** 20

#: Override for the kernel routing: ``None`` routes bf16 activations on the
#: card only; ``True``/``False`` force it (tests).
FORCE_KERNEL: Optional[bool] = None


def _rows(x: torch.Tensor) -> int:
    m = 1
    for s in x.shape[:-1]:
        m *= int(s)
    return m


def _routes(rows: int, w: QuantWeight, dtype: torch.dtype, on_card: bool) -> bool:
    """The JAX package's routing rule (``quantize.py:195-258``) for an
    activation of ``rows`` rows; ``on_card`` takes the place of "the backend
    is a TPU": a bf16 activation on a CUDA card. A tensor-parallel shard is
    judged by its whole weight (``logical_shape``), so it routes as one card
    routes that weight; the kernel then runs on the shard."""
    if not w.kernel_ok or w.q.dim() != 2:
        return False
    int4 = isinstance(w, Quant4Weight)
    if w.logical_shape is not None:
        k_in, n = w.logical_shape
    else:
        k_in, n = w.q.shape
        if int4:
            k_in *= 2
    itemsize = torch.finfo(dtype).bits // 8
    if not (k_in * n >= _KERNEL_MIN_WEIGHT_BYTES and rows * k_in * itemsize <= _KERNEL_MAX_X_BYTES):
        return False
    # The JAX int4 kernel has no legal contraction block here: plain path.
    if int4 and k_in > 2048 and _block_k4(k_in, w.group) > 2048:
        return False
    if FORCE_KERNEL is not None:
        return FORCE_KERNEL
    return on_card and dtype == torch.bfloat16


def _use_kernel(x: torch.Tensor, w: QuantWeight, dtype: torch.dtype) -> bool:
    return _routes(_rows(x), w, dtype, x.is_cuda)


def _flat(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.reshape(_rows(x), x.shape[-1]).to(dtype).contiguous()


def _quant4_apply(
    x: torch.Tensor, w: Quant4Weight, dtype: torch.dtype, out_dtype: torch.dtype
) -> torch.Tensor:
    if _use_kernel(x, w, dtype):
        y = quant4_matmul(_flat(x, dtype), w.q, w.scale, group=w.group, out_dtype=out_dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if out_dtype == dtype:  # the product accumulates in fp32 and rounds once
        return torch.matmul(x.to(dtype), dequantize4(w, dtype))
    return torch.matmul(x.to(dtype).float(), dequantize4(w, dtype).float()).to(out_dtype)


def quantized_dense(x: torch.Tensor, w: QuantWeight, dtype: torch.dtype) -> torch.Tensor:
    """``(x @ q) * scale`` (int8) or ``x @ dequant4`` (int4) in ``dtype``,
    fp32 accumulation: through the kernel when :func:`_use_kernel` routes
    it, else in plain PyTorch."""
    if isinstance(w, Quant4Weight):
        return _quant4_apply(x, w, dtype, out_dtype=dtype)
    if _use_kernel(x, w, dtype):
        y = quant_matmul(_flat(x, dtype), w.q, w.scale.reshape(-1), out_dtype=dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    y = torch.matmul(x.to(dtype).float(), w.q.to(dtype).float())
    return (y * w.scale[..., 0, :].float()).to(dtype)


def quantized_logits(x: torch.Tensor, w: QuantWeight, dtype: torch.dtype) -> torch.Tensor:
    """Vocabulary projection variant of :func:`quantized_dense`: fp32
    logits; the same routing."""
    if isinstance(w, Quant4Weight):
        return _quant4_apply(x, w, dtype, out_dtype=torch.float32)
    if _use_kernel(x, w, dtype):
        y = quant_matmul(_flat(x, dtype), w.q, w.scale.reshape(-1), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    y = torch.matmul(x.to(dtype).float(), w.q.to(dtype).float())
    return y * w.scale[..., 0, :].float()


_T5_MATMUL_KEYS = frozenset({"q", "k", "v", "o", "wi_0", "wi_1", "wi", "wo", "lm_head"})
_CAUSAL_MATMUL_KEYS = frozenset({"q", "k", "v", "o", "gate", "up", "down", "lm_head"})


def quantize_leaf(w: torch.Tensor, bits: int, kernel_ok: bool = True) -> QuantWeight:
    """One weight at ``bits`` (8 or 4)."""
    if bits == 4:
        return quantize_weight4(w, kernel_ok=kernel_ok)
    if bits == 8:
        return quantize_weight(w, kernel_ok=kernel_ok)
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def _quantize_tree(params: Any, keys: frozenset, kernel_ok: bool, bits: int) -> Any:
    def rec(node: Any, key: Optional[str] = None) -> Any:
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if isinstance(node, QuantWeight):  # idempotent
            return node
        if key in keys and isinstance(node, torch.Tensor) and node.dim() >= 2:
            return quantize_leaf(node, bits, kernel_ok)
        return node

    return rec(params)


def quantize_t5_params(params: Any, kernel_ok: bool = True, bits: int = 8) -> Any:
    """Quantize every T5 matmul weight (attention, MLP, lm_head); norms,
    embeddings and relative-position biases stay in full precision."""
    return _quantize_tree(params, _T5_MATMUL_KEYS, kernel_ok, bits)


def quantize_causal_params(params: Any, kernel_ok: bool = True, bits: int = 8) -> Any:
    """Quantize every LLaMA-family matmul weight (q/k/v/o, gate/up/down,
    lm_head); the embedding and the RMSNorm scales stay in full precision."""
    return _quantize_tree(params, _CAUSAL_MATMUL_KEYS, kernel_ok, bits)


def stack_quantized(items: List[QuantWeight]) -> QuantWeight:
    """Stack per-layer quantized weights on a new leading layer axis."""
    first = items[0]
    return dataclasses.replace(
        first, q=torch.stack([w.q for w in items]), scale=torch.stack([w.scale for w in items]))


def weight_bytes(params: Any) -> int:
    """Bytes of every leaf of a parameter tree (quantized leaves count their
    packed weight and scales)."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    if isinstance(params, QuantWeight):
        return params.nbytes
    return params.numel() * params.element_size()


def routing_report(params: Any, rows: int, dtype: torch.dtype, device: torch.device) -> dict:
    """Where each quantized weight of a tree goes for an activation of
    ``rows`` rows: ``{path: "quant_matmul" | "quant4_matmul" | "plain"}``
    (a stacked weight is judged by one layer's slice, as the model uses it)."""
    out: dict = {}

    def rec(node: Any, path: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{path}/{k}" if path else k)
        elif isinstance(node, QuantWeight):
            w = node if node.q.dim() == 2 else node[0]
            kernel = "quant4_matmul" if isinstance(w, Quant4Weight) else "quant_matmul"
            out[path] = kernel if _routes(rows, w, dtype, device.type == "cuda") else "plain"

    rec(params, "")
    return out
