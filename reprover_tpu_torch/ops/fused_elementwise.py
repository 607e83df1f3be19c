"""The T5 block's elementwise chains as two fused kernels
(``csrc/fused_elementwise.cu``): the residual add with the RMSNorm after it,
and the gated-GELU product.

No Pallas kernel of the JAX package corresponds: XLA fuses these chains on
the TPU, where eager PyTorch runs each operation as a pass over device
memory. :func:`add_rms_norm` and :func:`gated_gelu` launch the kernels on a
CUDA tensor and run their plain versions (:func:`add_rms_norm_reference`,
:func:`gated_gelu_reference`) on a CPU tensor; there is no fallback
between the two. Both compute in float32 and round to bfloat16 once.

The model takes them only where :func:`plain_reason` finds nothing against
it (:func:`reprover_tpu_torch.models.t5._fuses`): on a card, in bf16, with
rows of whole 16-byte vectors, and with autograd recording for none of the
operands. Everywhere else, training and every CPU run among them, the
model runs its plain composition op for op.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# Launches of the CUDA kernels in this process: the wrappers add one where
# they launch and nowhere else.
KERNEL_LAUNCHES: Dict[str, int] = {"add_rms_norm": 0, "gated_gelu": 0}


def reset_launch_counts() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


#: The widest row the norm kernel holds in registers (``csrc``: 16 vectors
#: of 8 elements a lane).
MAX_NORM_WIDTH = 4096

GELU_C = 0.7978845608028654  # sqrt(2 / pi), as t5.gelu_new has it


def add_rms_norm_reference(h: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                           eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: ``h + delta`` in ``h``'s dtype, then T5's RMSNorm of
    it with float32 statistics, rounded once."""
    if delta is not None:
        h = h + delta
    x = h.float()
    normed = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * weight.float()
    return h, normed.to(h.dtype)


def gated_gelu_reference(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The plain version: tanh-approximated GELU of ``gate`` times ``up``, in
    float32, rounded once to ``gate``'s dtype."""
    x = gate.float()
    g = 0.5 * x * (1.0 + torch.tanh(GELU_C * (x + 0.044715 * torch.pow(x, 3.0))))
    return (g * up.float()).to(gate.dtype)


def _rows(x: torch.Tensor) -> Optional[Tuple[int, int]]:
    """``(rows, row stride)`` of ``x`` seen as ``[rows, x.shape[-1]]`` rows of
    one stride with a contiguous last dimension, or None where it is not."""
    if x.dim() == 0:
        return None
    width = x.shape[-1]
    if x.is_contiguous():
        return (x.numel() // width if width else 0), width
    if x.stride(-1) != 1:
        return None
    rows, row_stride, span = 1, width, None
    for size, stride in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if span is None:
            row_stride = stride
        elif stride != span:
            return None
        span = stride * size
        rows *= size
    return rows, row_stride


def _layout(x: torch.Tensor) -> Optional[Tuple[int, int]]:
    """:func:`_rows` where the rows are whole 16-byte vectors from a 16-byte
    aligned start, else None."""
    lay = _rows(x)
    if lay is None or x.shape[-1] % 8 or lay[1] % 8 or x.data_ptr() % 16:
        return None
    return lay


def plain_reason(activations: Sequence[torch.Tensor], weights: Sequence[torch.Tensor] = ()
                 ) -> str:
    """Why these operands do not go to the kernels, or ``""`` where they do:
    ``"autograd"`` where grad is on and any of them requires it,
    ``"dtype"`` unless the activations are bf16 and the weights (a norm's)
    float32, ``"shape"`` unless the activations share one shape,
    ``"layout"`` unless every activation is rows of one stride with a
    contiguous last dimension of whole 16-byte vectors from a 16-byte
    aligned start and every weight is such a row of the same width (at most
    :data:`MAX_NORM_WIDTH`), ``"device"`` unless all lie on one CUDA device.
    The model's choice (:func:`reprover_tpu_torch.models.t5._fuses`) and the
    wrappers' checks (:func:`_check`) both read it."""
    tensors = (*activations, *weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "autograd"
    if (any(x.dtype != torch.bfloat16 for x in activations)
            or any(w.dtype != torch.float32 for w in weights)):
        return "dtype"
    width = activations[0].shape[-1]
    if any(x.shape != activations[0].shape for x in activations):
        return "shape"
    if (any(_layout(x) is None for x in activations) or (weights and width > MAX_NORM_WIDTH)
            or not all(w.shape[-1] == width and w.stride(-1) == 1 and w.data_ptr() % 16 == 0
                       for w in weights)):
        return "layout"
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        return "device"
    return ""


def _check(name: str, activations: Sequence[torch.Tensor], weight: Optional[torch.Tensor] = None
           ) -> List[Tuple[int, int]]:
    """Raise on what :func:`plain_reason` refuses, but operands all on the
    CPU (the plain versions serve them), or on a norm's weight that is not
    ``[D]``; the activations' ``(rows, row stride)``."""
    weights = () if weight is None else (weight,)
    reason = plain_reason(activations, weights)
    tensors = (*activations, *weights)
    if reason == "device" and all(t.device.type == "cpu" for t in tensors):
        reason = ""
    if not reason and weight is not None and weight.dim() != 1:
        reason = "shape"
    if reason:
        raise ValueError(f"{name}: operands the kernel does not take ({reason}): " + "; ".join(
            f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}" for t in tensors))
    return [_layout(x) for x in activations]


def add_rms_norm(h: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h_new, normed)``: ``h_new = h + delta`` (``h`` itself where
    ``delta`` is None), bit-equal to the bf16 add, and ``normed`` its T5
    RMSNorm with ``weight`` (float32 ``[D]``) and float32 statistics, rounded
    once; both contiguous bf16 of ``h``'s shape (``h_new`` is ``h`` where
    ``delta`` is None). One kernel on a card, the plain version on the CPU."""
    lays = _check("add_rms_norm", (h,) if delta is None else (h, delta), weight)
    if h.device.type == "cpu":
        return add_rms_norm_reference(h, delta, weight, eps)
    rows, cols = lays[0][0], h.shape[-1]
    normed = torch.empty(h.shape, dtype=h.dtype, device=h.device)
    if delta is None:
        h_new, d_ptr, d_stride = h, None, 0
    else:
        h_new = torch.empty(h.shape, dtype=h.dtype, device=h.device)
        d_ptr, d_stride = delta.data_ptr(), lays[1][1]
    err = _entry("fused_add_rms_norm")(
        h.data_ptr(), lays[0][1], d_ptr, d_stride, weight.data_ptr(),
        h_new.data_ptr() if delta is not None else None, normed.data_ptr(), rows, cols,
        float(eps), torch._C._cuda_getCurrentRawStream(h.get_device()))
    _raise_on_error(err, "add_rms_norm")
    KERNEL_LAUNCHES["add_rms_norm"] += 1
    return h_new, normed


def gated_gelu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(gate) * up`` in float32, rounded once to bf16: contiguous
    bf16 of ``gate``'s shape. ``gate`` and ``up`` may be row-strided views,
    such as the two halves of the fused ``wi`` product. One kernel on a
    card, the plain version on the CPU."""
    lays = _check("gated_gelu", (gate, up))
    if gate.device.type == "cpu":
        return gated_gelu_reference(gate, up)
    out = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    err = _entry("fused_gated_gelu")(
        gate.data_ptr(), lays[0][1], up.data_ptr(), lays[1][1], out.data_ptr(), lays[0][0],
        gate.shape[-1], torch._C._cuda_getCurrentRawStream(gate.get_device()))
    _raise_on_error(err, "gated_gelu")
    KERNEL_LAUNCHES["gated_gelu"] += 1
    return out


def _raise_on_error(err: int, name: str) -> None:
    if err:
        from reprover_tpu_torch.ops.flash_attention import _raise_on_error as raise_on_error
        from reprover_tpu_torch.ops.native import load_library

        raise_on_error(load_library(), err, name)


_ENTRIES: Dict[str, Callable[..., int]] = {}


def _entry(name: str) -> Callable[..., int]:
    """The library's C function ``name``, built and loaded at first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from reprover_tpu_torch.ops.native import load_library

        fn = _ENTRIES[name] = getattr(load_library(), name)
    return fn
