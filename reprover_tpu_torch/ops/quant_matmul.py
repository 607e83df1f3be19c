"""Weight-only int8 (w8a16) and int4 (w4a16) matrix products: the
counterpart of :mod:`reprover_tpu.ops.quant_matmul` (kernels 11 and 12).

    w8a16:  y[M, N] = (x[M, K] @ q[K, N]) * scale[N]
    w4a16:  y[M, N] =  x[M, K] @ (unpack4(p[K/2, N]) * scale[K/G, N])

Storing weights in 8 or 4 bits only pays when the product reads them in 8 or
4 bits: converting a whole weight to bf16 first writes and reads a bf16 copy.
On a CUDA tensor :func:`quant_matmul` and :func:`quant4_matmul` launch the
hand-written kernels of ``csrc/quant_matmul.cu``, which convert each weight
tile in shared memory on its way to the tensor cores; on a CPU tensor they
run their plain versions (:func:`quant_matmul_reference`,
:func:`quant4_matmul_reference`). There is no fallback between the two. The
kernels take bf16 activations; the output is bf16 or fp32.

Rounding follows the JAX kernels: int8 is converted to the compute type,
the product accumulates in fp32 and the scale multiplies the fp32 result;
int4 values are dequantized in fp32 with their group's scale, rounded to the
compute type, then multiplied with fp32 accumulation.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

# Launches of each CUDA kernel in this process: each wrapper adds one where
# it launches and nowhere else.
KERNEL_LAUNCHES: Dict[str, int] = {"quant_matmul": 0, "quant4_matmul": 0}

# Output tiles of the kernel, and how many blocks per SM a split of K aims
# for when the output alone has too few tiles to fill the card (decode).
_TILE = 64
_BLOCKS_PER_SM = 4

_sm_counts: Dict[int, int] = {}


def reset_launch_counts() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """``[..., K/2, N]`` uint8 -> ``[..., K, N]`` int32 in [-8, 7].

    Row ``2i`` of the logical weight lives in the LOW nibble of packed row
    ``i``, row ``2i+1`` in the HIGH nibble; ``(v ^ 8) - 8`` sign-extends a
    4-bit two's-complement nibble (the JAX package's order)."""
    p = packed.to(torch.int32)
    low = ((p & 15) ^ 8) - 8
    high = ((p >> 4) ^ 8) - 8
    stacked = torch.stack([low, high], dim=-2)  # [..., K/2, 2, N]
    return stacked.reshape(*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])


def _block_k4(k: int, group: int) -> int:
    """The JAX kernel's contraction block (``quant_matmul.py:167``), kept for
    the routing rule: the CUDA kernel itself walks K in 64-deep tiles."""
    if k <= 2048:
        return k
    for cand in (2048, 1536, 1024, 512, 256):
        if k % cand == 0 and cand % (8 * group) == 0:
            return cand
    return k


def quant_matmul_reference(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain w8a16: ``q`` in the compute type, an fp32 product (exact
    products of the rounded operands), times ``scale``, cast."""
    out_dtype = out_dtype or x.dtype
    w = q.to(x.dtype).float()
    y = torch.matmul(x.float(), w)
    return (y * scale.reshape(-1).float()).to(out_dtype)


def dequantize4_weight(
    packed: torch.Tensor, scale: torch.Tensor, group: int, dtype: torch.dtype
) -> torch.Tensor:
    """``[..., K, N]`` in ``dtype``: nibbles times their group's scale in
    fp32, rounded once."""
    w_int = unpack_int4(packed)
    *lead, k, n = w_int.shape
    s_full = scale[..., :, None, :].expand(*lead, k // group, group, n).reshape(*lead, k, n)
    return (w_int.float() * s_full.float()).to(dtype)


def quant4_matmul_reference(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, group: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain w4a16: dequantize to the compute type, fp32 product, cast."""
    out_dtype = out_dtype or x.dtype
    w = dequantize4_weight(packed, scale, group, x.dtype).float()
    return torch.matmul(x.float(), w).to(out_dtype)


def _splits(device: torch.device, m: int, n: int, k: int) -> int:
    """K splits per output tile: enough blocks for ``_BLOCKS_PER_SM`` per SM
    when the output tiles alone are fewer (decode), else one."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    target = _BLOCKS_PER_SM * _sm_counts[index]
    tiles = -(-m // _TILE) * -(-n // _TILE)
    k_tiles = max(1, -(-k // _TILE))
    if tiles >= target:
        return 1
    return max(1, min(k_tiles, -(-target // tiles)))


def _launch(
    bits: int, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, group: int,
    out_dtype: torch.dtype, name: str,
) -> torch.Tensor:
    from reprover_tpu_torch.ops.flash_attention import _ptr, _raise_on_error
    from reprover_tpu_torch.ops.native import load_library

    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bf16 activations, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype must be bfloat16 or float32, got {out_dtype}")
    for arg, t in (("x", x), ("weight", w), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if scale.dtype != torch.float32:
        raise ValueError(f"{name}: scale must be float32, got {scale.dtype}")
    m, k = x.shape
    n = w.shape[1]
    lib = load_library()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    splits = _splits(x.device, m, n, k)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.quant_matmul_launch(
        bits, _ptr(x), _ptr(w), _ptr(scale), _ptr(out), _ptr(work), m, n, k, group, splits,
        int(out_dtype == torch.float32), ctypes.c_void_p(stream),
    )
    _raise_on_error(lib, err, name)
    KERNEL_LAUNCHES[name] += 1
    return out


def quant_matmul(
    x: torch.Tensor,  # [M, K] bf16 (fp32 on the CPU)
    q: torch.Tensor,  # [K, N] int8
    scale: torch.Tensor,  # [N] fp32 (per output channel)
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``(x @ q) * scale``: the w8a16 kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} and q {tuple(q.shape)} do not chain")
    if q.dtype != torch.int8 or scale.numel() != q.shape[1]:
        raise ValueError(f"quant_matmul: q must be int8 [K, N] and scale [N], got {q.dtype}, "
                         f"{tuple(scale.shape)}")
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, scale, out_dtype)
    return _launch(8, x, q, scale.reshape(-1), 2, out_dtype, "quant_matmul")


def quant4_matmul(
    x: torch.Tensor,  # [M, K] bf16 (fp32 on the CPU)
    packed: torch.Tensor,  # [K/2, N] uint8, two int4 per byte along K
    scale: torch.Tensor,  # [K/group, N] fp32
    group: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x @ dequant4(packed, scale)``: the w4a16 kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or packed.dim() != 2 or x.shape[1] != 2 * packed.shape[0]:
        raise ValueError(f"quant4_matmul: x {tuple(x.shape)} and packed {tuple(packed.shape)} "
                         "do not chain")
    k, n = x.shape[1], packed.shape[1]
    if packed.dtype != torch.uint8 or group < 1 or k % group or tuple(scale.shape) != (
            k // group, n):
        raise ValueError(f"quant4_matmul: packed must be uint8 [K/2, N] and scale "
                         f"[K/group, N], got {packed.dtype}, {tuple(scale.shape)}, group {group}")
    if x.device.type == "cpu":
        return quant4_matmul_reference(x, packed, scale, group, out_dtype)
    if group % 2:
        raise ValueError(f"quant4_matmul: the kernel takes even groups, got {group}")
    return _launch(4, x, packed, scale, group, out_dtype, "quant4_matmul")
