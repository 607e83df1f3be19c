"""Weight-only int8 (w8a16) and int4 (w4a16) matrix products: the
counterpart of :mod:`reprover_tpu.ops.quant_matmul` (kernels 11 and 12).

    w8a16:  y[M, N] = (x[M, K] @ q[K, N]) * scale[N]
    w4a16:  y[M, N] =  x[M, K] @ (unpack4(p[K/2, N]) * scale[K/G, N])

Storing weights in 8 or 4 bits only pays when the product reads them in 8 or
4 bits: converting a whole weight to bf16 first writes and reads a bf16 copy.
On a CUDA tensor :func:`quant_matmul` and :func:`quant4_matmul` launch the
hand-written kernels of ``csrc/quant_matmul.cu`` (one launch per product);
on a CPU tensor they run their plain versions (:func:`quant_matmul_reference`,
:func:`quant4_matmul_reference`). There is no fallback between the two. The
kernels take bf16 activations; the output is bf16 or fp32.

:func:`quant_plan` picks the kernel body and its tiling from the shapes:
``decode`` (M <= 64: 128 output channels per block as the tensor cores' M,
the activation rows as their N, K split so that about two blocks stream on
every SM), ``admission`` (M > 64: 256 x 128 output tiles) or, for operands a
TMA tensor map cannot describe, ``simple``. Split-K partial sums go to a
workspace the wrapper allocates; the last block of each output tile sums
them, elected through a per-tile counter that the wrapper zeroes once per
device and stream.

Rounding follows the JAX kernels: int8 is converted to the compute type,
the product accumulates in fp32 and the scale multiplies the fp32 result;
int4 values are dequantized in fp32 with their group's scale, rounded to the
compute type, then multiplied with fp32 accumulation. The decode body alone
multiplies the exact bf16 nibble by the scale rounded to bf16
(``csrc/quant_matmul.cu``, "Rounding").
"""

from __future__ import annotations

import ctypes
import functools
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

# Launches of each CUDA kernel in this process: each wrapper adds one where
# it launches and nowhere else; BODY_LAUNCHES splits them by body.
KERNEL_LAUNCHES: Dict[str, int] = {"quant_matmul": 0, "quant4_matmul": 0}
BODY_LAUNCHES: Dict[str, int] = {"tma": 0, "simple": 0}

# The kernels' tiles (csrc/quant_matmul.cu: KT, DEC_TN, ADM_TM, ADM_TN, BM/BN;
# the C entry refuses a plan whose ``out_tiles`` is not its grid's).
K_TILE = 64
DECODE_MAX_ROWS = 64
DECODE_TILE_N = 128
ADMIT_TILE_M, ADMIT_TILE_N = 256, 128
SIMPLE_TILE = 64
# Blocks per SM a split of K aims for when the output tiles alone are fewer.
BLOCKS_PER_SM = {"decode": 2, "admission": 1}
# The C entry's body codes.
BODY_CODES = {"simple": 0, "decode": 1, "admission": 2}

_sm_counts: Dict[int, int] = {}
# One zeroed int32 arrival counter per output tile, per (device, stream):
# the kernels leave them zero.
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    for counts in (KERNEL_LAUNCHES, BODY_LAUNCHES):
        for name in counts:
            counts[name] = 0


@dataclass(frozen=True)
class QuantPlan:
    """How one product runs: ``body`` "tma" (the Hopper bodies: ``regime``
    "decode" for M <= 64, else "admission") or "simple"; the output tile
    ``tile_m`` x ``tile_n``; K in ``splits`` ranges of ``tiles_per_split``
    64-deep tiles (the last may be shorter, none is empty); the fp32
    ``workspace_bytes`` of the split partial sums; ``out_tiles`` blocks per
    split (one arrival counter each)."""

    body: str
    regime: str
    tile_m: int
    tile_n: int
    splits: int
    tiles_per_split: int
    workspace_bytes: int
    out_tiles: int

    @property
    def code(self) -> int:
        return BODY_CODES["simple" if self.body == "simple" else self.regime]


def tma_shape_ok(bits: int, m: int, n: int, k: int, group: int) -> bool:
    """Whether TMA tensor maps describe the operands (given 16-byte aligned
    bases): x rows and weight rows multiples of 16 bytes, and for int4 a
    group that is a multiple of 16 and divides 64 or is a multiple of it."""
    if m < 1 or k < 1 or n < 1 or k % 8 or n % 16:
        return False
    return bits == 8 or (group % 16 == 0 and (K_TILE % group == 0 or group % K_TILE == 0))


@functools.lru_cache(maxsize=4096)
def quant_plan(bits: int, m: int, n: int, k: int, group: int, sm_count: int,
               aligned: bool = True) -> QuantPlan:
    """The body and tiling of one ``[m, k] x [k, n]`` product on a card with
    ``sm_count`` SMs; ``aligned``: x, the weight and the scales start on
    16-byte boundaries. The tensor-core bodies split K when their output
    tiles are fewer than ``BLOCKS_PER_SM`` per SM; the simple body never
    does."""
    k_tiles = max(1, -(-k // K_TILE))
    if not (aligned and tma_shape_ok(bits, m, n, k, group)):
        tiles = -(-m // SIMPLE_TILE) * -(-n // SIMPLE_TILE)
        return QuantPlan("simple", "decode" if m <= DECODE_MAX_ROWS else "admission",
                         SIMPLE_TILE, SIMPLE_TILE, 1, k_tiles, 0, tiles)
    if m <= DECODE_MAX_ROWS:
        regime, tile_m, tile_n = "decode", (32 if m <= 32 else 64), DECODE_TILE_N
        tiles = -(-n // tile_n)
    else:
        regime, tile_m, tile_n = "admission", ADMIT_TILE_M, ADMIT_TILE_N
        tiles = -(-m // tile_m) * -(-n // tile_n)
    target = BLOCKS_PER_SM[regime] * sm_count
    splits = 1 if tiles >= target else min(k_tiles, -(-target // tiles))
    per = -(-k_tiles // splits)
    splits = -(-k_tiles // per)
    workspace = 4 * splits * m * n if splits > 1 else 0
    return QuantPlan("tma", regime, tile_m, tile_n, splits, per, workspace, tiles)


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def plan_for(bits: int, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
             group: int) -> QuantPlan:
    """:func:`quant_plan` of the kernel call on these card tensors."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, scale))
    return quant_plan(bits, x.shape[0], w.shape[1], x.shape[1], group, _sm_count(x.device),
                      aligned)


# A quantized-product kernel's profiled or mangled name: the Hopper bodies
# (quant_decode_kernel<bits, rows>, quant_admission_kernel<bits>) and the
# simple one (quant_matmul_kernel<int4>).
_TMA_KERNEL = re.compile(
    r"quant_(decode|admission)_kernel(?:<(\d+)(?:,\s*(\d+))?>|ILi(\d+)E(?:Li(\d+)E)?E)")
_SIMPLE_KERNEL = re.compile(r"quant_matmul_kernel(?:<(true|false)>|ILb([01])E)")


def kernel_instance(kernel_name: str) -> Optional[Tuple[str, int, int]]:
    """``(body, bits, tile rows)`` of a quantized-product kernel's name
    (body "decode", "admission" or "simple"), or None for another kernel."""
    m = _TMA_KERNEL.search(kernel_name)
    if m is not None:
        body, b1, r1, b2, r2 = m.groups()
        bits, rows = int(b1 or b2), r1 or r2
        return body, bits, int(rows) if rows else ADMIT_TILE_M
    m = _SIMPLE_KERNEL.search(kernel_name)
    if m is not None:
        int4 = m.group(1) == "true" or m.group(2) == "1"
        return "simple", 4 if int4 else 8, SIMPLE_TILE
    return None


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


def _counter_buffer(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """At least ``tiles`` zeroed int32 arrival counters for ``stream`` on
    ``device``, made once and kept (the kernels leave them zero)."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


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
    plan = plan_for(bits, x, w, scale, group)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    work = counters = None
    if plan.splits > 1:
        work = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=x.device)
        counters = _counter_buffer(x.device, stream, plan.out_tiles)
    err = lib.quant_matmul_launch(
        bits, _ptr(x), _ptr(w), _ptr(scale), _ptr(out), _ptr(work), _ptr(counters), m, n, k,
        group, plan.code, plan.tile_m, plan.splits, plan.tiles_per_split, plan.out_tiles,
        plan.workspace_bytes, int(out_dtype == torch.float32), ctypes.c_void_p(stream),
    )
    _raise_on_error(lib, err, name)
    KERNEL_LAUNCHES[name] += 1
    BODY_LAUNCHES[plan.body] += 1
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
