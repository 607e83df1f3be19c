"""Per-beam KV-cache reorder with the fresh-column append: the counterpart of
:mod:`reprover_tpu.ops.beam_reorder` (kernel 13).

The engines' beam advance permutes the per-beam decode caches
``[L, S, K, H, T, d]`` by the continuation parents and installs the step's
fresh (lazily appended) column at each slot's position (the vLLM beam-fork
role). :func:`reorder_append_gather` does both caches in one pass: on a CUDA
tensor through the hand-written kernel of ``csrc/beam_reorder.cu``, on a CPU
tensor through :func:`reorder_append_gather_reference`. There is no fallback
between the two.

Unlike the JAX function, which returns new arrays, the output goes into
buffers the caller owns (a permutation cannot be done in place, so the
engine keeps a second cache buffer and swaps the two every step). The caches
and outputs may be the ``T_live`` prefix of larger buffers (the step
bucket): only that prefix is read and written.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

# Launches of the CUDA kernel in this process: the wrapper adds one where it
# launches and nowhere else.
KERNEL_LAUNCHES: Dict[str, int] = {"beam_reorder": 0}


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES["beam_reorder"] = 0


def parent_effective(cont_parent: torch.Tensor, frozen: torch.Tensor) -> torch.Tensor:
    """``[S, K]`` parents with a frozen slot's beams kept in place."""
    k = cont_parent.shape[1]
    ident = torch.arange(k, device=cont_parent.device)[None, :].expand_as(cont_parent)
    return torch.where(frozen[:, None].bool(), ident, cont_parent.long())


def reorder_append_gather_reference(
    k_cache: torch.Tensor,  # [L, S, K, H, T, d]
    v_cache: torch.Tensor,
    k_col: torch.Tensor,  # [L, S, K, H, 1, d]
    v_col: torch.Tensor,
    cont_parent: torch.Tensor,  # [S, K]
    frozen: torch.Tensor,  # [S] bool
    pos: torch.Tensor,  # [S]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: gather each new beam's parent rows, then put the
    parent's fresh column at ``pos[s]`` (no column when ``pos[s] >= T``)."""
    _, s, _, _, t, _ = k_cache.shape
    parent = parent_effective(cont_parent, frozen)
    slot = torch.arange(s, device=k_cache.device)[:, None]
    at_pos = (torch.arange(t, device=k_cache.device)[None, :] == pos.long()[:, None])
    at_pos = at_pos[None, :, None, None, :, None]  # [1, S, 1, 1, T, 1]

    def one(cache: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
        return torch.where(at_pos, col[:, slot, parent], cache[:, slot, parent])

    return one(k_cache, k_col), one(v_cache, v_col)


def _t_full(x: torch.Tensor, name: str) -> int:
    """The column count of the contiguous buffer ``x`` is a ``T`` prefix of."""
    l, s, k, h, t, d = x.shape
    t_full = x.stride(3) // d if d else t
    want = (s * k * h * t_full * d, k * h * t_full * d, h * t_full * d, t_full * d, d, 1)
    if x.stride() != want or t_full < t:
        raise ValueError(
            f"beam_reorder: {name} must be a T prefix of a contiguous [L, S, K, H, T, d] "
            f"buffer, got shape {tuple(x.shape)} strides {x.stride()}"
        )
    return t_full


def _check(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_col: torch.Tensor,
    v_col: torch.Tensor,
    out_k: torch.Tensor,
    out_v: torch.Tensor,
    cont_parent: torch.Tensor,
    frozen: torch.Tensor,
    pos: torch.Tensor,
) -> int:
    if k_cache.dim() != 6:
        raise ValueError(f"beam_reorder: caches must be [L, S, K, H, T, d], got {tuple(k_cache.shape)}")
    l, s, k, h, t, d = k_cache.shape
    for name, x in (("v_cache", v_cache), ("out_k", out_k), ("out_v", out_v)):
        if x.shape != k_cache.shape:
            raise ValueError(f"beam_reorder: {name} shape {tuple(x.shape)} != {tuple(k_cache.shape)}")
    for name, x in (("k_col", k_col), ("v_col", v_col)):
        if tuple(x.shape) != (l, s, k, h, 1, d) or not x.is_contiguous():
            raise ValueError(f"beam_reorder: {name} must be contiguous [{l}, {s}, {k}, {h}, 1, {d}]")
    tensors = (k_cache, v_cache, k_col, v_col, out_k, out_v)
    if any(x.dtype != k_cache.dtype for x in tensors):
        raise ValueError("beam_reorder: caches, columns and outputs must share one dtype")
    if any(x.device != k_cache.device for x in tensors + (cont_parent, frozen, pos)):
        raise ValueError("beam_reorder: every operand must be on one device")
    if tuple(cont_parent.shape) != (s, k) or tuple(frozen.shape) != (s,) or tuple(pos.shape) != (s,):
        raise ValueError("beam_reorder: cont_parent must be [S, K], frozen and pos [S]")
    row_bytes = d * k_cache.element_size()
    if row_bytes % 16 or any(x.data_ptr() % 16 for x in tensors):
        raise ValueError(f"beam_reorder: rows of {row_bytes} bytes or unaligned data: the kernel "
                         "copies 16-byte vectors")
    if out_k.data_ptr() in (k_cache.data_ptr(), v_cache.data_ptr()) or out_v.data_ptr() in (
            k_cache.data_ptr(), v_cache.data_ptr()):
        raise ValueError("beam_reorder: a permutation cannot be done in place")
    t_full = _t_full(k_cache, "k_cache")
    for name, x in (("v_cache", v_cache), ("out_k", out_k), ("out_v", out_v)):
        if _t_full(x, name) != t_full:
            raise ValueError("beam_reorder: caches and outputs must share one buffer layout")
    if h > 65535:
        raise ValueError("beam_reorder: at most 65535 heads")
    return t_full


def reorder_append_gather(
    k_cache: torch.Tensor,  # [L, S, K, H, T, d]
    v_cache: torch.Tensor,
    k_col: torch.Tensor,  # [L, S, K, H, 1, d]
    v_col: torch.Tensor,
    cont_parent: torch.Tensor,  # [S, K] int, in [0, K)
    frozen: torch.Tensor,  # [S] bool
    pos: torch.Tensor,  # [S] int
    out_k: Optional[torch.Tensor] = None,
    out_v: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both caches permuted by the beam parents with the fresh column
    installed, written into ``out_k``/``out_v`` (allocated when None; only
    the ``T`` columns given are written) and returned."""
    if out_k is None or out_v is None:
        if k_cache.dim() != 6:
            raise ValueError(f"beam_reorder: caches must be [L, S, K, H, T, d], got "
                             f"{tuple(k_cache.shape)}")
        t = k_cache.shape[4]
        full = k_cache.shape[:4] + (_t_full(k_cache, "k_cache"), k_cache.shape[5])
        fresh = lambda: k_cache.new_empty(full)[:, :, :, :, :t]  # noqa: E731
        out_k = fresh() if out_k is None else out_k
        out_v = fresh() if out_v is None else out_v
    t_full = _check(k_cache, v_cache, k_col, v_col, out_k, out_v, cont_parent, frozen, pos)
    if k_cache.device.type == "cpu":
        new_k, new_v = reorder_append_gather_reference(
            k_cache, v_cache, k_col, v_col, cont_parent, frozen, pos)
        out_k.copy_(new_k)
        out_v.copy_(new_v)
        return out_k, out_v
    from reprover_tpu_torch.ops.flash_attention import _ptr, _raise_on_error
    from reprover_tpu_torch.ops.native import load_library

    lib = load_library()
    l, s, k, h, t, d = k_cache.shape
    parent32 = cont_parent.to(torch.int32).contiguous()
    frozen32 = frozen.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(k_cache.device).cuda_stream
    err = lib.beam_reorder_append(
        _ptr(k_cache), _ptr(v_cache), _ptr(k_col), _ptr(v_col), _ptr(out_k), _ptr(out_v),
        _ptr(parent32), _ptr(frozen32), _ptr(pos32), l, s, k, h, t_full, t,
        d * k_cache.element_size(), ctypes.c_void_p(stream),
    )
    _raise_on_error(lib, err, "beam_reorder")
    KERNEL_LAUNCHES["beam_reorder"] += 1
    return out_k, out_v
