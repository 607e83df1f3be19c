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

from typing import Callable, Dict, Optional, Tuple

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


#: Index dtypes the kernel reads as they are (``cont_parent`` and ``pos``
#: share one), with their widths in bytes; ``frozen`` is bool.
INDEX_BYTES = {torch.int64: 8, torch.int32: 4}

#: Rows (``d`` elements, in bytes) narrower than this move by the kernel's
#: bulk copies, wider ones by its vector branch: the choice is made inside
#: the kernel, by what the card measured (see ``csrc/beam_reorder.cu``). A
#: check forces one branch with 1 << 30 (bulk) or 16 (vector).
VECTOR_ROW_BYTES = 256


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
) -> Tuple[int, Tuple[int, ...]]:
    """Raise on what the kernel does not take; returns the buffers' full
    column count and the six data pointers. Every call reads each operand's
    attributes once (this runs at each engine step)."""
    shape = k_cache.shape
    if len(shape) != 6:
        raise ValueError(f"beam_reorder: caches must be [L, S, K, H, T, d], got {tuple(shape)}")
    l, s, k, h, t, d = shape
    strides = k_cache.stride()
    if not (v_cache.shape == out_k.shape == out_v.shape == shape
            and v_cache.stride() == out_k.stride() == out_v.stride() == strides):
        raise ValueError(f"beam_reorder: v_cache, out_k and out_v must have the caches' shape "
                         f"{tuple(shape)} and buffer layout {strides}")
    t_full = _t_full(k_cache, "k_cache")
    col = (l, s, k, h, 1, d)
    if not (k_col.shape == v_col.shape == col and k_col.is_contiguous()
            and v_col.is_contiguous()):
        raise ValueError(f"beam_reorder: k_col and v_col must be contiguous [{l}, {s}, {k}, {h}, "
                         f"1, {d}]")
    if not (v_cache.dtype == k_col.dtype == v_col.dtype == out_k.dtype == out_v.dtype
            == k_cache.dtype):
        raise ValueError("beam_reorder: caches, columns and outputs must share one dtype")
    index = cont_parent.dtype
    if index not in INDEX_BYTES or pos.dtype != index or frozen.dtype != torch.bool:
        raise ValueError(f"beam_reorder: cont_parent and pos must be both int64 or both int32 and "
                         f"frozen bool, got {index}, {pos.dtype}, {frozen.dtype}")
    if not (cont_parent.shape == (s, k) and frozen.shape == pos.shape == (s,)
            and cont_parent.is_contiguous() and frozen.is_contiguous() and pos.is_contiguous()):
        raise ValueError("beam_reorder: cont_parent must be contiguous [S, K], frozen and pos [S]")
    device = k_cache.get_device()
    if not (v_cache.get_device() == k_col.get_device() == v_col.get_device()
            == out_k.get_device() == out_v.get_device() == cont_parent.get_device()
            == frozen.get_device() == pos.get_device() == device):
        raise ValueError("beam_reorder: every operand must be on one device")
    ptrs = (k_cache.data_ptr(), v_cache.data_ptr(), k_col.data_ptr(), v_col.data_ptr(),
            out_k.data_ptr(), out_v.data_ptr())
    row_bytes = d * k_cache.element_size()
    if row_bytes % 16 or (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4] | ptrs[5]) % 16:
        raise ValueError(f"beam_reorder: rows of {row_bytes} bytes or unaligned data: the kernel "
                         "copies 16-byte vectors")
    if ptrs[4] in ptrs[:2] or ptrs[5] in ptrs[:2]:
        raise ValueError("beam_reorder: a permutation cannot be done in place")
    return t_full, ptrs


def reorder_append_gather(
    k_cache: torch.Tensor,  # [L, S, K, H, T, d]
    v_cache: torch.Tensor,
    k_col: torch.Tensor,  # [L, S, K, H, 1, d]
    v_col: torch.Tensor,
    cont_parent: torch.Tensor,  # [S, K] int64 or int32, in [0, K)
    frozen: torch.Tensor,  # [S] bool
    pos: torch.Tensor,  # [S], cont_parent's dtype
    out_k: Optional[torch.Tensor] = None,
    out_v: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both caches permuted by the beam parents with the fresh column
    installed, written into ``out_k``/``out_v`` (allocated when None; only
    the ``T`` columns given are written) and returned. The index tensors are
    read as they are: ``cont_parent`` and ``pos`` contiguous int64 (the
    engines') or int32, ``frozen`` bool; any other dtype raises."""
    if out_k is None or out_v is None:
        if k_cache.dim() != 6:
            raise ValueError(f"beam_reorder: caches must be [L, S, K, H, T, d], got "
                             f"{tuple(k_cache.shape)}")
        t = k_cache.shape[4]
        full = k_cache.shape[:4] + (_t_full(k_cache, "k_cache"), k_cache.shape[5])
        fresh = lambda: k_cache.new_empty(full)[:, :, :, :, :t]  # noqa: E731
        out_k = fresh() if out_k is None else out_k
        out_v = fresh() if out_v is None else out_v
    t_full, ptrs = _check(k_cache, v_cache, k_col, v_col, out_k, out_v, cont_parent, frozen,
                          pos)
    device = k_cache.get_device()
    if device < 0:
        new_k, new_v = reorder_append_gather_reference(
            k_cache, v_cache, k_col, v_col, cont_parent, frozen, pos)
        out_k.copy_(new_k)
        out_v.copy_(new_v)
        return out_k, out_v
    l, s, k, h, t, d = k_cache.shape
    err = _entry()(*ptrs, cont_parent.data_ptr(), frozen.data_ptr(), pos.data_ptr(), l, s, k, h,
                   t_full, t, d * k_cache.element_size(), INDEX_BYTES[pos.dtype],
                   VECTOR_ROW_BYTES, torch._C._cuda_getCurrentRawStream(device))
    if err:
        from reprover_tpu_torch.ops.flash_attention import _raise_on_error
        from reprover_tpu_torch.ops.native import load_library

        _raise_on_error(load_library(), err, "beam_reorder")
    KERNEL_LAUNCHES["beam_reorder"] += 1
    return out_k, out_v


_ENTRY: list = []


def _entry() -> Callable[..., int]:
    """The library's ``beam_reorder_append``, built and loaded at first use."""
    if not _ENTRY:
        from reprover_tpu_torch.ops.native import load_library

        _ENTRY.append(load_library().beam_reorder_append)
    return _ENTRY[0]
