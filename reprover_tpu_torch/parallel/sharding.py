"""Sharding specs for T5 and causal-LM parameters, Adam's moments and
batches: the counterpart of :mod:`reprover_tpu.parallel.sharding`.

A spec is a tuple with one entry per leading axis of a leaf: ``None``
(whole) or a mesh axis name (split over it); missing trailing entries are
whole, so ``()`` replicates (the JAX package's ``PartitionSpec()``). Spec
trees mirror parameter trees, quantized weights included
(:class:`~reprover_tpu_torch.models.quantize.QuantWeight` nodes hold a spec
in ``q`` and ``scale``).

- DeepSpeed ZeRO-2 over data-parallel ranks -> :func:`zero_partition_specs`:
  Adam's moments split over ``data``, parameters replicated, gradients
  summed over ``data``.
- vLLM tensor parallelism -> ``param_partition_specs(model_parallel=True)``
  and :func:`causal_param_partition_specs`: Megatron column/row splits over
  ``model`` (:func:`shard_for_model` checks the degree and cuts each rank's
  part; :func:`zero_partition_specs` keeps the split in the moments).

:func:`shard_pytree` returns this rank's shard of each leaf. Where the mesh
does not divide an axis it replicates that axis, as the JAX package does,
and logs a warning (the JAX package replicates silently: reference fault 5).
The axes that carry heads and the MLP's hidden units never get there:
:func:`check_model_divides` raises first. An int4 weight's scales split with
its packed nibbles, so group boundaries stay shard-local (a rank whose rows
all lie in one group takes that group's scale); any other cut raises. A
quantized shard carries its whole weight's ``[K, N]`` (``logical_shape``),
which the kernel routing reads, so a shard routes as the whole weight does
on one card.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from reprover_tpu_torch.models.quantize import Quant4Weight, QuantWeight
from reprover_tpu_torch.parallel.mesh import Mesh

logger = logging.getLogger(__name__)

Spec = Tuple[Optional[str], ...]


def replicated(mesh: Mesh) -> Spec:
    return ()


def batch_sharding(mesh: Mesh, ndim: int = 2) -> Spec:
    """Split the leading (batch) axis over ``data``; the rest whole."""
    return ("data",) + (None,) * (ndim - 1)


def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every tensor of a parameter tree (dicts, lists; quantized
    weights' ``q`` and ``scale`` included), keeping the tree's structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, QuantWeight):
        return dataclasses.replace(tree, q=fn(tree.q), scale=fn(tree.scale))
    return fn(tree)


def _map2(fn: Callable[[Any, Any], Any], tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a parameter tree and its matching spec tree."""
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, list):
        return [_map2(fn, t, s) for t, s in zip(tree, specs)]
    if isinstance(tree, QuantWeight):
        return dataclasses.replace(tree, q=fn(tree.q, specs.q), scale=fn(tree.scale, specs.scale))
    return fn(tree, specs)


def _mirror_quant_specs(params: Any, specs: Any) -> Any:
    """Mirror the quantized nodes of ``params`` into a spec tree.

    int8 :class:`QuantWeight`: the scale ``[..., 1, O]`` keeps the weight's
    output-channel split (axis -1) and replicates the contracted axis (-2,
    size 1). int4 :class:`Quant4Weight`: ``q [..., K/2, O]`` and ``scale
    [..., K/g, O]`` share the logical weight's axes, so both take its spec."""

    def rec(p: Any, s: Any) -> Any:
        if isinstance(p, dict):
            return {k: rec(p[k], s[k]) for k in p}
        if isinstance(p, Quant4Weight):
            return dataclasses.replace(p, q=s, scale=s)
        if isinstance(p, QuantWeight):
            full = tuple(s) + (None,) * (p.q.dim() - len(tuple(s)))
            return dataclasses.replace(p, q=s, scale=full[:-2] + (None, full[-1]))
        return s

    return rec(params, specs)


def _attn_specs(layered: bool) -> Dict[str, Spec]:
    """Megatron split: q/k/v column-parallel (head axis), o row-parallel."""
    l: Spec = (None,) if layered else ()
    return {"q": l + (None, "model"), "k": l + (None, "model"), "v": l + (None, "model"),
            "o": l + ("model", None)}


def _mlp_specs(layered: bool, fused: bool = False) -> Dict[str, Spec]:
    l: Spec = (None,) if layered else ()
    if fused:  # pre-fused gate|up projection (t5.fuse_mlp_params)
        return {"wi": l + (None, "model"), "wo": l + ("model", None)}
    return {"wi_0": l + (None, "model"), "wi_1": l + (None, "model"), "wo": l + ("model", None)}


def param_partition_specs(params: Any, cfg: Any, model_parallel: bool = False) -> Any:
    """Spec tree matching a T5 ``params`` tree.

    ``model_parallel=False`` replicates everything (pure data parallelism);
    ``True`` splits attention heads and the MLP hidden axis over ``model``.
    ``d_kv`` stays whole: the split lands on the head axis because
    ``inner_dim = heads * d_kv`` is the stored axis."""
    if not model_parallel:
        return _map(lambda _: (), params)

    fused = "wi" in params["encoder"]["layers"]["mlp"]
    norm: Spec = (None, None)  # [L, d_model]
    out: Dict[str, Any] = {
        "shared_embedding": (None, None),
        "encoder": {
            "rel_bias": (),
            "layers": {"attn": _attn_specs(True), "attn_norm": norm,
                       "mlp": _mlp_specs(True, fused), "mlp_norm": norm},
            "final_norm": (None,),
        },
    }
    if "decoder" in params:
        out["decoder"] = {
            "rel_bias": (),
            "layers": {"self_attn": _attn_specs(True), "self_norm": norm,
                       "cross_attn": _attn_specs(True), "cross_norm": norm,
                       "mlp": _mlp_specs(True, fused), "mlp_norm": norm},
            "final_norm": (None,),
        }
    if "lm_head" in params:
        out["lm_head"] = (None, "model")
    return _mirror_quant_specs(params, out)


def causal_param_partition_specs(params: Any, model_parallel: bool = False) -> Any:
    """Spec tree for :mod:`reprover_tpu_torch.models.causal_lm` params:
    q/k/v/gate/up column-parallel, o/down row-parallel over ``model``."""
    if not model_parallel:
        return _map(lambda _: (), params)
    layered = {
        "input_norm": (None, None),
        "q": (None, None, "model"), "k": (None, None, "model"), "v": (None, None, "model"),
        "o": (None, "model", None),
        "post_norm": (None, None),
        "gate": (None, None, "model"), "up": (None, None, "model"),
        "down": (None, "model", None),
    }
    out: Dict[str, Any] = {"embedding": (None, None), "layers": layered, "final_norm": (None,)}
    if "lm_head" in params:
        out["lm_head"] = (None, "model")
    return _mirror_quant_specs(params, out)


def zero_partition_specs(params: Any, mesh: Mesh, param_specs: Any = None) -> Any:
    """ZeRO specs of Adam's moments over the ``data`` axis, one per leaf of
    ``params``.

    Each leaf splits its largest free axis that the ``data`` size divides
    (the earlier axis among equals); a leaf with no such axis stays whole.
    With ``param_specs`` (tensor parallelism) a moment keeps its parameter's
    ``model`` split and adds ``data`` only on an axis the parameter leaves
    whole."""
    n = mesh.shape["data"]

    def spec(x: torch.Tensor, base: Spec = ()) -> Spec:
        parts = (list(base) + [None] * (x.dim() - len(base)))[: x.dim()]
        if n <= 1 or x.dim() == 0:
            return tuple(parts)
        for axis in sorted(range(x.dim()), key=lambda a: -x.shape[a]):
            if parts[axis] is None and x.shape[axis] % n == 0 and x.shape[axis] >= n:
                parts[axis] = "data"
                break
        return tuple(parts)

    if param_specs is None:
        return _map(spec, params)
    return _map2(spec, params, param_specs)


def shard_axis(spec: Spec, axis_name: str = "data") -> Optional[int]:
    """The tensor axis a spec splits over ``axis_name`` (None: whole)."""
    for i, name in enumerate(spec):
        names = name if isinstance(name, tuple) else (name,)
        if axis_name in names:
            return i
    return None


def _legalize_spec(spec: Spec, shape: Tuple[int, ...], mesh: Mesh) -> Spec:
    """Replicate any spec axis that the mesh does not divide evenly, with a
    warning (the JAX package replicates silently, reference fault 5: an
    int4 scale at TP=4, say, would cost memory and nobody would know)."""
    names = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for axis, (dim, name) in enumerate(zip(shape, names)):
        if name is None:
            out.append(None)
            continue
        size = 1
        for n in (name,) if isinstance(name, str) else name:
            size *= mesh.shape[n]
        if dim % size:
            logger.warning("sharding: axis %d of a %s leaf is not divisible by mesh axis %r "
                           "(%d ranks): replicated", axis, tuple(shape), name, size)
            out.append(None)
        else:
            out.append(name)
    return tuple(out)


# A fused T5 MLP input ``wi`` is gate|up along its last axis: a column split
# gives each rank its slice of each half (the JAX package's GSPMD computes
# the same split of the fused product with its own communication).
FUSED_BLOCKS = {"wi": 2}


def model_part(t: torch.Tensor, axis: int, mesh: Mesh, blocks: int = 1) -> torch.Tensor:
    """This rank's ``model`` shard of a whole ``t`` along ``axis``: its slice
    of each of ``blocks`` equal parts, concatenated (a view for one part)."""
    n, r = mesh.shape["model"], mesh.coord("model")
    parts = t.chunk(blocks, dim=axis)
    size = parts[0].shape[axis] // n
    cut = [p.narrow(axis, r * size, size) for p in parts]
    return cut[0] if blocks == 1 else torch.cat(cut, dim=axis)


def model_whole(local: torch.Tensor, axis: int, mesh: Mesh, blocks: int = 1) -> torch.Tensor:
    """The whole tensor of which ``local`` is this rank's
    :func:`model_part` (a collective over ``model``, no gradient)."""
    from reprover_tpu_torch.parallel.collectives import gather_model

    return torch.cat([gather_model(p, axis, mesh) for p in local.chunk(blocks, dim=axis)],
                     dim=axis)


def local_shard(x: torch.Tensor, spec: Spec, mesh: Mesh, blocks: int = 1) -> torch.Tensor:
    """This rank's shard of ``x`` under ``spec`` (a view, but for a split
    ``model`` axis of ``blocks`` parts), legalized first."""
    for axis, name in enumerate(_legalize_spec(spec, tuple(x.shape), mesh)):
        if name is None:
            continue
        if name == "model" and blocks > 1:
            x = model_part(x, axis, mesh, blocks)
            continue
        index, size = 0, 1
        for n in (name,) if isinstance(name, str) else name:
            index, size = index * mesh.shape[n] + mesh.coord(n), size * mesh.shape[n]
        chunk = x.shape[axis] // size
        x = x.narrow(axis, index * chunk, chunk)
    return x


def _shard_quant(w: QuantWeight, spec: QuantWeight, mesh: Mesh, blocks: int = 1
                 ) -> QuantWeight:
    """This rank's shard of a quantized weight, ``logical_shape`` the whole
    weight's per-layer ``[K, N]``. An int4 weight's scales split along K
    with its packed nibbles or the shard raises."""
    q_spec = _legalize_spec(spec.q, tuple(w.q.shape), mesh)
    k = w.q.shape[-2] * (2 if isinstance(w, Quant4Weight) else 1)
    out = dataclasses.replace(w, q=local_shard(w.q, q_spec, mesh, blocks),
                              logical_shape=w.logical_shape or (k, w.q.shape[-1]))
    s_spec = tuple(spec.scale) + (None,) * (w.scale.dim() - len(tuple(spec.scale)))
    if (not isinstance(w, Quant4Weight) or q_spec[-2] is None
            or w.scale.shape[-2] % mesh.shape["model"] == 0):
        return dataclasses.replace(out, scale=local_shard(w.scale, s_spec, mesh, blocks))
    s_spec = s_spec[:-2] + (None, s_spec[-1])
    # The K split cuts inside the groups: where each rank's rows lie in one
    # group, that group's scale row serves them as one group of the rank's
    # K (the same dequantized values); any other cut raises.
    k_local = 2 * out.q.shape[-2]
    if q_spec[-2] != "model" or w.group % k_local:
        raise ValueError(
            f"an int4 weight {tuple(w.q.shape)} (group {w.group}) splits its packed K axis over "
            f"{q_spec[-2]!r} into {k_local} rows a rank, which neither hold whole groups nor "
            f"lie in one: the mesh must divide its {w.scale.shape[-2]} scale groups")
    row = (mesh.coord("model") * k_local) // w.group
    scale = local_shard(w.scale, s_spec, mesh).narrow(-2, row, 1)
    return dataclasses.replace(out, scale=scale, group=k_local)


def shard_pytree(tree: Any, specs: Any, mesh: Mesh, _key: str = "") -> Any:
    """This rank's shard of every leaf of ``tree`` under the matching spec
    tree (views of the leaves, but for a fused ``wi``'s split:
    :data:`FUSED_BLOCKS`)."""
    if isinstance(tree, dict):
        return {k: shard_pytree(tree[k], specs[k], mesh, k) for k in tree}
    blocks = FUSED_BLOCKS.get(_key, 1)
    if isinstance(tree, QuantWeight):
        return _shard_quant(tree, specs, mesh, blocks)
    return local_shard(tree, specs, mesh, blocks)


def model_blocks(tree: Any, _key: str = "") -> Any:
    """The tree of each leaf's part count along its ``model`` split (2 for a
    fused ``wi``, else 1)."""
    if isinstance(tree, dict):
        return {k: model_blocks(v, k) for k, v in tree.items()}
    return FUSED_BLOCKS.get(_key, 1)


def check_model_divides(cfg: Any, model: int) -> None:
    """Raise ``ValueError`` unless the tensor-parallel degree ``model``
    divides the axes it splits: T5's ``num_heads`` and ``d_ff`` (the JAX
    package's ``engine.py:1103-1106``; byt5-small's 6 heads allow 2, 3 or 6,
    never 4), the causal family's ``num_kv_heads`` (and so ``num_heads``)
    and ``d_ff`` (``causal_engine.py:341-344``)."""
    if model <= 1:
        return
    names = (("num_heads", "num_kv_heads", "d_ff") if hasattr(cfg, "num_kv_heads")
             else ("num_heads", "d_ff"))
    dims = {n: getattr(cfg, n) for n in names}
    if any(v % model for v in dims.values()):
        raise ValueError(f"tensor-parallel degree {model} must divide "
                         + ", ".join(f"{n}={v}" for n, v in dims.items()))


def model_partition_specs(params: Any, cfg: Any) -> Any:
    """The Megatron spec tree of ``params`` for either model family (by
    its config: the causal one has ``num_kv_heads``)."""
    if hasattr(cfg, "num_kv_heads"):
        return causal_param_partition_specs(params, model_parallel=True)
    return param_partition_specs(params, cfg, model_parallel=True)


def shard_for_model(params: Any, cfg: Any, mesh: Mesh) -> Tuple[Any, Any]:
    """This rank's tensor-parallel part of ``params`` (each leaf made
    contiguous, so the whole tree can be freed and the kernels take the
    shards) and the spec tree it was cut by; with ``model`` one rank, the
    tree itself and replicated specs."""
    if not mesh.spans("model"):
        return params, _map(lambda _: (), params)
    check_model_divides(cfg, mesh.shape["model"])
    specs = model_partition_specs(params, cfg)
    local = _map(lambda t: t.contiguous(), shard_pytree(params, specs, mesh))

    def legal(x: Any, spec: Any) -> Any:  # a quantized node keeps its spec node
        if isinstance(x, dict):
            return {k: legal(x[k], spec[k]) for k in x}
        return spec if isinstance(x, QuantWeight) else _legalize_spec(spec, tuple(x.shape), mesh)

    return local, legal(params, specs)


def gather_for_model(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The whole leaves of which ``tree`` holds this rank's ``model``
    shards under ``specs`` (the inverse of :func:`shard_for_model`, for a
    checkpoint in the one-card layout; a collective: every rank calls it)."""
    def whole(x: Any, spec: Spec, key: str) -> Any:
        if isinstance(x, dict):
            return {k: whole(x[k], spec[k], k) for k in x}
        axis = shard_axis(spec, "model")
        return x if axis is None else model_whole(x, axis, mesh, FUSED_BLOCKS.get(key, 1))

    return whole(tree, specs, "")


def local_rows(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (its slice of axis 0 of every
    array, as :func:`batch_sharding` places it). The ``data`` size must
    divide every array's rows: a batch is never replicated."""
    n = mesh.shape["data"]
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch field {k!r} has {v.shape[0]} rows, not divisible by the "
                             f"data axis ({n} ranks)")
    return {k: local_shard(v, batch_sharding(mesh, v.dim()), mesh) for k, v in batch.items()}
