"""Weight bridge: the JAX package's parameter trees -> the port's.

Both packages use one layout (``[in, out]`` dense weights, per-layer weights
stacked on a leading ``[layers, ...]`` axis; T5's MLP split as
``wi_0``/``wi_1`` or fused as ``wi``), so the bridge copies each array into a
CPU tensor under the same key: float32 for float leaves, the stored integer
type for quantized ones. Feed it the tree as numpy arrays
(``jax.tree.map(np.asarray, params)``). A quantized leaf (anything with
``q`` and ``scale`` arrays, plus ``group`` for int4) becomes the port's
:class:`~reprover_tpu_torch.models.quantize.QuantWeight` or
:class:`~reprover_tpu_torch.models.quantize.Quant4Weight` with the same bytes.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from reprover_tpu_torch.models.quantize import Quant4Weight, QuantWeight
from reprover_tpu_torch.models.t5 import Params

_TOP_LEVEL = {"shared_embedding", "encoder", "decoder", "lm_head"}
_CAUSAL_TOP_LEVEL = {"embedding", "layers", "final_norm", "lm_head"}


def _convert(x: Any) -> Any:
    if isinstance(x, Mapping):
        return {k: _convert(v) for k, v in x.items()}
    if hasattr(x, "q") and hasattr(x, "scale"):
        q = torch.from_numpy(np.array(x.q, copy=True))
        scale = torch.from_numpy(np.array(x.scale, dtype=np.float32, copy=True))
        kernel_ok = bool(getattr(x, "kernel_ok", True))
        if hasattr(x, "group"):
            return Quant4Weight(q=q, scale=scale, kernel_ok=kernel_ok, group=int(x.group))
        return QuantWeight(q=q, scale=scale, kernel_ok=kernel_ok)
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def params_from_jax(tree: Mapping[str, Any]) -> Params:
    """Numpy param tree of the JAX package's T5 (split or fused MLP,
    optionally quantized) -> port params."""
    unknown = set(tree) - _TOP_LEVEL
    if unknown:
        raise KeyError(f"not a T5 parameter tree: unexpected keys {sorted(unknown)}")
    return _convert(tree)


def causal_params_from_jax(tree: Mapping[str, Any]) -> Params:
    """Numpy param tree of the JAX package's decoder-only causal LM
    (optionally quantized) -> port params."""
    unknown = set(tree) - _CAUSAL_TOP_LEVEL
    if unknown:
        raise KeyError(f"not a causal-LM parameter tree: unexpected keys {sorted(unknown)}")
    return _convert(tree)
