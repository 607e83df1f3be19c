"""Weight bridge: the JAX package's parameter tree -> the port's.

Both packages use one layout (``reprover_tpu/models/t5.py``: ``[in, out]``
dense weights, per-layer weights stacked on a leading ``[layers, ...]``
axis, MLP split as ``wi_0``/``wi_1`` or fused as ``wi``), so the bridge
copies each array into a float32 CPU tensor under the same key. Feed it the
tree as numpy arrays (``jax.tree.map(np.asarray, params)``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from reprover_tpu_torch.models.t5 import Params

_TOP_LEVEL = {"shared_embedding", "encoder", "decoder", "lm_head"}


def params_from_jax(tree: Mapping[str, Any]) -> Params:
    """Numpy param tree of the JAX package (split or fused MLP) -> port params."""
    unknown = set(tree) - _TOP_LEVEL
    if unknown:
        raise KeyError(f"not a T5 parameter tree: unexpected keys {sorted(unknown)}")

    def convert(x: Any) -> Any:
        if isinstance(x, Mapping):
            return {k: convert(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))

    return convert(tree)
