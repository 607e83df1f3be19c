"""Interop with pickle artifacts written by the reference or the JAX package.

The reference pickles `predictions.pickle` / `*_results.pickle` containing
instances of its own classes (``common.Context``, ``common.Premise``,
``lean_dojo...Pos``); the JAX package's pickles hold
``reprover_tpu.data.*`` instances. :func:`load_reference_pickle` remaps
both sets of class paths, and the port's own, onto the port's
structurally-compatible classes at unpickle time (field names match by
design — `common.py:34-106`), so an artifact written by either package
loads here without importing the JAX package.
"""

from __future__ import annotations

import io
import pickle
from typing import Any, Dict, Tuple

from reprover_tpu_torch.data.corpus import Context, Premise
from reprover_tpu_torch.data.pos import Pos

#: (module, qualname) -> replacement class
_CLASS_MAP: Dict[Tuple[str, str], Any] = {
    ("common", "Premise"): Premise,
    ("common", "Context"): Context,
    ("common", "Pos"): Pos,
    ("lean_dojo.data_extraction.lean", "Pos"): Pos,
    ("lean_dojo.utils", "Pos"): Pos,
    ("lean_dojo", "Pos"): Pos,
    ("reprover_tpu.data.corpus", "Premise"): Premise,
    ("reprover_tpu.data.corpus", "Context"): Context,
    ("reprover_tpu.data.pos", "Pos"): Pos,
    ("reprover_tpu_torch.data.corpus", "Premise"): Premise,
    ("reprover_tpu_torch.data.corpus", "Context"): Context,
    ("reprover_tpu_torch.data.pos", "Pos"): Pos,
}


class _RemappingUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        mapped = _CLASS_MAP.get((module, name))
        if mapped is not None:
            return mapped
        # Reference and JAX-package classes that aren't mapped cannot (and
        # should not) load: the port never imports the JAX package.
        if module in ("common", "reprover_tpu") or module.startswith(
            ("lean_dojo", "prover.", "reprover_tpu.")
        ):
            raise pickle.UnpicklingError(
                f"no mapping for reference class {module}.{name}"
            )
        return super().find_class(module, name)


def load_reference_pickle(path_or_file: Any) -> Any:
    """Load a pickle written by the reference (or by this framework)."""
    if hasattr(path_or_file, "read"):
        return _RemappingUnpickler(path_or_file).load()
    with open(path_or_file, "rb") as f:
        return _RemappingUnpickler(f).load()


def loads_reference_pickle(data: bytes) -> Any:
    return _RemappingUnpickler(io.BytesIO(data)).load()
