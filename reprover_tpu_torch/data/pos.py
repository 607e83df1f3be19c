"""Source position type, structurally compatible with ``lean_dojo.Pos``.

The framework does not depend on LeanDojo for its data layer; any object with
``line_nb``/``column_nb`` (or a 2-sequence) converts via ``Pos.of``.
Reference semantics: positions compare lexicographically (line, column)
(`reference/common.py:83-90` relies on ``<=`` between ``Pos``).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True, order=True)
class Pos:
    """1-indexed (line, column) position in a source file."""

    line_nb: int
    column_nb: int

    @classmethod
    def of(cls, p: Any) -> "Pos":
        """Coerce a ``Pos``-like object (ours, lean_dojo's, or a 2-seq)."""
        if isinstance(p, cls):
            return p
        if hasattr(p, "line_nb") and hasattr(p, "column_nb"):
            return cls(int(p.line_nb), int(p.column_nb))
        line, col = p
        return cls(int(line), int(col))

    def to_list(self) -> list:
        return [self.line_nb, self.column_nb]

    def __repr__(self) -> str:  # compact, matches (line, column) convention
        return f"Pos({self.line_nb}, {self.column_nb})"
