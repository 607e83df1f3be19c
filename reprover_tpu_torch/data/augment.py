"""State augmentation with retrieved premises, and mark handling.

Parity targets: `reference/common.py:25-31` (marks),
`reference/common.py:341-378` (positive-premise resolution and
byte-budgeted augmented-state formatting).
"""

from __future__ import annotations

import random
from typing import TYPE_CHECKING, Any, List, Optional, Sequence, Tuple

if TYPE_CHECKING:  # pragma: no cover - type-only import, avoids cycle
    from reprover_tpu_torch.data.corpus import Corpus, Premise

MARK_START_SYMBOL = "<a>"
MARK_END_SYMBOL = "</a>"


def remove_marks(s: str) -> str:
    """Strip all ``<a>``/``</a>`` retrieval marks from ``s``."""
    return s.replace(MARK_START_SYMBOL, "").replace(MARK_END_SYMBOL, "")


def format_augmented_state(
    s: str,
    premises: Sequence["Premise"],
    max_len: Optional[int] = None,
    p_drop: float = 0.0,
    rng: Optional[random.Random] = None,
) -> str:
    """Prepend retrieved premises to state ``s`` under a utf-8 byte budget.

    Premises are *prepended in reverse* so the highest-scored premise ends up
    adjacent to the state; each may be dropped with probability ``p_drop``
    (training regularization); premises that would exceed the budget are
    skipped, not truncated (`common.py:357-378` semantics, byte-accurate
    because ByT5 tokens are bytes).
    """
    rand = rng.random if rng is not None else random.random
    aug = ""
    used = 0
    budget = (max_len if max_len is not None else 1 << 62) - len(s.encode("utf-8"))
    for p in premises:
        if p_drop > 0 and rand() < p_drop:
            continue
        p_str = f"{p.serialize()}\n\n"
        n = len(p_str.encode("utf-8"))
        if used + n > budget:
            continue
        used += n
        aug = p_str + aug
    return aug + s


def get_all_pos_premises(annot_tac: Tuple[str, List[Any]], corpus: "Corpus") -> List["Premise"]:
    """Resolve a tactic's provenance annotations to ``Premise`` objects.

    Unlocatable provenances are dropped (the reference logs a warning,
    `common.py:341-354`). De-duplicated, order not guaranteed (reference uses
    a set).
    """
    from reprover_tpu_torch.data.pos import Pos

    _, provenances = annot_tac
    seen = {}
    for prov in provenances:
        p = corpus.locate_premise(prov["def_path"], Pos.of(prov["def_pos"]))
        if p is not None:
            seen[(p.path, p.full_name)] = p
    return list(seen.values())
