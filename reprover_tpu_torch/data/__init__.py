"""Host-side data layer: corpus DAG, accessibility bitmasks, datasets."""

from reprover_tpu_torch.data.pos import Pos
from reprover_tpu_torch.data.corpus import (
    Context,
    Corpus,
    File,
    IndexedCorpus,
    Premise,
    PremiseSet,
)
from reprover_tpu_torch.data.augment import (
    MARK_END_SYMBOL,
    MARK_START_SYMBOL,
    format_augmented_state,
    get_all_pos_premises,
    remove_marks,
)

# augment.py's Corpus/Premise annotations are TYPE_CHECKING-only (corpus.py
# imports augment for the mark symbols — a real cycle). Bind the runtime
# names here, after both modules exist, so `typing.get_type_hints` resolves
# them (enforced by tests/test_annotations.py::test_annotations_resolve).
import reprover_tpu_torch.data.augment as _augment_mod

_augment_mod.Corpus = Corpus
_augment_mod.Premise = Premise
del _augment_mod

__all__ = [
    "Pos",
    "Context",
    "Corpus",
    "File",
    "IndexedCorpus",
    "Premise",
    "PremiseSet",
    "MARK_START_SYMBOL",
    "MARK_END_SYMBOL",
    "format_augmented_state",
    "get_all_pos_premises",
    "remove_marks",
]
