"""Retrieval corpus: a DAG of Lean files defining premises.

Re-design of the reference corpus machinery (`reference/common.py:34-338`)
for TPU-friendly retrieval:

- The reference computes accessibility *per query on the host*: full
  ``argsort`` of similarities then a Python loop keeping accessible premises
  (`common.py:299-326`). Here accessibility is precomputed as **bitmasks**:
  the file-level transitive closure is one forward bitset sweep (file order in
  ``corpus.jsonl`` is topological — imports precede importers, asserted as in
  `common.py:211-215`), and premises of a file are contiguous in the flat
  premise array, so a premise-level mask is a handful of range fills. At query
  time the mask rides to the device and top-k becomes a fused
  ``where(mask, sim, -inf)`` + ``lax.top_k`` — no host loop, no full sort.

- Semantics parity: ``get_accessible_premise_indexes`` matches
  `common.py:291-297` (same-file premises with ``end <= pos`` plus premises of
  transitively imported files); ``get_nearest_premises`` reproduces the
  filter-after-argsort result of `common.py:299-326` including the
  ``ValueError`` when fewer than ``k`` premises are accessible.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Any, Dict, Generator, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from reprover_tpu_torch.data.pos import Pos
from reprover_tpu_torch.data.augment import MARK_END_SYMBOL, MARK_START_SYMBOL


@dataclasses.dataclass(unsafe_hash=True)
class Context:
    """A retrieval query: the proof state at a position in a theorem."""

    path: str
    theorem_full_name: str
    theorem_pos: Pos = dataclasses.field(compare=False)
    state: str = ""

    def __post_init__(self) -> None:
        object.__setattr__(self, "theorem_pos", Pos.of(self.theorem_pos))
        assert isinstance(self.state, str) and "⊢" in self.state
        assert MARK_START_SYMBOL not in self.state
        assert MARK_END_SYMBOL not in self.state

    def serialize(self) -> str:
        """The model-facing string for this query (the raw state)."""
        return self.state


@dataclasses.dataclass(unsafe_hash=True)
class Premise:
    """A retrieval document: a named definition/theorem in a Lean file."""

    path: str
    full_name: str
    start: Pos = dataclasses.field(repr=False)
    end: Pos = dataclasses.field(repr=False, compare=False)
    code: str = dataclasses.field(compare=False, default="")

    def __post_init__(self) -> None:
        object.__setattr__(self, "start", Pos.of(self.start))
        object.__setattr__(self, "end", Pos.of(self.end))
        assert self.start <= self.end
        assert isinstance(self.code, str) and self.code != ""

    def serialize(self) -> str:
        """Model-facing string with the premise's own name wrapped in marks.

        Mirrors `reference/common.py:93-106`: the ``_root_.`` qualified
        occurrence is replaced directly; otherwise the *longest* dotted suffix
        of ``full_name`` that occurs (preceded by whitespace, optionally
        guillemet-quoted) is replaced, stopping at the first suffix that hits.
        """
        annot = f"{MARK_START_SYMBOL}{self.full_name}{MARK_END_SYMBOL}"
        code = self.code.replace(f"_root_.{self.full_name}", annot)
        parts = self.full_name.split(".")
        for i in range(len(parts)):
            suffix = ".".join(parts[i:])
            new_code = re.sub(rf"(?<=\s)«?{re.escape(suffix)}»?", annot, code)
            if new_code != code:
                return new_code
        return code


class PremiseSet:
    """A set of premises keyed by (path, full_name) with O(1) membership."""

    def __init__(self) -> None:
        self.path2premises: Dict[str, Dict[str, Premise]] = {}

    def __iter__(self) -> Generator[Premise, None, None]:
        for premises in self.path2premises.values():
            yield from premises.values()

    def add(self, p: Premise) -> None:
        self.path2premises.setdefault(p.path, {})[p.full_name] = p

    def update(self, premises: Iterable[Premise]) -> None:
        for p in premises:
            self.add(p)

    def __contains__(self, p: Premise) -> bool:
        d = self.path2premises.get(p.path)
        return d is not None and p.full_name in d

    def __len__(self) -> int:
        return sum(len(d) for d in self.path2premises.values())


@dataclasses.dataclass(frozen=True)
class File:
    """A Lean source file defining zero or more premises."""

    path: str
    premises: List[Premise] = dataclasses.field(repr=False, compare=False)

    @classmethod
    def from_data(cls, file_data: Dict[str, Any]) -> "File":
        """Parse one ``corpus.jsonl`` record, dropping ill-formed premises.

        Filter parity with `reference/common.py:158-167`: premises with
        a null name, empty code, auto-generated ``user__.n`` names, or mutual
        ``[...]`` definition names are skipped.
        """
        path = file_data["path"]
        premises = []
        for p in file_data["premises"]:
            name = p["full_name"]
            if name is None or "user__.n" in name or p["code"] == "":
                continue
            if name.startswith("[") and name.endswith("]"):
                continue
            premises.append(
                Premise(path, name, Pos.of(p["start"]), Pos.of(p["end"]), p["code"])
            )
        return cls(path, premises)

    @property
    def is_empty(self) -> bool:
        return not self.premises


def _pack_bits(num: int) -> int:
    """Number of uint64 words needed for ``num`` bits."""
    return (num + 63) // 64


class Corpus:
    """The premise corpus: files + import DAG + accessibility bitmasks.

    Files are stored in ``corpus.jsonl`` order, which is asserted topological
    (every import appears before its importer). The transitive closure over
    files is a packed uint64 bitset per file, computed in one forward pass:
    ``closure[f] = union(closure[dep] | bit(dep) for dep in imports[f])``.

    Premises are flattened in file order, so premises of file ``i`` occupy the
    contiguous index range ``premise_ranges[i]`` — premise-level masks are
    cheap range fills over the file bitset.
    """

    def __init__(self, jsonl_path: str) -> None:
        self.jsonl_path = jsonl_path
        self._file_idx: Dict[str, int] = {}
        self._files: List[File] = []
        direct_imports: List[List[int]] = []

        with open(jsonl_path) as f:
            for line in f:
                file_data = json.loads(line)
                path = file_data["path"]
                assert path not in self._file_idx, f"duplicate file {path}"
                imports = []
                for dep in file_data["imports"]:
                    assert dep in self._file_idx, (
                        f"{path} imports {dep} before it is defined — "
                        "corpus.jsonl must be topologically ordered"
                    )
                    imports.append(self._file_idx[dep])
                self._file_idx[path] = len(self._files)
                self._files.append(File.from_data(file_data))
                direct_imports.append(imports)

        n = len(self._files)
        self._direct_imports = direct_imports

        # Transitive closure as bitsets: one forward pass over topo order.
        words = _pack_bits(n)
        closure = np.zeros((n, words), dtype=np.uint64)
        for i, deps in enumerate(direct_imports):
            for d in deps:
                closure[i] |= closure[d]
                closure[i, d // 64] |= np.uint64(1 << (d % 64))
        self._closure = closure

        # Flatten premises in file order; record per-file contiguous ranges.
        self.all_premises: List[Premise] = []
        self._premise_ranges: List[Tuple[int, int]] = []
        for file in self._files:
            start = len(self.all_premises)
            self.all_premises.extend(file.premises)
            self._premise_ranges.append((start, len(self.all_premises)))

        # Premise index lookup by (path, full_name) — last definition wins,
        # and by-position lookup table per file for locate_premise.
        self._premise_idx: Dict[Tuple[str, str], int] = {}
        for i, p in enumerate(self.all_premises):
            self._premise_idx[(p.path, p.full_name)] = i

        # Per-file imported-premise mask cache (pos-independent part of
        # accessibility), filled lazily.
        self._imported_mask_cache: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------------ #
    # Basic container API (parity with common.py:224-251)
    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        return len(self.all_premises)

    def __contains__(self, path: str) -> bool:
        return path in self._file_idx

    def __getitem__(self, idx: int) -> Premise:
        return self.all_premises[idx]

    @property
    def files(self) -> List[File]:
        return list(self._files)

    @property
    def num_files(self) -> int:
        return len(self._files)

    def get_premises(self, path: str) -> List[Premise]:
        return self._files[self._file_idx[path]].premises

    def num_premises(self, path: str) -> int:
        return len(self.get_premises(path))

    def get_dependencies(self, path: str) -> List[str]:
        """All (direct and transitive) imports of ``path``."""
        i = self._file_idx[path]
        return [self._files[d].path for d in self._closure_indices(i)]

    def imports_transitively(self, path: str, dep_path: str) -> bool:
        """True iff ``path`` (transitively) imports ``dep_path``."""
        i = self._file_idx.get(path)
        d = self._file_idx.get(dep_path)
        if i is None or d is None:
            return False
        return bool(self._closure[i, d // 64] >> np.uint64(d % 64) & np.uint64(1))

    def _closure_indices(self, i: int) -> np.ndarray:
        """File indices transitively imported by file ``i``."""
        bits = np.unpackbits(self._closure[i].view(np.uint8), bitorder="little")
        return np.nonzero(bits[: len(self._files)])[0]

    def locate_premise(self, path: str, pos: Pos) -> Optional[Premise]:
        """The premise whose definition spans ``pos``, if any."""
        if path not in self._file_idx:
            return None
        pos = Pos.of(pos)
        for p in self.get_premises(path):
            if p.start <= pos <= p.end:
                return p
        return None

    def premise_index(self, p: Premise) -> Optional[int]:
        return self._premise_idx.get((p.path, p.full_name))

    # ------------------------------------------------------------------ #
    # Accessibility (bitmask design)
    # ------------------------------------------------------------------ #

    def _imported_premise_mask(self, file_i: int) -> np.ndarray:
        """Bool mask over premises defined in files imported by ``file_i``."""
        cached = self._imported_mask_cache.get(file_i)
        if cached is not None:
            return cached
        mask = np.zeros(len(self.all_premises), dtype=bool)
        for d in self._closure_indices(file_i):
            lo, hi = self._premise_ranges[d]
            mask[lo:hi] = True
        self._imported_mask_cache[file_i] = mask
        return mask

    def accessible_mask(self, path: str, pos: Pos) -> np.ndarray:
        """Bool mask [num_premises]: accessible at ``pos`` in ``path``.

        Accessible = defined in a transitively imported file, or earlier
        (``end <= pos``) in the same file (`common.py:280-297` semantics).
        """
        pos = Pos.of(pos)
        i = self._file_idx[path]
        mask = self._imported_premise_mask(i).copy()
        lo, hi = self._premise_ranges[i]
        for j in range(lo, hi):
            if self.all_premises[j].end <= pos:
                mask[j] = True
        return mask

    def accessible_mask_batch(
        self, contexts: Sequence[Context]
    ) -> np.ndarray:
        """Stacked accessibility masks for a batch of contexts [B, N]."""
        return np.stack(
            [self.accessible_mask(c.path, c.theorem_pos) for c in contexts]
        )

    def get_accessible_premises(self, path: str, pos: Pos) -> PremiseSet:
        ps = PremiseSet()
        for idx in np.nonzero(self.accessible_mask(path, pos))[0]:
            ps.add(self.all_premises[int(idx)])
        return ps

    def get_accessible_premise_indexes(self, path: str, pos: Pos) -> List[int]:
        return [int(i) for i in np.nonzero(self.accessible_mask(path, pos))[0]]

    # ------------------------------------------------------------------ #
    # Nearest-premise query (host/NumPy exact path; device path in
    # reprover_tpu_torch.ops.topk + reprover_tpu_torch.retrieval.retriever)
    # ------------------------------------------------------------------ #

    def get_nearest_premises(
        self,
        premise_embeddings: np.ndarray,
        batch_context: Sequence[Context],
        batch_context_emb: np.ndarray,
        k: int,
    ) -> Tuple[List[List[Premise]], List[List[float]]]:
        """Batch nearest-neighbour search with accessibility filtering.

        Equivalent to `reference/common.py:299-326` (argsort then
        host-side filter) but vectorized: inaccessible similarities are set to
        ``-inf`` before a stable descending argsort, so the kept order equals
        filter-after-argsort. Raises ``ValueError`` if a query has fewer than
        ``k`` accessible premises, as the reference does.
        """
        premise_embeddings = np.asarray(premise_embeddings)
        batch_context_emb = np.asarray(batch_context_emb)
        similarities = batch_context_emb @ premise_embeddings.T  # [B, N]
        mask = self.accessible_mask_batch(batch_context)  # [B, N]
        if (mask.sum(axis=1) < k).any():
            raise ValueError(f"fewer than k={k} accessible premises for a query")
        masked = np.where(mask, similarities, -np.inf)
        # Stable sort on negated scores = descending, ties by original index.
        order = np.argsort(-masked, axis=1, kind="stable")[:, :k]
        results = [
            [self.all_premises[int(i)] for i in row] for row in order
        ]
        scores = [
            [float(similarities[b, int(i)]) for i in row]
            for b, row in enumerate(order)
        ]
        return results, scores


@dataclasses.dataclass(frozen=True)
class IndexedCorpus:
    """A corpus plus its premise embedding matrix (fp32, host memory).

    Replaces the reference's pickled artifact (`common.py:329-338`,
    `retrieval/index.py:37-40`) with a portable directory format:
    ``embeddings.npy`` + the source ``corpus.jsonl`` path recorded in
    ``meta.json`` (the jsonl itself is copied in for self-containment).
    """

    corpus: Corpus
    embeddings: np.ndarray

    def __post_init__(self) -> None:
        assert self.embeddings.ndim == 2
        assert len(self.embeddings) == len(self.corpus)

    def save(self, out_dir: str) -> None:
        import os
        import shutil

        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, "embeddings.npy"), self.embeddings)
        jsonl_dst = os.path.join(out_dir, "corpus.jsonl")
        if os.path.abspath(self.corpus.jsonl_path) != os.path.abspath(jsonl_dst):
            shutil.copyfile(self.corpus.jsonl_path, jsonl_dst)
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump(
                {
                    "num_premises": len(self.corpus),
                    "embedding_dim": int(self.embeddings.shape[1]),
                    "dtype": str(self.embeddings.dtype),
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "IndexedCorpus":
        import os

        embeddings = np.load(os.path.join(path, "embeddings.npy"))
        corpus = Corpus(os.path.join(path, "corpus.jsonl"))
        return cls(corpus=corpus, embeddings=embeddings)
