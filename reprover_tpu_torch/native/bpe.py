"""BPE tokenizer binding: C++ core via ctypes, pure-Python fallback. A copy
of :mod:`reprover_tpu.native.bpe` for the port.

Replaces the HF `tokenizers` Rust BPE used by the reference BM25 baseline
(`reference/retrieval/bm25/train_tokenizer.py:21-27`): Whitespace
pre-tokenization (\\w+|[^\\w\\s]+), BPE merges trained to a target vocab with
special tokens, unk mapping, encode -> token strings.

The shared library is compiled on demand from ``bpe.cpp`` (g++ -O3) into
``build/native/`` at the root of the checkout (listed in ``.gitignore``); if
no compiler is available the Python implementation (same algorithm, same
output) is used — tests assert the two agree.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "bpe.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_LIB = os.path.join(_BUILD, "libbpe.so")
_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(
                _SRC
            ):
                os.makedirs(_BUILD, exist_ok=True)
                # Build under a private name, then rename: processes that
                # build at the same time never load a half-written library.
                tmp = f"{_LIB}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _LIB)
            lib = ctypes.CDLL(_LIB)
            lib.bpe_new.restype = ctypes.c_void_p
            lib.bpe_free.argtypes = [ctypes.c_void_p]
            lib.bpe_train.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int64,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
            ]
            lib.bpe_vocab_size.argtypes = [ctypes.c_void_p]
            lib.bpe_vocab_size.restype = ctypes.c_int
            lib.bpe_get_token.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.bpe_get_token.restype = ctypes.c_char_p
            lib.bpe_encode.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int64,
            ]
            lib.bpe_encode.restype = ctypes.c_int64
            lib.bpe_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.bpe_save.restype = ctypes.c_int
            lib.bpe_load_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.bpe_load_file.restype = ctypes.c_int
            _lib = lib
        except Exception as ex:  # no g++, bad build, ...
            logger.warning("native BPE unavailable (%s); using Python fallback", ex)
            _lib_failed = True
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


# ------------------------------------------------------------------ #
# Pure-Python reference implementation (same algorithm/output)
# ------------------------------------------------------------------ #

import re

_WORD_RE = re.compile(r"\w+|[^\w\s]+", re.UNICODE)


def pre_tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(text)


class _PyBpe:
    def __init__(self) -> None:
        self.vocab: List[str] = []
        self.token_to_id: Dict[str, int] = {}
        self.merge_rank: Dict[Tuple[int, int], int] = {}
        self.unk_id = -1
        self._cache: Dict[str, List[int]] = {}

    def _add(self, tok: str) -> int:
        if tok in self.token_to_id:
            return self.token_to_id[tok]
        self.token_to_id[tok] = len(self.vocab)
        self.vocab.append(tok)
        return len(self.vocab) - 1

    def train(
        self, texts: Sequence[str], vocab_size: int, specials: Sequence[str]
    ) -> None:
        import heapq
        from collections import Counter, defaultdict

        for s in specials:
            self._add(s)
        self.unk_id = self.token_to_id.get("[UNK]", 0)

        word_freq: Counter = Counter()
        for t in texts:
            word_freq.update(pre_tokenize(t))

        words = []
        for w, f in word_freq.items():
            words.append([[self._add(ch) for ch in w], f])

        pair_count: Dict[Tuple[int, int], int] = defaultdict(int)
        pair_words: Dict[Tuple[int, int], set] = defaultdict(set)
        for wi, (syms, f) in enumerate(words):
            for a, b in zip(syms, syms[1:]):
                pair_count[(a, b)] += f
                pair_words[(a, b)].add(wi)

        def key(p):
            return (self.vocab[p[0]], self.vocab[p[1]])

        heap = [(-c, key(p), p) for p, c in pair_count.items()]
        heapq.heapify(heap)

        def bump(p, delta, wi):
            pair_count[p] += delta
            if delta > 0:
                pair_words[p].add(wi)
                heapq.heappush(heap, (-pair_count[p], key(p), p))

        while len(self.vocab) < vocab_size and heap:
            negc, _, best = heapq.heappop(heap)
            if pair_count.get(best, 0) != -negc or -negc < 1:
                continue
            merged = self.vocab[best[0]] + self.vocab[best[1]]
            merged_id = self._add(merged)
            self.merge_rank[best] = len(self.merge_rank)
            for wi in list(pair_words[best]):
                syms, f = words[wi]
                i = 0
                while i + 1 < len(syms):
                    if syms[i] == best[0] and syms[i + 1] == best[1]:
                        if i > 0:
                            bump((syms[i - 1], syms[i]), -f, wi)
                            bump((syms[i - 1], merged_id), f, wi)
                        if i + 2 < len(syms):
                            bump((syms[i + 1], syms[i + 2]), -f, wi)
                            bump((merged_id, syms[i + 2]), f, wi)
                        syms[i] = merged_id
                        del syms[i + 1]
                    else:
                        i += 1
            pair_count.pop(best, None)
            pair_words.pop(best, None)

    def encode_word(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids = [self.token_to_id.get(ch, -1) for ch in word]
        while len(ids) >= 2:
            best_rank, best_i = None, None
            for i in range(len(ids) - 1):
                if ids[i] < 0 or ids[i + 1] < 0:
                    continue
                r = self.merge_rank.get((ids[i], ids[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            merged = self.vocab[ids[best_i]] + self.vocab[ids[best_i + 1]]
            ids[best_i] = self.token_to_id[merged]
            del ids[best_i + 1]
        ids = [self.unk_id if i < 0 else i for i in ids]
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for w in pre_tokenize(text):
            out.extend(self.encode_word(w))
        return out


# ------------------------------------------------------------------ #
# Public tokenizer
# ------------------------------------------------------------------ #


class BpeTokenizer:
    """Trainable whitespace-BPE tokenizer (C++ core when available)."""

    def __init__(self, force_python: bool = False) -> None:
        self._lib = None if force_python else _load_lib()
        if self._lib is not None:
            self._h = self._lib.bpe_new()
            self._vocab_cache: Optional[List[str]] = None
        else:
            self._py = _PyBpe()

    def __del__(self) -> None:
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.bpe_free(self._h)
            self._h = None

    # -- training ---------------------------------------------------- #

    def train(
        self,
        texts: Sequence[str],
        vocab_size: int = 30000,
        specials: Sequence[str] = tuple(_SPECIALS),
    ) -> None:
        if self._lib is not None:
            enc = [t.encode("utf-8") for t in texts]
            arr = (ctypes.c_char_p * len(enc))(*enc)
            sp = [s.encode("utf-8") for s in specials]
            sp_arr = (ctypes.c_char_p * len(sp))(*sp)
            self._lib.bpe_train(
                self._h, arr, len(enc), vocab_size, sp_arr, len(sp)
            )
            self._vocab_cache = None
        else:
            self._py.train(texts, vocab_size, specials)

    # -- vocab ------------------------------------------------------- #

    @property
    def vocab(self) -> List[str]:
        if self._lib is not None:
            if self._vocab_cache is None:
                n = self._lib.bpe_vocab_size(self._h)
                self._vocab_cache = [
                    self._lib.bpe_get_token(self._h, i).decode("utf-8")
                    for i in range(n)
                ]
            return self._vocab_cache
        return self._py.vocab

    # -- encoding ---------------------------------------------------- #

    def encode_ids(self, text: str) -> List[int]:
        if self._lib is not None:
            data = text.encode("utf-8")
            cap = max(16, len(data) * 2)
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.bpe_encode(self._h, data, buf, cap)
            if n > cap:  # grow and retry
                buf = (ctypes.c_int32 * n)()
                n = self._lib.bpe_encode(self._h, data, buf, n)
            return list(buf[:n])
        return self._py.encode(text)

    def encode(self, text: str) -> List[str]:
        """Token strings, matching HF ``tokenizer.encode(x).tokens``
        (`bm25/main.py:46`)."""
        vocab = self.vocab
        return [vocab[i] for i in self.encode_ids(text)]

    # -- persistence -------------------------------------------------- #

    def save(self, path: str) -> None:
        if self._lib is not None:
            assert self._lib.bpe_save(self._h, path.encode("utf-8")) == 0
        else:
            import json

            with open(path, "w") as f:
                json.dump(
                    {
                        "vocab": self._py.vocab,
                        "merges": [
                            list(k)
                            for k, _ in sorted(
                                self._py.merge_rank.items(), key=lambda kv: kv[1]
                            )
                        ],
                        "unk_id": self._py.unk_id,
                        "format": "py-json",
                    },
                    f,
                )

    @classmethod
    def load(cls, path: str, force_python: bool = False) -> "BpeTokenizer":
        tok = cls(force_python=force_python)
        if tok._lib is not None:
            if tok._lib.bpe_load_file(tok._h, path.encode("utf-8")) == 0:
                return tok
            # fall back: maybe a Python-format file
            tok = cls(force_python=True)
        import json

        with open(path) as f:
            data = json.load(f)
        py = tok._py
        for t in data["vocab"]:
            py._add(t)
        for i, (a, b) in enumerate(data["merges"]):
            py.merge_rank[(a, b)] = i
        py.unk_id = data["unk_id"]
        return tok
