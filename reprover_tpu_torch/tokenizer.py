"""Byte-level (ByT5) tokenizer, pure Python/NumPy — no external deps.

ByT5 token ids are utf-8 bytes shifted by the number of special tokens:

- ``pad = 0``, ``eos = 1`` (``</s>``), ``unk = 2``; byte ``b`` -> id ``b + 3``
  (ids 3..258); 125 sentinel ``<extra_id_k>`` ids occupy 259..383 so the
  vocabulary size is 384.

Matches the behavior of HF ``ByT5Tokenizer`` as used by the reference
(`reference/retrieval/datamodule.py:135-141`): truncation reserves one
slot for the appended EOS, padding is to the longest sequence in the batch.

Batches are padded to a *bucketed* length (multiples of
``bucket_multiple``) rather than exactly-longest, so XLA compiles a small,
reusable set of program shapes instead of one per batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

PAD_ID = 0
EOS_ID = 1
UNK_ID = 2
BYTE_OFFSET = 3
NUM_BYTES = 256
NUM_EXTRA_IDS = 125
VOCAB_SIZE = BYTE_OFFSET + NUM_BYTES + NUM_EXTRA_IDS  # 384


@dataclasses.dataclass(frozen=True)
class TokenizedBatch:
    """A fixed-shape tokenized batch ready for device transfer."""

    input_ids: np.ndarray  # int32 [B, L]
    attention_mask: np.ndarray  # int32 [B, L]; 1 = real token, 0 = padding

    def __len__(self) -> int:
        return self.input_ids.shape[0]

    @property
    def seq_len(self) -> int:
        return self.input_ids.shape[1]


def round_to_bucket(n: int, multiple: int, max_len: Optional[int] = None) -> int:
    """Round ``n`` up to a multiple of ``multiple`` (clamped to ``max_len``)."""
    r = ((max(n, 1) + multiple - 1) // multiple) * multiple
    if max_len is not None:
        r = min(r, max_len)
    return r


class ByT5Tokenizer:
    """Byte-level tokenizer with ByT5 id conventions.

    ``encode``/``decode`` operate on single strings; ``__call__`` mirrors the
    HF tokenizer interface used throughout the reference: pad-to-longest (or
    bucketed), truncate at ``max_length`` (EOS always kept).
    """

    pad_token_id = PAD_ID
    eos_token_id = EOS_ID
    unk_token_id = UNK_ID
    vocab_size = VOCAB_SIZE

    def encode(
        self, text: str, max_length: Optional[int] = None, add_eos: bool = True
    ) -> List[int]:
        ids = [b + BYTE_OFFSET for b in text.encode("utf-8")]
        if add_eos:
            if max_length is not None and len(ids) > max_length - 1:
                ids = ids[: max_length - 1]
            ids.append(EOS_ID)
        elif max_length is not None and len(ids) > max_length:
            ids = ids[:max_length]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        bs = bytearray()
        for i in ids:
            i = int(i)
            if BYTE_OFFSET <= i < BYTE_OFFSET + NUM_BYTES:
                bs.append(i - BYTE_OFFSET)
            elif not skip_special_tokens:
                # Special ids have no byte representation; drop them but stop
                # at EOS to mirror greedy-decode termination.
                continue
        return bs.decode("utf-8", errors="ignore")

    def batch_decode(
        self, batch_ids: np.ndarray, skip_special_tokens: bool = True
    ) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in np.asarray(batch_ids)]

    def __call__(
        self,
        texts: Sequence[str],
        max_length: Optional[int] = None,
        bucket_multiple: int = 128,
        pad_to: Optional[int] = None,
    ) -> TokenizedBatch:
        """Tokenize a batch with bucketed padding.

        ``pad_to`` forces an exact padded length (used by fixed-shape serving
        paths); otherwise the longest sequence is rounded up to a multiple of
        ``bucket_multiple`` so XLA sees few distinct shapes.
        """
        seqs = [self.encode(t, max_length=max_length) for t in texts]
        longest = max(len(s) for s in seqs)
        if pad_to is not None:
            target = pad_to
        else:
            # Content is already truncated at max_length; the padded width may
            # exceed it so every batch is 128-aligned (e.g. the reference's
            # 2300-byte generator input pads to 2304, keeping the Pallas flash
            # encoder eligible). Extra columns are masked, hence inert.
            target = round_to_bucket(longest, bucket_multiple)
        input_ids = np.full((len(seqs), target), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(seqs), target), dtype=np.int32)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            mask[i, : len(s)] = 1
        return TokenizedBatch(input_ids=input_ids, attention_mask=mask)


def byte_length(s: str) -> int:
    """Length of ``s`` in utf-8 bytes (the ByT5 sequence-length unit)."""
    return len(s.encode("utf-8"))
