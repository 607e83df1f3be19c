"""Premise retriever: the counterpart of
:class:`reprover_tpu.retrieval.PremiseRetriever` on one device.

- encoding = ByT5 encoder -> masked mean-pool -> L2 normalize;
- ``reindex_corpus`` embeds the corpus in length-sorted buckets (premises
  sorted by byte length, so each padded batch wastes little), keeping the
  embeddings on the device;
- ``retrieve_batch`` runs the masked cosine top-k on the device.

Any parameter update marks the corpus embeddings stale; queries re-index
lazily. Approximate top-k and mesh sharding are not ported.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from reprover_tpu_torch.data import Context, Corpus, IndexedCorpus, Pos, Premise
from reprover_tpu_torch.models.hf_import import load_hf_t5
from reprover_tpu_torch.models.t5 import (
    Params,
    T5Config,
    default_dtype,
    encode,
    fuse_mlp_params,
    place_params,
    resolve_device,
)
from reprover_tpu_torch.ops.pooling import masked_mean_normalize
from reprover_tpu_torch.ops.topk import cosine_topk
from reprover_tpu_torch.tokenizer import ByT5Tokenizer

APPROX_TODO = (
    "approximate top-k (--approx, lax.approx_max_k in the JAX package) is not "
    "ported: the port's retrieval is exact (ROADMAP.md Queue 1 item 3)"
)

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (corpus idxs, ids, mask)


class PremiseRetriever:
    """Dense premise retriever over a :class:`Corpus`."""

    def __init__(
        self,
        params: Params,
        cfg: T5Config,
        max_seq_len: int,
        num_retrieved: int = 100,
        bucket_multiple: int = 128,
    ) -> None:
        self.params = params
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        self.num_retrieved = num_retrieved
        self.bucket_multiple = bucket_multiple
        self.device = params["shared_embedding"].device
        self.tokenizer = ByT5Tokenizer()
        self.corpus: Optional[Corpus] = None
        self.corpus_embeddings: Optional[torch.Tensor] = None  # [N, D] fp32
        self.embeddings_staled = True
        # Premise text is fixed per corpus: the tokenized batches are reused
        # across reindexes (keyed by batch size; reset by load_corpus).
        self._token_cache: Optional[Tuple[int, List[Batch]]] = None

    @classmethod
    def load_hf(
        cls,
        ckpt_dir: str,
        max_seq_len: int,
        num_retrieved: int = 100,
        compute_dtype: Optional[torch.dtype] = None,
        approximate: bool = False,
        device: Any = "cuda",
    ) -> "PremiseRetriever":
        """Load an HF retriever checkpoint (encoder-only or full T5);
        ``compute_dtype`` defaults to bfloat16 on a card, float32 on the CPU."""
        if approximate:
            raise NotImplementedError(APPROX_TODO)
        dev = resolve_device(device)
        params, cfg = load_hf_t5(
            ckpt_dir, encoder_only=True, compute_dtype=compute_dtype or default_dtype(dev)
        )
        return cls(place_params(fuse_mlp_params(params), cfg, dev), cfg, max_seq_len, num_retrieved)

    @property
    def embedding_size(self) -> int:
        return self.cfg.d_model

    def load_corpus(self, source: Union[str, Corpus, IndexedCorpus]) -> None:
        """Bind a corpus: raw jsonl / Corpus (stale) or IndexedCorpus (fresh)."""
        if isinstance(source, IndexedCorpus):
            self.corpus = source.corpus
            self.corpus_embeddings = torch.as_tensor(
                np.asarray(source.embeddings, dtype=np.float32), device=self.device
            )
            self.embeddings_staled = False
            self._token_cache = None
            return
        if isinstance(source, Corpus):
            self.corpus = source
        elif source.endswith(".jsonl"):
            self.corpus = Corpus(source)
        else:
            self.load_corpus(IndexedCorpus.load(source))
            return
        self.corpus_embeddings = None
        self.embeddings_staled = True
        self._token_cache = None

    def mark_stale(self) -> None:
        """Call after any parameter update."""
        self.embeddings_staled = True

    # -------------------------------------------------------------- #
    # Encoding
    # -------------------------------------------------------------- #

    @torch.inference_mode()
    def _encode(self, input_ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        ids = torch.from_numpy(input_ids).to(self.device, torch.long)
        m = torch.from_numpy(mask).to(self.device)
        return masked_mean_normalize(encode(self.params, self.cfg, ids, m), m)

    def _encode_strings_device(self, texts: Sequence[str]) -> torch.Tensor:
        batch = self.tokenizer(
            texts, max_length=self.max_seq_len, bucket_multiple=self.bucket_multiple
        )
        return self._encode(batch.input_ids, batch.attention_mask)

    def encode_strings(self, texts: Sequence[str]) -> np.ndarray:
        """Embed a batch of strings -> unit-norm fp32 ``[B, D]`` (host array)."""
        return self._encode_strings_device(texts).cpu().numpy()

    def reindex_corpus(self, batch_size: int) -> None:
        """Re-embed every corpus premise (no-op unless stale)."""
        if not self.embeddings_staled:
            return
        if self.corpus is None:
            raise RuntimeError("load_corpus first")
        if self._token_cache is None or self._token_cache[0] != batch_size:
            serialized = [p.serialize() for p in self.corpus.all_premises]
            self._token_cache = (batch_size, self._tokenize_batches(serialized, batch_size))
        self.corpus_embeddings = self._embed_tokenized(
            self._token_cache[1], len(self.corpus.all_premises)
        )
        self.embeddings_staled = False

    def _tokenize_batches(self, texts: List[str], batch_size: int) -> List[Batch]:
        """Length-sorted bucketed tokenization -> ``[(idxs, ids, mask), ...]``."""
        order = np.argsort([len(t.encode("utf-8")) for t in texts], kind="stable")
        batches = []
        for lo in range(0, len(texts), batch_size):
            idxs = order[lo : lo + batch_size]
            batch = self.tokenizer(
                [texts[i] for i in idxs],
                max_length=self.max_seq_len,
                bucket_multiple=self.bucket_multiple,
            )
            batches.append((idxs, batch.input_ids, batch.attention_mask))
        return batches

    @torch.inference_mode()
    def _embed_tokenized(self, batches: List[Batch], n: int) -> torch.Tensor:
        """Embed pre-tokenized batches into a device ``[n, D]`` fp32 matrix in
        corpus order. Launches are asynchronous; nothing waits on the device
        until a caller reads the result."""
        out = torch.zeros((n, self.embedding_size), dtype=torch.float32, device=self.device)
        for idxs, ids, mask in batches:
            out[torch.from_numpy(idxs).to(self.device)] = self._encode(ids, mask)
        return out

    # -------------------------------------------------------------- #
    # Query
    # -------------------------------------------------------------- #

    def retrieve(
        self,
        state: str,
        file_name: str,
        theorem_full_name: str,
        theorem_pos: Pos,
        k: int,
    ) -> Tuple[List[Premise], List[float]]:
        """Single-query premise retrieval."""
        ctx = Context(file_name, theorem_full_name, Pos.of(theorem_pos), state)
        results, scores = self.retrieve_batch([ctx], k)
        return results[0], scores[0]

    def retrieve_batch(
        self, contexts: Sequence[Context], k: int
    ) -> Tuple[List[List[Premise]], List[List[float]]]:
        """Batched retrieval: encode queries + masked cosine top-k on the device."""
        if self.corpus is None:
            raise RuntimeError("load_corpus first")
        self.reindex_corpus(batch_size=32)
        if k > len(self.corpus):
            # Reference parity: requesting more than exist is the same error
            # as requesting more than are accessible.
            raise ValueError(f"fewer than k={k} accessible premises for a query")
        ctx_emb = self._encode_strings_device([c.serialize() for c in contexts])
        mask = torch.from_numpy(self.corpus.accessible_mask_batch(contexts)).to(self.device)
        values, indices = cosine_topk(ctx_emb, self.corpus_embeddings, mask, k)
        values = values.cpu().numpy()
        indices = indices.cpu().numpy()
        if not np.isfinite(values).all():
            raise ValueError(f"fewer than k={k} accessible premises for a query")
        results = [[self.corpus.all_premises[int(i)] for i in row] for row in indices]
        scores = [[float(v) for v in row] for row in values]
        return results, scores

    def to_indexed_corpus(self) -> IndexedCorpus:
        """Snapshot the (fresh) embeddings as a portable artifact."""
        if self.corpus is None or self.embeddings_staled:
            raise RuntimeError("to_indexed_corpus needs a corpus with fresh embeddings")
        return IndexedCorpus(self.corpus, self.corpus_embeddings.cpu().numpy())
