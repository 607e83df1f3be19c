"""Premise retriever: the counterpart of
:class:`reprover_tpu.retrieval.PremiseRetriever` on one device.

- encoding = ByT5 encoder -> masked mean-pool -> L2 normalize;
- ``reindex_corpus`` embeds the corpus in length-sorted buckets (premises
  sorted by byte length, so each padded batch wastes little), keeping the
  embeddings on the device;
- ``retrieve_batch`` runs the masked cosine top-k on the device.

Any parameter update marks the corpus embeddings stale; queries re-index
lazily. Under a data-parallel mesh (``mesh=``) each rank embeds every
``data``-th batch of the re-index and the embeddings are gathered, so every
rank holds the one-device index.

A re-index reports to the process's spans and counters
(``utils/profiling.py``), each at batch granularity or coarser. Spans:
``retriever.reindex`` (a call that re-embeds), inside it
``retriever.serialize``, ``retriever.tokenize``, per batch
``retriever.upload`` (the blocking copies of ids, mask and row indices to
the device) and ``retriever.encode`` (the enqueue of encode, pooling and the
rows' scatter), and under a mesh ``retriever.gather``. Counters:
``retriever.premises_prepared`` (serialised), and of the batches this
process embeds ``retriever.premises``, ``retriever.batches``,
``retriever.tokens_real`` (not padding) and ``retriever.tokens_padded``
(rows x padded length); ``retriever.token_cache_hits`` counts re-indexes
that reused the tokenized batches.
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
from reprover_tpu_torch.utils.profiling import count, span

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
        mesh: Any = None,
    ) -> None:
        self.params = params
        self.mesh = mesh if mesh is not None and mesh.spans("data") else None
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
        # across reindexes (keyed by batch size; reset by load_corpus), with
        # each batch's count of real tokens.
        self._token_cache: Optional[Tuple[int, List[Batch], List[int]]] = None

    @classmethod
    def load_hf(
        cls,
        ckpt_dir: str,
        max_seq_len: int,
        num_retrieved: int = 100,
        compute_dtype: Optional[torch.dtype] = None,
        approximate: bool = False,
        mesh: Any = None,
        device: Any = "cuda",
    ) -> "PremiseRetriever":
        """Load an HF retriever checkpoint (encoder-only or full T5);
        ``compute_dtype`` defaults to bfloat16 on a card, float32 on the CPU.
        ``mesh``: a data-parallel mesh to re-index over. ``approximate``
        (the JAX package's ``lax.approx_max_k``, recall target 0.99) is
        accepted and gives the exact top-k: XLA computes ``approx_max_k`` as
        the exact top-k, in ``lax.top_k``'s tie order, off a TPU, whose
        partial sort is the only source of its speed-up."""
        dev = resolve_device(device)
        params, cfg = load_hf_t5(
            ckpt_dir, encoder_only=True, compute_dtype=compute_dtype or default_dtype(dev)
        )
        return cls(place_params(fuse_mlp_params(params), cfg, dev), cfg, max_seq_len, num_retrieved,
                   mesh=mesh)

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
        return self._embed_device(*self._upload(input_ids, mask))

    def _upload(self, input_ids: np.ndarray, mask: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host ids and mask -> device ids (long) and mask (blocking copies)."""
        return (torch.from_numpy(input_ids).to(self.device, torch.long),
                torch.from_numpy(mask).to(self.device))

    def _embed_device(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Encode and pool device ids -> unit-norm fp32 ``[B, D]``."""
        return masked_mean_normalize(encode(self.params, self.cfg, ids, mask), mask)

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
        with span("retriever.reindex"):
            if self._token_cache is None or self._token_cache[0] != batch_size:
                with span("retriever.serialize"):
                    serialized = [p.serialize() for p in self.corpus.all_premises]
                count("retriever.premises_prepared", len(serialized))
                with span("retriever.tokenize"):
                    batches = self._tokenize_batches(serialized, batch_size)
                    real = [int(np.count_nonzero(mask)) for _, _, mask in batches]
                self._token_cache = (batch_size, batches, real)
            else:
                count("retriever.token_cache_hits")
            _, batches, real = self._token_cache
            self.corpus_embeddings = self._embed_tokenized(
                batches, real, len(self.corpus.all_premises))
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
    def _embed_tokenized(self, batches: List[Batch], real: List[int], n: int) -> torch.Tensor:
        """Embed pre-tokenized batches (``real``: each one's tokens that are
        not padding) into a device ``[n, D]`` fp32 matrix in corpus order.
        Launches are asynchronous; on one device nothing waits on it until a
        caller reads the result. Under a mesh this rank embeds every
        ``data``-th batch, a failure on any rank raises on every rank, and the
        rows are gathered (each is written by one rank: the sum is exact)."""
        from reprover_tpu_torch.parallel.collectives import global_sum, raise_everywhere

        out = torch.zeros((n, self.embedding_size), dtype=torch.float32, device=self.device)
        mine = range(len(batches))
        if self.mesh is None:
            for i in mine:
                self._embed_batch(out, *batches[i])
        else:
            mine = mine[self.mesh.coord("data")::self.mesh.shape["data"]]
            failed = True
            try:
                for i in mine:
                    self._embed_batch(out, *batches[i])
                failed = False
            finally:
                raise_everywhere(self.mesh, failed, "re-indexing")
        count("retriever.batches", len(mine))
        count("retriever.premises", sum(len(batches[i][0]) for i in mine))
        count("retriever.tokens_real", sum(real[i] for i in mine))
        count("retriever.tokens_padded", sum(batches[i][1].size for i in mine))
        if self.mesh is None:
            return out
        with span("retriever.gather"):
            return global_sum(out, self.mesh)

    def _embed_batch(self, out: torch.Tensor, idxs: np.ndarray, ids: np.ndarray,
                     mask: np.ndarray) -> None:
        """``out[idxs] = self._encode(ids, mask)`` in the order Python runs
        it (ids and mask up, encode and pool, the rows' indices up, the
        scatter), each copy under the ``retriever.upload`` span and each
        enqueue under ``retriever.encode``."""
        with span("retriever.upload"):
            ids_d, mask_d = self._upload(ids, mask)
        with span("retriever.encode"):
            emb = self._embed_device(ids_d, mask_d)
        with span("retriever.upload"):
            rows = torch.from_numpy(idxs).to(self.device)
        with span("retriever.encode"):
            out[rows] = emb

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
