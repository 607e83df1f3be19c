"""Batched beam search with HF ``generate`` score semantics: the counterpart
of :mod:`reprover_tpu.generation.beam_search` (without beam groups).

Semantics as the JAX package has them (``do_sample=False``,
``early_stopping=False``):

- beams are ``[batch, num_beams]`` running sum-logprobs; each step takes the
  top ``2K`` (beam, token) candidates, the best ``K`` non-EOS ones continue,
  and EOS candidates ranked below ``K`` join a finished pool of ``K``;
- a batch row is done when its worst finished score can no longer be beaten
  by the best attainable continuation;
- scores are ``sum_logprobs / generated_len ** length_penalty`` with
  generated_len counting the EOS.

The ``lax.while_loop`` becomes a Python loop over device tensors; it stops
when every row is done or ``max_length`` is reached (one host read of the
done flags per step). Ties break toward the lowest (beam, token) index, as
``lax.top_k`` breaks them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from reprover_tpu_torch.ops.topk import stable_topk

NEG_INF = -1e9


def topk_candidates(
    cand: torch.Tensor, k2: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-``k2`` over the flattened (beam, token) candidates.

    ``cand`` is ``[B, K, V]``. A per-beam top-``min(k2, V)`` then a top-``k2``
    over the beam-major survivors gives the flat ``[B, K*V]`` top-k,
    including its tie order. Returns (scores ``[B, k2]`` descending, parent
    beam ``[B, k2]``, token ``[B, k2]``).
    """
    b, k, v = cand.shape
    m = min(k2, v)
    s1, i1 = stable_topk(cand, m)  # [B, K, m]
    scores, pos = stable_topk(s1.reshape(b, k * m), k2)
    parent = torch.div(pos, m, rounding_mode="floor")
    token = torch.gather(i1.reshape(b, k * m), 1, pos)
    return scores, parent, token


@dataclasses.dataclass(frozen=True)
class BeamSearchResult:
    """sequences ``[B, K, T]`` (start token first, EOS included when emitted,
    padded with pad_id), scores ``[B, K]`` (normalized, descending), and
    lengths ``[B, K]`` (token count incl. start and EOS)."""

    sequences: torch.Tensor
    scores: torch.Tensor
    lengths: torch.Tensor


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, j], ...]`` for ``x`` ``[B, K, ...]`` and ``idx`` ``[B, J]``."""
    idx = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def beam_search(
    step_fn: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, Any]],
    reorder_fn: Callable[[Any, torch.Tensor], Any],
    cache: Any,
    batch_size: int,
    num_beams: int,
    max_length: int,
    eos_id: int,
    pad_id: int,
    start_id: Any,  # int or [batch] int tensor
    length_penalty: float = 0.0,
    device: Any = "cpu",
) -> BeamSearchResult:
    """Run beam search.

    ``step_fn(cache, tokens[B*K]) -> (logits[B*K, V], cache)`` feeds the
    token at the current position; ``reorder_fn(cache, flat_parent[B*K])``
    makes row ``i`` of the incremental state follow row ``flat_parent[i]``.
    ``max_length`` counts the decoder start token (HF convention).
    """
    B, K, T = batch_size, num_beams, max_length
    dev = torch.device(device)
    start = torch.as_tensor(start_id, dtype=torch.long, device=dev).expand(B)

    def norm(sum_logprobs: torch.Tensor, gen_len: float) -> torch.Tensor:
        if length_penalty == 0.0:
            return sum_logprobs
        return sum_logprobs / (max(float(gen_len), 1.0) ** length_penalty)

    tokens = torch.full((B, K, T), pad_id, dtype=torch.long, device=dev)
    tokens[:, :, 0] = start[:, None]
    last_token = start[:, None].expand(B, K).contiguous()
    # Only the first beam is live initially, so the first expansion is unique.
    beam_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0
    fin_tokens = torch.full((B, K, T), pad_id, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    fin_lens = torch.zeros((B, K), dtype=torch.long, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    row_base = torch.arange(B, device=dev)[:, None] * K
    rank_ok = torch.arange(2 * K, device=dev)[None, :] < K  # HF drops worse-ranked EOS

    n = 1  # current sequence length, start token included
    while n < T:
        logits, cache = step_fn(cache, last_token.reshape(B * K))
        logp = torch.log_softmax(logits.float(), dim=-1)
        logp = logp.view(B, K, -1)

        cand_scores, parent, token = topk_candidates(beam_scores[:, :, None] + logp, 2 * K)
        is_eos = token == eos_id

        # Continuing beams: the best K non-EOS candidates.
        cont_scores, cont_pos = stable_topk(
            cand_scores.masked_fill(is_eos, NEG_INF), K
        )
        cont_parent = torch.gather(parent, 1, cont_pos)
        cont_token = torch.gather(token, 1, cont_pos)
        new_tokens = _gather_rows(tokens, cont_parent)
        new_tokens[:, :, n] = cont_token

        # Finished pool: EOS candidates ranked below K join it.
        eos_new_scores = torch.where(
            is_eos & rank_ok, norm(cand_scores, n), torch.full_like(cand_scores, NEG_INF)
        )
        eos_tokens = _gather_rows(tokens, parent)
        eos_tokens[:, :, n] = eos_id
        merged_scores = torch.cat([fin_scores, eos_new_scores], dim=1)
        merged_tokens = torch.cat([fin_tokens, eos_tokens], dim=1)
        merged_lens = torch.cat([fin_lens, torch.full_like(eos_new_scores, n + 1, dtype=torch.long)], dim=1)
        new_fin_scores, keep = stable_topk(merged_scores, K)
        new_fin_tokens = _gather_rows(merged_tokens, keep)
        new_fin_lens = torch.gather(merged_lens, 1, keep)

        # Termination heuristic (early_stopping=False).
        num_fin = (new_fin_scores > NEG_INF).sum(dim=1)
        best_attainable = norm(cand_scores[:, 0], n)
        newly_done = (num_fin >= K) & (new_fin_scores[:, K - 1] >= best_attainable)

        cache = reorder_fn(cache, (row_base + cont_parent).reshape(B * K))

        # Rows already done keep their state.
        d2 = done[:, None]
        d3 = done[:, None, None]
        tokens = torch.where(d3, tokens, new_tokens)
        last_token = torch.where(d2, last_token, cont_token)
        beam_scores = torch.where(d2, beam_scores, cont_scores)
        fin_tokens = torch.where(d3, fin_tokens, new_fin_tokens)
        fin_scores = torch.where(d2, fin_scores, new_fin_scores)
        fin_lens = torch.where(d2, fin_lens, new_fin_lens)
        done = done | newly_done
        n += 1
        if bool(done.all()):
            break

    # Rows not done merge their running beams as hypotheses
    # (generated_len = n - 1, no EOS — HF finalize semantics).
    run_scores = torch.where(
        done[:, None], torch.full_like(beam_scores, NEG_INF), norm(beam_scores, n - 1)
    )
    merged_scores = torch.cat([fin_scores, run_scores], dim=1)
    merged_tokens = torch.cat([fin_tokens, tokens], dim=1)
    merged_lens = torch.cat([fin_lens, torch.full_like(fin_lens, n)], dim=1)
    scores, keep = stable_topk(merged_scores, K)
    return BeamSearchResult(
        sequences=_gather_rows(merged_tokens, keep),
        scores=scores,
        lengths=torch.gather(merged_lens, 1, keep),
    )
