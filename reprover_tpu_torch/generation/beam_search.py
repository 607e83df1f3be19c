"""Batched beam search with HF ``generate`` score semantics: the counterpart
of :mod:`reprover_tpu.generation.beam_search`, grouped (diverse) search
included.

Semantics as the JAX package has them (``do_sample=False``,
``early_stopping=False``):

- beams are ``[batch, num_beams]`` running sum-logprobs; each step takes the
  top ``2K`` (beam, token) candidates, the best ``K`` non-EOS ones continue,
  and EOS candidates ranked below ``K`` join a finished pool of ``K``;
- a batch row is done when its worst finished score can no longer be beaten
  by the best attainable continuation;
- scores are ``sum_logprobs / generated_len ** length_penalty`` with
  generated_len counting the EOS.

Diverse beam search (HF ``num_beam_groups`` + ``diversity_penalty``: the
``HammingDiversityLogitsProcessor`` + ``_group_beam_search`` semantics)
splits each step's selection into ``G`` sequential groups of ``K/G`` beams:
group ``g``'s log-probs are penalized by ``diversity_penalty`` times the
per-token count of the tokens groups ``0..g-1`` just chose (a done group
counts ``K/G`` pads, as HF's dummy pads do); each group keeps its own
candidates, finished pool and done flag per batch row, and finalize merges
the groups. With one group the search is the classic one, token for token.

The ``lax.while_loop`` becomes a Python loop over device tensors (the groups
an inner loop); it stops when every (row, group) is done or ``max_length``
is reached (one host read of the done flags per step). Ties break toward
the lowest (beam, token) index, as ``lax.top_k`` breaks them.
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
    num_beam_groups: int = 1,
    diversity_penalty: float = 0.0,
) -> BeamSearchResult:
    """Run (optionally grouped, diverse) beam search.

    ``step_fn(cache, tokens[B*K]) -> (logits[B*K, V], cache)`` feeds the
    token at the current position; ``reorder_fn(cache, flat_parent[B*K])``
    makes row ``i`` of the incremental state follow row ``flat_parent[i]``.
    ``max_length`` counts the decoder start token (HF convention).

    ``num_beam_groups > 1`` is HF diverse beam search: ``num_beams`` must
    divide evenly, and group ``g`` is penalized by ``diversity_penalty`` per
    same-step token chosen by groups ``< g``.
    """
    B, K, T, G = batch_size, num_beams, max_length, num_beam_groups
    if K % G != 0:
        raise ValueError(f"num_beams={K} must be divisible by num_beam_groups={G}")
    Kg = K // G
    dev = torch.device(device)
    start = torch.as_tensor(start_id, dtype=torch.long, device=dev).expand(B)

    def norm(sum_logprobs: torch.Tensor, gen_len: float) -> torch.Tensor:
        if length_penalty == 0.0:
            return sum_logprobs
        return sum_logprobs / (max(float(gen_len), 1.0) ** length_penalty)

    tokens = torch.full((B, K, T), pad_id, dtype=torch.long, device=dev)
    tokens[:, :, 0] = start[:, None]
    last_token = start[:, None].expand(B, K).contiguous()
    # Only the first beam of each group is live initially, so each group's
    # first expansion is unique (HF sets beam scores to 0 at ::group_size).
    beam_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    beam_scores[:, ::Kg] = 0.0
    fin_tokens = torch.full((B, K, T), pad_id, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    fin_lens = torch.zeros((B, K), dtype=torch.long, device=dev)
    done = torch.zeros((B, G), dtype=torch.bool, device=dev)  # one HF BeamHypotheses each
    row_base = torch.arange(B, device=dev)[:, None] * K
    if G > 1:
        group_base = torch.arange(K, device=dev)[None, :] // Kg * Kg  # each beam's group's first

    def groups(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Each group's beams of ``x`` ``[B, K, ...]`` (``x`` itself for one
        group: the classic step takes no extra host operation)."""
        return (x,) if G == 1 else x.split(Kg, dim=1)

    def beam_done(done: torch.Tensor) -> torch.Tensor:
        """``[B, G]`` -> a mask over ``[B, K]``, each beam its group's flag
        (one group's ``[B, 1]`` broadcasts)."""
        return done if G == 1 else done[:, :, None].expand(B, G, Kg).reshape(B, K)

    rank_ok = torch.arange(2 * Kg, device=dev)[None, :] < Kg  # HF drops worse-ranked EOS
    diverse = G > 1 and diversity_penalty > 0.0

    n = 1  # current sequence length, start token included
    while n < T:
        logits, cache = step_fn(cache, last_token.reshape(B * K))
        logp = torch.log_softmax(logits.float(), dim=-1)
        V = logp.shape[-1]
        logp = logp.view(B, K, V)

        # Per-step token counts of the earlier groups' choices (Hamming
        # diversity); a done group counts Kg pads, as HF's dummy pads do.
        if diverse:
            freq = torch.zeros((B, V), dtype=torch.float32, device=dev)
            pad_freq = torch.zeros((V,), dtype=torch.float32, device=dev)
            pad_freq[pad_id] = float(Kg)
        outs = []
        # Groups are sequential by design: each sees the earlier ones' tokens.
        for g, (logp_g, scores_g, toks, fin_scores_g, fin_tokens_g, fin_lens_g) in enumerate(zip(
                groups(logp), groups(beam_scores), groups(tokens), groups(fin_scores),
                groups(fin_tokens), groups(fin_lens))):
            if diverse and g > 0:
                logp_g = logp_g - diversity_penalty * freq[:, None, :]
            cand_scores, parent, token = topk_candidates(scores_g[:, :, None] + logp_g, 2 * Kg)
            is_eos = token == eos_id

            # Continuing beams: the group's best Kg non-EOS candidates.
            cont_scores, cont_pos = stable_topk(cand_scores.masked_fill(is_eos, NEG_INF), Kg)
            cont_parent = torch.gather(parent, 1, cont_pos)
            cont_token = torch.gather(token, 1, cont_pos)
            new_tokens = _gather_rows(toks, cont_parent)
            new_tokens[:, :, n] = cont_token

            # Finished pool: EOS candidates ranked below Kg join the group's.
            eos_new_scores = torch.where(
                is_eos & rank_ok, norm(cand_scores, n), torch.full_like(cand_scores, NEG_INF))
            eos_tokens = _gather_rows(toks, parent)
            eos_tokens[:, :, n] = eos_id
            merged_scores = torch.cat([fin_scores_g, eos_new_scores], dim=1)
            merged_tokens = torch.cat([fin_tokens_g, eos_tokens], dim=1)
            merged_lens = torch.cat(
                [fin_lens_g, torch.full_like(eos_new_scores, n + 1, dtype=torch.long)], dim=1)
            new_fin_scores, keep = stable_topk(merged_scores, Kg)

            # Termination heuristic (early_stopping=False), per group: [B, 1].
            num_fin = (new_fin_scores > NEG_INF).sum(dim=1, keepdim=True)
            best_attainable = norm(cand_scores[:, :1], n)
            newly_done = (num_fin >= Kg) & (new_fin_scores[:, Kg - 1:Kg] >= best_attainable)

            if diverse and g < G - 1:
                picked = torch.zeros((B, V), dtype=torch.float32, device=dev).scatter_add_(
                    1, cont_token, torch.ones_like(cont_scores))
                freq = freq + torch.where(done[:, g, None], pad_freq, picked)

            outs.append((cont_scores, cont_parent, cont_token, new_tokens, new_fin_scores,
                         _gather_rows(merged_tokens, keep), torch.gather(merged_lens, 1, keep),
                         newly_done))

        # One group is the step's state as it stands; more are joined along
        # the beams, their parents shifted from group-local to global.
        (cont_scores, cont_parent, cont_token, new_tokens, new_fin_scores, new_fin_tokens,
         new_fin_lens, newly_done) = outs[0] if G == 1 else [torch.cat(p, 1) for p in zip(*outs)]
        if G > 1:
            cont_parent = cont_parent + group_base
        cache = reorder_fn(cache, (row_base + cont_parent).reshape(B * K))

        # (Row, group)s already done keep their state.
        d2 = beam_done(done)
        d3 = d2[:, :, None]
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

    # (Row, group)s not done merge their running beams as hypotheses
    # (generated_len = n - 1, no EOS: HF finalize semantics); the best K
    # across the groups are returned.
    d2 = beam_done(done)
    run_scores = torch.where(d2, torch.full_like(beam_scores, NEG_INF), norm(beam_scores, n - 1))
    merged_scores = torch.cat([fin_scores, run_scores], dim=1)
    merged_tokens = torch.cat([fin_tokens, tokens], dim=1)
    merged_lens = torch.cat([fin_lens, torch.full_like(fin_lens, n)], dim=1)
    scores, keep = stable_topk(merged_scores, K)
    return BeamSearchResult(
        sequences=_gather_rows(merged_tokens, keep),
        scores=scores,
        lengths=torch.gather(merged_lens, 1, keep),
    )
