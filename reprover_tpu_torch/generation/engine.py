"""Token-level continuous batching: a slot-based stepwise beam engine, the
counterpart of :mod:`reprover_tpu.generation.engine`.

The reference shares one vLLM ``AsyncLLMEngine`` across all prover actors,
so requests join the running batch at token granularity. Here:

- the device state is ``num_slots`` independent beam searches (K beams each)
  advanced together by run-until-event chunks: a loop that stops the moment
  a slot newly finishes, or after ``max_steps``;
- between chunks the host admits arrival waves into free slots (tokenize,
  encode, install) and emits finished slots from the finalize payload that
  rides along with each status;
- each slot has its own decode position: the current token's K/V are
  attended as a lazily appended column and installed by the beam reorder,
  and the T5 relative-position bias is computed per slot;
- cross-attention K/V are stored once per slot, not per beam row.

Beam semantics are those of :mod:`reprover_tpu_torch.generation.beam_search`
(HF ``generate``, ``do_sample=False``, ``early_stopping=False``) with the
scalar position generalized to a ``[num_slots]`` vector.

From JAX to PyTorch: the JAX package runs each chunk as one jitted
``while_loop`` over a donated state; here a chunk is a Python loop over
tensors on the card that are updated in place, reading one small device
flag per step (the loop's condition). The permutation of the per-beam
caches cannot be done in place, so in ``"gather"`` mode (kernel 13,
:mod:`reprover_tpu_torch.ops.beam_reorder`) the engine keeps a second
buffer for each cache, allocated once, and swaps the two every step;
``"einsum"`` and ``"scan"`` stay plain PyTorch, as XLA computed them in the
JAX package. Length buckets (``step_buckets``) are views of the full
buffers, so nothing is sliced or restored. Each status vector is copied to
pinned host memory without blocking, with a CUDA event that
:meth:`StepwiseEngineBase.unpack_status` waits on.

Tensor parallelism (``mesh`` with ``model`` > 1, the reference's vLLM
``tensor_parallel_size``): each rank holds its Megatron part of the
parameters (bridged or quantized, ``kernel_ok`` kept) and the KV caches at
its local heads; the beam bookkeeping is replicated and the same on every
rank, since every rank sees the gathered logits. JAX has one controller for
all devices; here every rank is a process, so the grid's first rank owns
the host API and, before each call that changes the state (admission,
dispatch, finalize, release, reset), sends the call and its host inputs
over the mesh's gloo ``control`` group; the other ranks run :meth:`follow`,
which executes the same calls in the same order on their shards. After
each such call the ranks exchange whether it raised, so a call that fails
on any rank raises on every rank; at the end of each chunk they exchange
their steps, ``n`` and ``done``, and a disagreement raises on every rank
instead of diverging silently. Each rank reads its own loop flag per step:
the flags agree because the bookkeeping they read is bit-identical. A rank
that fails between two of a call's collectives leaves the others waiting
in the next one until the process group's timeout. Unlike the JAX package, which turns its Pallas kernels off under
a mesh, each rank runs the kernels on its shards as one card does, the
``gather`` reorder (kernel 13) included.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reprover_tpu_torch.generation.beam_search import _gather_rows, topk_candidates
from reprover_tpu_torch.models.quantize import quantize_t5_params, resolve_quantize_bits
from reprover_tpu_torch.models.t5 import (
    Elementwise,
    Params,
    T5Config,
    _decoder_norms,
    _dense,
    _fuses,
    _layer_stack,
    _lm_logits,
    _mlp_block,
    _split_heads,
    encode,
    head_bias,
    layer_params,
    local_heads,
    relative_position_bucket,
)
from reprover_tpu_torch.ops.beam_reorder import parent_effective, reorder_append_gather
from reprover_tpu_torch.ops.topk import stable_topk
from reprover_tpu_torch.parallel.collectives import raise_everywhere, reduce_from_model
from reprover_tpu_torch.parallel.sharding import shard_for_model

logger = logging.getLogger(__name__)

NEG_INF = -1e9


class HostCopy:
    """A device tensor's copy to pinned host memory, in flight: the copy is
    queued without blocking and a CUDA event marks its end; ``np.asarray``
    waits on the event. A CPU tensor is copied at once."""

    def __init__(self, t: torch.Tensor) -> None:
        self._event: Optional[torch.cuda.Event] = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.detach().clone()

    def __array__(self, dtype: Any = None, copy: Any = None) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        arr = self._host.numpy()
        return arr if dtype is None else arr.astype(dtype)


# ------------------------------------------------------------------ #
# Engine state
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class EngineState:
    """Device state of ``num_slots`` concurrent beam searches (S slots, K
    beams, T = max decode length incl. start, Ld decoder layers, Smax the
    encoder length bucket)."""

    self_k: torch.Tensor  # [Ld, S, K, H, T, d]
    self_v: torch.Tensor  # [Ld, S, K, H, T, d]
    cross_k: torch.Tensor  # [Ld, S, H, Smax, d], shared across beams
    cross_v: torch.Tensor  # [Ld, S, H, Smax, d]
    cross_bias: torch.Tensor  # [S, 1, 1, Smax] fp32 additive
    n: torch.Tensor  # [S] int64, current length incl. start token
    tokens: torch.Tensor  # [S, K, T] int64
    last_token: torch.Tensor  # [S, K] int64
    beam_scores: torch.Tensor  # [S, K] fp32
    fin_tokens: torch.Tensor  # [S, K, T] int64
    fin_scores: torch.Tensor  # [S, K] fp32
    fin_lens: torch.Tensor  # [S, K] int64
    done: torch.Tensor  # [S] bool, beam search finished
    active: torch.Tensor  # [S] bool, slot occupied


def _beam_fields(num_slots: int, num_beams: int, max_decode_len: int, pad_id: int,
                 start_id: int, device: torch.device) -> Dict[str, torch.Tensor]:
    S, K, T = num_slots, num_beams, max_decode_len
    return dict(
        n=torch.ones((S,), dtype=torch.long, device=device),
        tokens=torch.full((S, K, T), pad_id, dtype=torch.long, device=device),
        last_token=torch.full((S, K), start_id, dtype=torch.long, device=device),
        beam_scores=torch.zeros((S, K), dtype=torch.float32, device=device),
        fin_tokens=torch.full((S, K, T), pad_id, dtype=torch.long, device=device),
        fin_scores=torch.full((S, K), NEG_INF, dtype=torch.float32, device=device),
        fin_lens=torch.zeros((S, K), dtype=torch.long, device=device),
        done=torch.zeros((S,), dtype=torch.bool, device=device),
        active=torch.zeros((S,), dtype=torch.bool, device=device),
    )


def init_engine_state(
    params: Params, cfg: T5Config, num_slots: int, num_beams: int, max_src_len: int,
    max_decode_len: int,
) -> EngineState:
    S, K, T = num_slots, num_beams, max_decode_len
    ld, d = cfg.num_decoder_layers, cfg.d_kv
    h = local_heads(params["decoder"]["layers"]["self_attn"]["q"], cfg)
    dt, dev = cfg.compute_dtype, params["decoder"]["final_norm"].device
    return EngineState(
        self_k=torch.zeros((ld, S, K, h, T, d), dtype=dt, device=dev),
        self_v=torch.zeros((ld, S, K, h, T, d), dtype=dt, device=dev),
        cross_k=torch.zeros((ld, S, h, max_src_len, d), dtype=dt, device=dev),
        cross_v=torch.zeros((ld, S, h, max_src_len, d), dtype=dt, device=dev),
        cross_bias=torch.full((S, 1, 1, max_src_len), -1e10, dtype=torch.float32, device=dev),
        **_beam_fields(S, K, T, cfg.pad_token_id, cfg.decoder_start_token_id, dev),
    )


def reset_slots(state: Any, idx: torch.Tensor, pad_id: int, start: Any) -> None:
    """Arm the beams of slots ``idx`` (in place): n = 1, the start token
    (an int or an ``[A]`` tensor), only the first beam live, empty pool."""
    K = state.beam_scores.shape[1]
    beam0 = torch.full((K,), NEG_INF, dtype=torch.float32, device=idx.device)
    beam0[0] = 0.0
    state.n[idx] = 1
    state.tokens[idx] = pad_id
    start_t = torch.as_tensor(start, dtype=torch.long, device=idx.device)
    state.last_token[idx] = start_t.reshape(-1, 1).expand(len(idx), K)
    state.beam_scores[idx] = beam0
    state.fin_tokens[idx] = pad_id
    state.fin_scores[idx] = NEG_INF
    state.fin_lens[idx] = 0
    state.done[idx] = False
    state.active[idx] = True


# ------------------------------------------------------------------ #
# Decoder step with per-slot positions
# ------------------------------------------------------------------ #


def _grouped_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """q ``[S, K, H, 1, d]`` over per-slot kv ``[S, H, Tk, d]`` (+ bias
    ``[S, 1, 1, Tk]``) -> ``[S, K, H, 1, d]``: the beams of a slot attend as
    one ``[H, K, Tk]`` block."""
    S, K, H, _, d = q.shape
    qs = q.reshape(S, K, H, d).transpose(1, 2)  # [S, H, K, d]
    scores = torch.matmul(qs.to(dtype), k.to(dtype).transpose(-1, -2)).float() + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.matmul(probs, v.to(dtype))  # [S, H, K, d]
    return out.transpose(1, 2).reshape(S, K, H, 1, d)


def _engine_decode_step(
    params: Params, cfg: T5Config, state: EngineState, t_live: int, mesh: Any = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder step for every (slot, beam) over the first ``t_live``
    cache columns -> (logits ``[S, K, V]`` fp32, k_news, v_news
    ``[Ld, S, K, H, 1, d]``; H this rank's heads under tensor parallelism,
    whose row-parallel products are summed over ``model``).

    Lazy append: the current token's K/V are not written into the cache;
    attention runs over the old cache (columns strictly before the
    position) plus the fresh column as an appended score, and the beam
    reorder installs the column."""
    dt = cfg.compute_dtype
    dec = params["decoder"]
    S, K = state.last_token.shape
    T = t_live
    H, d = local_heads(dec["layers"]["self_attn"]["q"], cfg), cfg.d_kv
    rel_bias = head_bias(dec["rel_bias"], H, mesh)
    dev = state.n.device
    pos = state.n - 1  # position of the token being fed

    h = params["shared_embedding"].to(dt)[state.last_token][:, :, None, :]  # [S, K, 1, D]

    key_positions = torch.arange(T, device=dev)
    rel = key_positions[None, :] - pos[:, None]  # [S, T]
    buckets = relative_position_bucket(
        rel, False, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)
    self_bias = rel_bias.float()[buckets.long()].permute(0, 2, 1)[:, None, :, None, :]
    valid = (key_positions[None, :] < pos[:, None])[:, None, None, None, :]
    self_bias = torch.where(valid, self_bias, torch.full_like(self_bias, -1e10))  # [S,1,H,1,T]
    bucket0 = relative_position_bucket(
        torch.zeros((1, 1), dtype=torch.long, device=dev), False,
        cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)[0, 0]
    bias0 = rel_bias[bucket0].float().reshape(1, 1, H, 1, 1)

    def proj(x: torch.Tensor, w: Any) -> torch.Tensor:  # [S,K,1,D] -> [S,K,H,1,d]
        y = _dense(x.reshape(S * K, 1, -1), w, dt)
        return _split_heads(y, H, d).reshape(S, K, H, 1, d)

    def merge(attn: torch.Tensor) -> torch.Tensor:  # [S,K,H,1,d] -> [S*K,1,H*d]
        return attn.permute(0, 1, 3, 2, 4).reshape(S * K, 1, H * d)

    k_news, v_news = [], []

    def block(h: torch.Tensor, delta: Optional[torch.Tensor], i: int, ew: Elementwise
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        lp = layer_params(dec["layers"], i)
        k_cache = state.self_k[i, :, :, :, :T]  # [S, K, H, T, d]
        v_cache = state.self_v[i, :, :, :, :T]

        h, nrm = ew.add_norm(h, delta, lp["self_norm"])
        q = proj(nrm, lp["self_attn"]["q"])
        k_new = proj(nrm, lp["self_attn"]["k"])
        v_new = proj(nrm, lp["self_attn"]["v"])
        s_cache = torch.matmul(q.to(dt), k_cache.to(dt).transpose(-1, -2)).float() + self_bias
        s_new = torch.matmul(q.to(dt), k_new.to(dt).transpose(-1, -2)).float() + bias0
        probs = torch.softmax(torch.cat([s_cache, s_new], dim=-1), dim=-1).to(dt)
        attn = (
            torch.matmul(probs[..., :T], v_cache.to(dt)).float()
            + probs[..., T:].float() * v_new.float()
        ).to(dt)
        out = reduce_from_model(_dense(merge(attn), lp["self_attn"]["o"], dt), mesh)
        h, nrm = ew.add_norm(h, out.reshape(S, K, 1, -1), lp["cross_norm"])
        q = proj(nrm, lp["cross_attn"]["q"])
        attn = _grouped_attention(q, state.cross_k[i], state.cross_v[i], state.cross_bias, dt)
        out = reduce_from_model(_dense(merge(attn), lp["cross_attn"]["o"], dt), mesh)
        h, nrm = ew.add_norm(h, out.reshape(S, K, 1, -1), lp["mlp_norm"])
        k_news.append(k_new.to(state.self_k.dtype))
        v_news.append(v_new.to(state.self_v.dtype))
        return h, _mlp_block(nrm, lp["mlp"], cfg, mesh, ew.gated)

    fused = _fuses(h, _decoder_norms(dec), dec["layers"]["mlp"])
    h = _layer_stack(block, range(cfg.num_decoder_layers), h, dec["final_norm"], cfg, fused)
    logits = _lm_logits(params, cfg, h.reshape(S * K, 1, -1), mesh)[:, 0, :]
    return logits.reshape(S, K, -1), torch.stack(k_news), torch.stack(v_news)


# ------------------------------------------------------------------ #
# One beam-search step over all slots (per-slot n)
# ------------------------------------------------------------------ #


def _norm_scores(sum_logprobs: torch.Tensor, gen_len: torch.Tensor, length_penalty: float
                 ) -> torch.Tensor:
    if length_penalty == 0.0:
        return sum_logprobs
    return sum_logprobs / torch.pow(gen_len.float().clamp_min(1.0), length_penalty)


def advance_beams(
    state: Any, logits: torch.Tensor, length_penalty: float, eos_id: int
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Model-agnostic beam-search advance over all slots: the classic loop
    body with the scalar position ``n`` made per-slot. ``state`` is any
    object with the beam fields (n, tokens, last_token, beam_scores, fin_*,
    done, active). Returns (updated beam fields incl. freezing, cont_parent
    ``[S, K]`` for the caller's cache reorder, frozen ``[S]``)."""
    S, K, T = state.tokens.shape
    n = state.n
    dev = n.device
    logp = torch.log_softmax(logits.float(), dim=-1)

    cand_scores, parent, token = topk_candidates(state.beam_scores[:, :, None] + logp, 2 * K)
    is_eos = token == eos_id
    cont_scores, cont_pos = stable_topk(cand_scores.masked_fill(is_eos, NEG_INF), K)
    cont_parent = torch.gather(parent, 1, cont_pos)
    cont_token = torch.gather(token, 1, cont_pos)

    write_oh = (torch.arange(T, device=dev)[None, :] == n[:, None])[:, None, :]  # [S, 1, T]
    new_tokens = torch.where(write_oh, cont_token[:, :, None],
                             _gather_rows(state.tokens, cont_parent))

    rank_ok = torch.arange(2 * K, device=dev)[None, :] < K
    eos_new_scores = torch.where(
        is_eos & rank_ok, _norm_scores(cand_scores, n[:, None], length_penalty),
        torch.full_like(cand_scores, NEG_INF))
    eos_tokens = torch.where(write_oh, torch.full_like(state.tokens[:, :1], eos_id),
                             _gather_rows(state.tokens, parent))

    merged_scores = torch.cat([state.fin_scores, eos_new_scores], dim=1)
    merged_tokens = torch.cat([state.fin_tokens, eos_tokens], dim=1)
    merged_lens = torch.cat([state.fin_lens, (n + 1)[:, None].expand(S, 2 * K)], dim=1)
    fin_scores, keep = stable_topk(merged_scores, K)
    fin_tokens = _gather_rows(merged_tokens, keep)
    fin_lens = torch.gather(merged_lens, 1, keep)

    num_fin = (fin_scores > NEG_INF).sum(dim=1)
    best_attainable = _norm_scores(cand_scores[:, 0], n, length_penalty)
    newly_done = (num_fin >= K) & (fin_scores[:, K - 1] >= best_attainable)

    # Freeze finished, vacant and length-capped slots (the classic loop's
    # ``n < T``: chunked stepping would otherwise overshoot).
    frozen = state.done | ~state.active | (n >= T)

    def keep_old(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
        return torch.where(frozen.view((S,) + (1,) * (new.dim() - 1)), old, new)

    updates = dict(
        n=torch.where(frozen, n, n + 1),
        tokens=keep_old(state.tokens, new_tokens),
        last_token=keep_old(state.last_token, cont_token),
        beam_scores=keep_old(state.beam_scores, cont_scores),
        fin_tokens=keep_old(state.fin_tokens, fin_tokens),
        fin_scores=keep_old(state.fin_scores, fin_scores),
        fin_lens=keep_old(state.fin_lens, fin_lens),
        done=state.done | (state.active & newly_done),
    )
    return updates, cont_parent, frozen


def _one_hot_parents(cont_parent: torch.Tensor, frozen: torch.Tensor, dtype: torch.dtype
                     ) -> torch.Tensor:
    K = cont_parent.shape[1]
    return torch.nn.functional.one_hot(parent_effective(cont_parent, frozen), K).to(dtype)


def _at_pos(T: int, pos: torch.Tensor) -> torch.Tensor:
    return torch.arange(T, device=pos.device).reshape(1, 1, 1, 1, T, 1) == pos.reshape(
        1, -1, 1, 1, 1, 1)


def reorder_append(
    cache: torch.Tensor, new_col: torch.Tensor, cont_parent: torch.Tensor,
    frozen: torch.Tensor, pos: torch.Tensor,
) -> torch.Tensor:
    """Permute a per-beam cache ``[L, S, K, H, T, d]`` by beam parents and
    install the current step's column: the one-hot product (exact: one
    nonzero term per output) with the column select in its epilogue."""
    P = _one_hot_parents(cont_parent, frozen, cache.dtype)  # [S, Knew, Kold]
    permuted = torch.einsum("sij,lsjhtd->lsihtd", P, cache)
    col = torch.einsum("sij,lsjhtd->lsihtd", P, new_col)
    return torch.where(_at_pos(cache.shape[4], pos), col, permuted)


def reorder_append_scan(
    k_cache: torch.Tensor, v_cache: torch.Tensor, k_col: torch.Tensor, v_col: torch.Tensor,
    cont_parent: torch.Tensor, frozen: torch.Tensor, pos: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer-blocked :func:`reorder_append`, in place: layer ``l``'s output
    depends only on layer ``l``'s input, so each layer is reordered into a
    layer-sized temporary and written back (one layer of extra memory
    instead of a second cache)."""
    P = _one_hot_parents(cont_parent, frozen, k_cache.dtype)
    at_pos = _at_pos(k_cache.shape[4], pos)[0]  # [S, 1, 1, T, 1]
    for cache, col in ((k_cache, k_col), (v_cache, v_col)):
        for layer in range(cache.shape[0]):
            permuted = torch.einsum("sij,sjhtd->sihtd", P, cache[layer])
            colp = torch.einsum("sij,sjhtd->sihtd", P, col[layer])
            cache[layer] = torch.where(at_pos, colp, permuted)
    return k_cache, v_cache


REORDER_MODES = ("auto", "einsum", "gather", "scan")

#: ``reorder_mode="auto"`` threshold: total self-KV cache bytes at or above
#: which the layer-blocked in-place reorder ("scan") replaces the
#: whole-cache one-hot einsum. The JAX package's value, calibrated on a TPU
#: v5e; kept for parity (PERF.md records how the modes compare on the card).
AUTO_SCAN_CACHE_BYTES = 1 << 30


def resolve_reorder_mode(reorder_mode: str, total_cache_bytes: int) -> str:
    """Resolve ``"auto"`` from the total KV-cache footprint (see
    :data:`AUTO_SCAN_CACHE_BYTES`)."""
    if reorder_mode != "auto":
        return reorder_mode
    return "scan" if total_cache_bytes >= AUTO_SCAN_CACHE_BYTES else "einsum"


def _reorder_both(
    state: Any, fields: Tuple[str, str], k_col: torch.Tensor, v_col: torch.Tensor,
    cont_parent: torch.Tensor, frozen: torch.Tensor, pos: torch.Tensor, reorder_mode: str,
    t_live: int, spare: Optional[Dict[str, torch.Tensor]],
) -> None:
    """Reorder + append both per-beam caches of ``state`` (fields ``fields``)
    over their first ``t_live`` columns, in place: ``"gather"`` writes into
    the ``spare`` buffers and swaps them with the state's; ``"scan"``
    rewrites layer by layer; ``"einsum"`` computes new caches and writes
    them back."""
    kf, vf = fields
    k_full, v_full = getattr(state, kf), getattr(state, vf)
    T = k_full.shape[4]
    k_cache, v_cache = k_full[:, :, :, :, :t_live], v_full[:, :, :, :, :t_live]
    mode = resolve_reorder_mode(
        reorder_mode, (k_cache.numel() + v_cache.numel()) * k_cache.element_size())
    if mode == "gather":
        if spare is None:
            spare = {}
        out_k = spare.get(kf)
        if out_k is None or out_k.shape != k_full.shape:
            # Zeros, not empty: columns past a bucket are scored (and masked)
            # by later steps, so they must hold finite values.
            out_k, out_v = torch.zeros_like(k_full), torch.zeros_like(v_full)
        else:
            out_v = spare[vf]
        reorder_append_gather(k_cache, v_cache, k_col, v_col, cont_parent, frozen, pos,
                              out_k[:, :, :, :, :t_live], out_v[:, :, :, :, :t_live])
        spare[kf], spare[vf] = k_full, v_full
        setattr(state, kf, out_k)
        setattr(state, vf, out_v)
    elif mode == "scan":
        reorder_append_scan(k_cache, v_cache, k_col, v_col, cont_parent, frozen, pos)
    elif mode == "einsum":
        new_k = reorder_append(k_cache, k_col, cont_parent, frozen, pos)
        new_v = reorder_append(v_cache, v_col, cont_parent, frozen, pos)
        if t_live == T:
            setattr(state, kf, new_k)
            setattr(state, vf, new_v)
        else:
            k_cache.copy_(new_k)
            v_cache.copy_(new_v)
    else:
        raise ValueError(f"reorder_mode must be one of {REORDER_MODES}: {reorder_mode!r}")


def apply_step(
    state: Any, fields: Tuple[str, str], logits: torch.Tensor, k_news: torch.Tensor,
    v_news: torch.Tensor, length_penalty: float, eos_id: int, reorder_mode: str, t_live: int,
    spare: Optional[Dict[str, torch.Tensor]] = None,
) -> None:
    """Advance the beams from ``logits`` and reorder + append the caches, in
    place (shared by the T5 and decoder-only engines)."""
    updates, cont_parent, frozen = advance_beams(state, logits, length_penalty, eos_id)
    _reorder_both(state, fields, k_news, v_news, cont_parent, frozen, state.n - 1,
                  reorder_mode, t_live, spare)
    for name, value in updates.items():
        setattr(state, name, value)


def engine_step(
    params: Params, cfg: T5Config, state: EngineState, length_penalty: float,
    reorder_mode: str = "auto", t_live: Optional[int] = None,
    spare: Optional[Dict[str, torch.Tensor]] = None, mesh: Any = None,
) -> EngineState:
    """Advance every active, unfinished slot by one token (in place; the
    state is returned). ``reorder_mode``: ``"auto"`` (einsum below
    :data:`AUTO_SCAN_CACHE_BYTES` of KV cache, scan at or above it),
    ``"einsum"``, ``"scan"`` or ``"gather"`` (kernel 13)."""
    t_live = t_live or state.self_k.shape[4]
    logits, k_news, v_news = _engine_decode_step(params, cfg, state, t_live, mesh)
    apply_step(state, ("self_k", "self_v"), logits, k_news, v_news, length_penalty,
               cfg.eos_token_id, reorder_mode, t_live, spare)
    return state


# ------------------------------------------------------------------ #
# Host-facing engine
# ------------------------------------------------------------------ #


def _to_host(x: Any) -> Any:
    """A call's argument as the control group carries it: tensors on the
    CPU, sequences item by item."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def replicated(method: Callable[..., Any]) -> Callable[..., Any]:
    """A host call that changes a tensor-parallel engine's state: the
    leader sends it to the followers before running it; a follower runs it
    only from :meth:`StepwiseEngineBase.follow`. Calls it makes itself are
    not sent again. Afterwards every rank learns whether it raised on any
    rank, and raises if it did."""

    @functools.wraps(method)
    def call(self: "StepwiseEngineBase", *args: Any, **kwargs: Any) -> Any:
        if self._control is None or self._in_call:
            return method(self, *args, **kwargs)
        if self.mesh.is_leader:
            self._send((method.__name__, _to_host(args), _to_host(kwargs)))
        elif not self._following:
            raise RuntimeError(f"{method.__name__}: rank {self.mesh.coords} of a "
                               "tensor-parallel engine runs the leader's calls (follow())")
        self._in_call = True
        try:
            result = method(self, *args, **kwargs)
        except Exception:
            raise_everywhere(self.mesh, True, method.__name__)
            raise
        finally:
            self._in_call = False
        raise_everywhere(self.mesh, False, method.__name__)
        return result

    return call


class StepwiseEngineBase:
    """Shared slot/beam machinery for continuous-batching engines.

    Owns the run-until-event, admission and finalize programs and the host
    API; subclasses provide the model-specific decode step
    (``_step_program``), wave admission (``_admit_program``) and blank
    state (``_init_state``)."""

    #: State fields holding the per-beam KV caches ``[L, S, K, H, T, d]``
    #: (the tensors ``step_buckets`` cut to a prefix and the reorder moves).
    _bucket_cache_fields: Tuple[str, ...] = ()

    def __init__(
        self,
        params: Params,
        num_slots: int,
        num_beams: int,
        max_src_len: int,
        max_decode_len: int,
        length_penalty: float = 0.0,
        chunk_size: int = 8,
        mesh: Any = None,
        step_buckets: Optional[Sequence[int]] = None,
        reorder_mode: str = "auto",
    ) -> None:
        """``step_buckets`` (ascending, ending at ``max_decode_len``) runs
        each chunk on the per-beam caches cut to the smallest bucket that
        covers the deepest slot that may step in it (chosen on the host from
        a conservative fill bound): exact, since untouched columns are never
        read."""
        if reorder_mode not in REORDER_MODES:
            raise ValueError(f"reorder_mode must be one of {REORDER_MODES}: {reorder_mode!r}")
        self.params = params
        self.num_slots = num_slots
        self.num_beams = num_beams
        self.max_src_len = max_src_len
        self.max_decode_len = max_decode_len
        self.length_penalty = length_penalty
        self.chunk_size = chunk_size
        self.mesh = mesh
        self.reorder_mode = reorder_mode
        if step_buckets is not None:
            step_buckets = tuple(int(b) for b in step_buckets)
            if not self._bucket_cache_fields:
                raise ValueError(type(self).__name__ + " has no bucketable caches")
            if not (all(a < b for a, b in zip(step_buckets, step_buckets[1:]))
                    and step_buckets[-1] == max_decode_len):
                raise ValueError(f"step_buckets must ascend and end at max_decode_len: "
                                 f"{step_buckets}")
        self.step_buckets = step_buckets
        # Conservative host-side bound on each slot's fill n: bumped by
        # max_steps at every dispatch, reset on admit/finalize/release.
        self._n_ub = np.zeros(num_slots, np.int64)
        # The second buffer of each per-beam cache ("gather" reorder).
        self._spare: Dict[str, torch.Tensor] = {}
        # The leader/follower protocol's group (None: one rank), whether a
        # replicated call is running (its nested calls are not sent) and
        # whether this follower is in follow().
        self._control = mesh.group("control") if mesh is not None and mesh.size > 1 else None
        self._in_call = self._following = self._released = False
        self.state = self._init_state()

    # -- subclass hooks ------------------------------------------------ #

    def _init_state(self) -> Any:
        raise NotImplementedError

    def _step_program(self, state: Any, t_live: int) -> None:
        """One decode + beam step over all slots, in place."""
        raise NotImplementedError

    def _admit_program(self, state: Any, slots: List[int], ids: torch.Tensor,
                       mask: torch.Tensor) -> None:
        """Install a tokenized arrival wave, in place."""
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.state.n.device

    # -- leader / follower (tensor parallelism) ------------------------ #

    def _leader_rank(self) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self._control, 0)

    def _send(self, message: Tuple[str, Any, Any]) -> None:
        import torch.distributed as dist

        dist.broadcast_object_list([message], src=self._leader_rank(), group=self._control)

    def follow(self) -> None:
        """On a follower rank: run the leader's calls, in its order, until
        it calls :meth:`release_followers`. A call that raised on any rank
        raised on every rank: it is logged here and the loop goes on, since
        the leader decides what follows (a service resets the engine)."""
        import torch.distributed as dist

        if self._control is None or self.mesh.is_leader:
            raise RuntimeError("follow() runs on the follower ranks of a tensor-parallel engine")
        self._following = True
        try:
            while True:
                box: List[Any] = [None]
                dist.broadcast_object_list(box, src=self._leader_rank(), group=self._control)
                name, args, kwargs = box[0]
                if name == "stop":
                    return
                try:
                    getattr(self, name)(*args, **kwargs)
                except Exception:  # noqa: BLE001 - the leader's call raised as well
                    logger.exception("follower rank %s: %s failed", self.mesh.coords, name)
        finally:
            self._following = False

    def release_followers(self) -> None:
        """On the leader: end the followers' :meth:`follow` loops (no-op on
        one rank). A driving script calls it in a ``finally``: a follower
        waits for the leader's next call until it comes."""
        if self._control is not None and self.mesh.is_leader and not self._released:
            self._send(("stop", (), {}))
            self._released = True

    def _agree(self, values: List[int], what: str) -> None:
        """Raise on every rank unless every rank of the grid holds the same
        ``values`` (one small all-reduce over the control group)."""
        import torch.distributed as dist

        t = torch.tensor(list(values) + [-v for v in values], dtype=torch.long)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._control)
        n = len(values)
        if not torch.equal(t[:n], -t[n:]):
            raise RuntimeError(f"tensor-parallel ranks disagree on {what}: the largest "
                               f"{t[:n].tolist()}, the smallest {(-t[n:]).tolist()}")

    # -- host API ------------------------------------------------------ #

    @replicated
    def reset(self) -> None:
        """Reinstall a blank state (all slots vacant); the serving loop's
        crash containment."""
        self.state = self._init_state()
        self._n_ub[:] = 0

    def _finished(self, s: Any) -> torch.Tensor:
        return s.active & (s.done | (s.n >= self.max_decode_len))

    @replicated
    @torch.no_grad()
    def dispatch_run(self, max_steps: int, release: Optional[np.ndarray] = None) -> HostCopy:
        """Run one run-until-event chunk and return the flat status+payload
        vector (see :meth:`unpack_status`) with its host copy in flight.

        The chunk stops after ``max_steps`` steps, when no slot is working,
        or when a slot finishes that had not finished on entry (finished
        slots are frozen and must not stall the others while the host emits
        them): one device flag is read per step. ``release`` marks slots
        whose results were emitted from a ride-along payload; their flags
        are cleared before stepping. Under tensor parallelism the ranks
        check at the chunk's end that they ran as many steps and hold the
        same ``n`` and ``done``."""
        S, T = self.num_slots, self.max_decode_len
        st = self.state
        if release is None:
            release = np.zeros((S,), bool)
        rel = torch.as_tensor(np.asarray(release, bool)).to(self.device)
        st.active = st.active & ~rel
        st.done = st.done & ~rel
        t_live = T
        if self.step_buckets is not None:
            self._n_ub[np.asarray(release, bool)] = 0
            need = int(min(T, self._n_ub.max() + max_steps))
            t_live = next(b for b in self.step_buckets if b >= need)
            live = self._n_ub > 0
            self._n_ub[live] = np.minimum(self._n_ub[live] + max_steps, T)
        fin0 = self._finished(st)
        steps = 0
        while steps < max_steps:
            fin = self._finished(st)
            go = (st.active & ~fin).any() & ~(fin & ~fin0).any()
            if not bool(go):
                break
            self._step_program(st, t_live)
            steps += 1
        if self._control is not None:
            self._agree([steps] + st.n.tolist() + st.done.long().tolist(), "steps, n and done")
        # ONE packed int32 vector [3S+2+...]: the exit reason's finalize
        # payload rides along with the status.
        fin_new = self._finished(st) & ~fin0
        f = torch.where(fin_new.any(), torch.argmax(fin_new.int()), torch.full_like(st.n[0], -1))
        g = f.clamp_min(0)
        scores = torch.cat([st.fin_scores[g], st.beam_scores[g]])
        i32 = torch.int32
        flat = torch.cat([
            st.active.to(i32), st.done.to(i32), st.n.to(i32),
            torch.full((1,), steps, dtype=i32, device=self.device), f.to(i32)[None],
            st.n[g].to(i32)[None], st.done[g].to(i32)[None], st.fin_lens[g].to(i32),
            torch.cat([st.fin_tokens[g], st.tokens[g]], dim=0).reshape(-1).to(i32),
            scores.contiguous().view(i32),
        ])
        return HostCopy(flat)

    def unpack_status(
        self, packed: Any
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int, Tuple[Any, Any, Any]]:
        """Flat int32 vector -> (active, done, n, steps, finished_slot,
        finalize_handle): ``finished_slot`` is the slot whose finalize
        payload rode along (-1 if the chunk ended on its horizon or idle);
        ``finalize_handle`` is that payload in ``finalize_prefetched``
        layout."""
        arr = np.asarray(packed)
        S, K, T = self.num_slots, self.num_beams, self.max_decode_len
        p = 3 * S + 2
        ints = arr[p: p + K + 2]
        toks = arr[p + K + 2: p + K + 2 + 2 * K * T].reshape(2 * K, T)
        scores = arr[p + K + 2 + 2 * K * T:].view(np.float32)
        return (arr[:S] != 0, arr[S: 2 * S] != 0, arr[2 * S: 3 * S], int(arr[3 * S]),
                int(arr[3 * S + 1]), (ints, toks, scores))

    @replicated
    @torch.no_grad()
    def admit_batch_tokens(self, slots: List[int], ids: Any, mask: Any) -> None:
        """Admit a wave of tokenized requests: ``ids``/``mask`` are
        ``[A, max_src_len]``; row i goes to ``slots[i]``; rows with slot -1
        are padding and change nothing."""
        if ids.shape[1] != self.max_src_len:
            raise ValueError(f"admission rows must be padded to max_src_len={self.max_src_len}, "
                             f"got {ids.shape[1]}")
        rows = [a for a, s in enumerate(slots) if s >= 0]
        if not rows:
            return
        dev = self.device

        def take(x: Any) -> torch.Tensor:
            x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
            return x.to(dev)[torch.tensor(rows, device=dev)].long()

        ids_t, mask_t = take(ids), take(mask)
        self._admit_program(self.state, [int(slots[a]) for a in rows], ids_t, mask_t)
        for a in rows:
            self._n_ub[slots[a]] = 1  # admission resets the slot to n=1

    def host_status(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One host fetch of (active, done, n)."""
        st = self.state
        return st.active.cpu().numpy(), st.done.cpu().numpy(), st.n.cpu().numpy()

    def free_slots(self) -> List[int]:
        active, _, _ = self.host_status()
        return [i for i in range(self.num_slots) if not active[i]]

    def has_active(self) -> bool:
        active, _, _ = self.host_status()
        return bool(active.any())

    def run_chunk(self) -> None:
        self.dispatch_run(self.chunk_size)

    def finished_slots(
        self, status: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
    ) -> List[int]:
        active, done, n = status if status is not None else self.host_status()
        return [i for i in range(self.num_slots)
                if active[i] and (done[i] or n[i] >= self.max_decode_len)]

    @replicated
    @torch.no_grad()
    def prefetch_finalize(self, slot: int) -> Tuple[HostCopy, HostCopy, HostCopy]:
        """Gather everything :meth:`finalize_prefetched` needs for ``slot``
        (host copies in flight) and free the slot on the device."""
        st = self.state
        ints = torch.cat([st.n[slot][None], st.done[slot].long()[None], st.fin_lens[slot]])
        toks = torch.cat([st.fin_tokens[slot], st.tokens[slot]], dim=0)
        scores = torch.cat([st.fin_scores[slot], st.beam_scores[slot]])
        handle = (HostCopy(ints.to(torch.int32)), HostCopy(toks.to(torch.int32)),
                  HostCopy(scores))
        st.active[slot] = False
        st.done[slot] = False
        self._n_ub[slot] = 0
        return handle

    def finalize(self, slot: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(sequences ``[K, T]``, scores ``[K]``, lengths ``[K]``) of ``slot``,
        which is freed. HF finalize semantics: a slot that hit max length
        merges its running beams as hypotheses of length n - 1, no EOS."""
        return self.finalize_prefetched(slot, self.prefetch_finalize(slot))

    def finalize_prefetched(
        self, slot: int, handle: Tuple[Any, ...]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Complete a :meth:`prefetch_finalize` handle on the host."""
        K = self.num_beams
        ints, toks, scores = (np.asarray(a) for a in handle)
        n, done = int(ints[0]), bool(ints[1])
        fin_lens = ints[2:]
        fin_tokens, tokens = toks[:K], toks[K:]
        fin_scores, beam_scores = scores[:K], scores[K:]
        if done:
            merged_scores, merged_tokens, merged_lens = fin_scores, fin_tokens, fin_lens
        else:
            lp = self.length_penalty
            if lp == 0.0:
                run_scores = beam_scores
            else:
                run_scores = (beam_scores / np.float32(max(float(n - 1), 1.0)) ** np.float32(lp)
                              ).astype(np.float32)
            merged_scores = np.concatenate([fin_scores, run_scores])
            merged_tokens = np.concatenate([fin_tokens, np.asarray(tokens)])
            merged_lens = np.concatenate([fin_lens, np.full((K,), n, np.int32)])
        keep = np.argsort(-merged_scores, kind="stable")[:K]
        return merged_tokens[keep], merged_scores[keep], merged_lens[keep]


class StepwiseBeamEngine(StepwiseEngineBase):
    """T5 continuous-batching beam-search engine over ``num_slots`` slots:
    the encoder output enters as per-slot cross K/V; the decoder self-KV is
    per (slot, beam) with per-slot positions."""

    _bucket_cache_fields = ("self_k", "self_v")

    def __init__(
        self,
        params: Params,
        cfg: T5Config,
        num_slots: int,
        num_beams: int,
        max_src_len: int,
        max_decode_len: int,
        length_penalty: float = 0.0,
        chunk_size: int = 8,
        mesh: Any = None,
        step_buckets: Optional[Sequence[int]] = None,
        quantize: "bool | str" = False,
        reorder_mode: str = "auto",
    ) -> None:
        self.cfg = cfg
        if quantize:
            params = quantize_t5_params(params, bits=resolve_quantize_bits(quantize))
        if mesh is not None:
            params, _ = shard_for_model(params, cfg, mesh)
        super().__init__(
            params, num_slots, num_beams, max_src_len, max_decode_len, length_penalty,
            chunk_size, mesh=mesh, step_buckets=step_buckets, reorder_mode=reorder_mode,
        )

    def _init_state(self) -> EngineState:
        return init_engine_state(self.params, self.cfg, self.num_slots, self.num_beams,
                                 self.max_src_len, self.max_decode_len)

    def _step_program(self, state: EngineState, t_live: int) -> None:
        engine_step(self.params, self.cfg, state, self.length_penalty,
                    reorder_mode=self.reorder_mode, t_live=t_live, spare=self._spare,
                    mesh=self.mesh)

    def _install(self, state: EngineState, slots: List[int], enc: torch.Tensor,
                 mask: torch.Tensor) -> None:
        """Cross K/V of encoder outputs ``enc`` ``[A, L, D]`` into ``slots``."""
        cfg = self.cfg
        layers = self.params["decoder"]["layers"]
        dt, H, d = cfg.compute_dtype, local_heads(layers["self_attn"]["q"], cfg), cfg.d_kv
        idx = torch.tensor(slots, dtype=torch.long, device=state.n.device)
        for i in range(cfg.num_decoder_layers):
            ca = layer_params(layers, i)["cross_attn"]
            state.cross_k[i, idx] = _split_heads(_dense(enc.to(dt), ca["k"], dt), H, d)
            state.cross_v[i, idx] = _split_heads(_dense(enc.to(dt), ca["v"], dt), H, d)
        state.cross_bias[idx] = torch.where(
            mask.bool(), 0.0, -1e10).to(torch.float32)[:, None, None, :]
        reset_slots(state, idx, cfg.pad_token_id, cfg.decoder_start_token_id)

    def _admit_program(self, state: EngineState, slots: List[int], ids: torch.Tensor,
                       mask: torch.Tensor) -> None:
        """Whole-wave admission: T5-encode the rows, project cross K/V, and
        install every arrival into its slot."""
        self._install(state, slots, encode(self.params, self.cfg, ids, mask, mesh=self.mesh), mask)

    @replicated
    @torch.no_grad()
    def admit(self, slot: int, enc_hidden: torch.Tensor, enc_mask: torch.Tensor) -> None:
        """Install one pre-encoded request: ``enc_hidden`` ``[1, Smax, D]``
        (padded), ``enc_mask`` ``[1, Smax]``."""
        self._install(self.state, [slot], enc_hidden.to(self.device),
                      torch.as_tensor(enc_mask).to(self.device))
        self._n_ub[slot] = 1
