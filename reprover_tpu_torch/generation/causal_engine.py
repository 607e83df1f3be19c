"""Token-level continuous batching for decoder-only (LLaMA-family) models:
the counterpart of :mod:`reprover_tpu.generation.causal_engine`.

The same slot-based run-until-event machinery as the T5
:class:`~reprover_tpu_torch.generation.engine.StepwiseBeamEngine` with the
decoder-only cache layout:

- the prompt's K/V are prefilled once per slot and shared across beams;
- the decode-side K/V are per (slot, beam) and follow beam parents
  (reordered by the engine's reorder mode; ``"gather"`` is kernel 13);
- attention is one softmax over the concatenated [prompt | decode |
  fresh column] keys, the current column appended lazily;
- RoPE positions and cache columns are per slot: prompts are LEFT-padded to
  the engine's ``max_src_len`` bucket.

Under a tensor-parallel ``mesh`` the caches hold this rank's KV heads (GQA
groups stay whole on a rank), o and down are summed over ``model`` and the
logits gathered; the leader/follower protocol is the T5 engine's.

Beam semantics are those of the classic
:class:`~reprover_tpu_torch.generation.causal_generator.CausalTacticGeneratorModel`
path: decoding starts from each prompt's last real token.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from reprover_tpu_torch.generation.engine import (
    NEG_INF,
    StepwiseEngineBase,
    _beam_fields,
    apply_step,
    reset_slots,
)
from reprover_tpu_torch.models.causal_lm import (
    CausalLMConfig,
    Params,
    _dense,
    _lm_logits,
    _merge,
    _mlp,
    _rms_norm,
    _rope,
    _split,
    local_heads,
    prefill,
)
from reprover_tpu_torch.models.quantize import quantize_causal_params, resolve_quantize_bits
from reprover_tpu_torch.models.t5 import layer_params
from reprover_tpu_torch.parallel.collectives import reduce_from_model
from reprover_tpu_torch.parallel.sharding import shard_for_model


@dataclasses.dataclass
class CausalEngineState:
    """Device state of ``num_slots`` concurrent decoder-only beam searches
    (S slots, K beams, T max decode length incl. the start token, Cp =
    max_src_len - 1 prompt cache columns, Ld layers, Hkv KV heads, d
    head_dim)."""

    prompt_k: torch.Tensor  # [Ld, S, Hkv, Cp, d], shared across beams
    prompt_v: torch.Tensor  # [Ld, S, Hkv, Cp, d]
    prompt_bias: torch.Tensor  # [S, Cp] fp32 additive (left-pad masking)
    dec_k: torch.Tensor  # [Ld, S, K, Hkv, T, d], per beam, reordered
    dec_v: torch.Tensor  # [Ld, S, K, Hkv, T, d]
    pos0: torch.Tensor  # [S] int64, RoPE position of the start token
    n: torch.Tensor  # [S] int64
    tokens: torch.Tensor  # [S, K, T] int64
    last_token: torch.Tensor  # [S, K] int64
    beam_scores: torch.Tensor  # [S, K] fp32
    fin_tokens: torch.Tensor  # [S, K, T] int64
    fin_scores: torch.Tensor  # [S, K] fp32
    fin_lens: torch.Tensor  # [S, K] int64
    done: torch.Tensor  # [S] bool
    active: torch.Tensor  # [S] bool


def init_causal_engine_state(
    cfg: CausalLMConfig, num_slots: int, num_beams: int, max_src_len: int,
    max_decode_len: int, device: Any, kv_heads: Any = None,
) -> CausalEngineState:
    """A blank state; ``kv_heads`` this rank's KV heads (default all)."""
    S, K, T = num_slots, num_beams, max_decode_len
    ld, hkv, d = cfg.num_layers, kv_heads or cfg.num_kv_heads, cfg.head_dim
    cp = max_src_len - 1
    dt, dev = cfg.compute_dtype, torch.device(device)
    return CausalEngineState(
        prompt_k=torch.zeros((ld, S, hkv, cp, d), dtype=dt, device=dev),
        prompt_v=torch.zeros((ld, S, hkv, cp, d), dtype=dt, device=dev),
        prompt_bias=torch.full((S, cp), NEG_INF, dtype=torch.float32, device=dev),
        dec_k=torch.zeros((ld, S, K, hkv, T, d), dtype=dt, device=dev),
        dec_v=torch.zeros((ld, S, K, hkv, T, d), dtype=dt, device=dev),
        pos0=torch.zeros((S,), dtype=torch.long, device=dev),
        **_beam_fields(S, K, T, cfg.pad_token_id, cfg.pad_token_id, dev),
    )


def _causal_decode_step(
    params: Params, cfg: CausalLMConfig, state: CausalEngineState, t_live: int,
    mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decoder step for every (slot, beam) over the first ``t_live``
    decode-cache columns -> (logits ``[S, K, V]`` fp32, k_news, v_news
    ``[Ld, S, K, Hkv, 1, d]``): :func:`~reprover_tpu_torch.models.causal_lm.decode_step`
    with the batch row made (slot, beam) and the cache split into the
    shared prompt part and the per-beam decode part."""
    dt = cfg.compute_dtype
    S, K = state.last_token.shape
    T = t_live
    (H, Hkv), d = local_heads(params["layers"], cfg), cfg.head_dim
    G = H // Hkv
    scale = d ** -0.5
    dev = state.n.device

    pos = state.n - 1  # [S] decode index of the fed token
    rope_positions = (state.pos0 + pos).repeat_interleave(K)[:, None]  # [S*K, 1]
    h = params["embedding"].to(dt)[state.last_token].reshape(S * K, 1, -1)

    valid_d = torch.arange(T, device=dev)[None, :] < pos[:, None]  # strictly prior
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias_d = torch.where(valid_d, zero, NEG_INF)[:, None, None, None, :]  # [S,1,1,1,T]
    bias_p = state.prompt_bias[:, None, None, None, :]  # [S,1,1,1,Cp]
    cp = state.prompt_bias.shape[1]

    def over_prompt(x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """``x`` [S,K,Hkv,G,a] times per-slot ``kv`` [S,Hkv,a,b] -> [S,K,Hkv,G,b]."""
        a = x.shape[-1]
        xs = x.permute(0, 2, 1, 3, 4).reshape(S, Hkv, K * G, a)
        y = torch.matmul(xs, kv)
        return y.reshape(S, Hkv, K, G, -1).permute(0, 2, 1, 3, 4)

    k_news, v_news = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        pk, pv = state.prompt_k[i], state.prompt_v[i]  # [S, Hkv, Cp, d]
        dk = state.dec_k[i, :, :, :, :T]  # [S, K, Hkv, T, d]
        dv = state.dec_v[i, :, :, :, :T]
        nrm = _rms_norm(h, lp["input_norm"], cfg.rms_norm_eps)
        q = _rope(_split(_dense(nrm, lp["q"], dt), H, d), rope_positions, cfg.rope_theta)
        k = _rope(_split(_dense(nrm, lp["k"], dt), Hkv, d), rope_positions, cfg.rope_theta)
        v = _split(_dense(nrm, lp["v"], dt), Hkv, d)
        qg = q.reshape(S, K, Hkv, G, d).to(dt)
        kd = k.reshape(S, K, Hkv, 1, d)
        vd = v.reshape(S, K, Hkv, 1, d)

        # One softmax over [prompt | decode | fresh column]: the classic
        # full-cache attention with the current column appended.
        sp = over_prompt(qg, pk.to(dt).transpose(-1, -2)).float() * scale + bias_p
        sd = torch.matmul(qg, dk.to(dt).transpose(-1, -2)).float() * scale + bias_d
        s_new = torch.matmul(qg, kd.to(dt).transpose(-1, -2)).float() * scale
        probs = torch.softmax(torch.cat([sp, sd, s_new], dim=-1), dim=-1).to(dt)
        out = (
            over_prompt(probs[..., :cp], pv.to(dt)).float()
            + torch.matmul(probs[..., cp: cp + T], dv.to(dt)).float()
            + probs[..., cp + T:].float() * vd.float()
        ).to(dt)  # [S, K, Hkv, G, d]

        h = h + reduce_from_model(_dense(_merge(out.reshape(S * K, H, 1, d)), lp["o"], dt), mesh)
        h = h + _mlp(h, lp, cfg, mesh)
        k_news.append(kd.to(state.dec_k.dtype))
        v_news.append(vd.to(state.dec_v.dtype))

    h = _rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    logits = _lm_logits(params, cfg, h[:, 0, :], mesh)  # [S*K, V] fp32
    return logits.reshape(S, K, -1), torch.stack(k_news), torch.stack(v_news)


def causal_engine_step(
    params: Params, cfg: CausalLMConfig, state: CausalEngineState, length_penalty: float,
    reorder_mode: str = "auto", t_live: Any = None, spare: Any = None, mesh: Any = None,
) -> CausalEngineState:
    """Advance every active, unfinished slot by one token, in place (the
    state is returned); ``reorder_mode`` as in
    :func:`reprover_tpu_torch.generation.engine.engine_step`."""
    t_live = t_live or state.dec_k.shape[4]
    logits, k_news, v_news = _causal_decode_step(params, cfg, state, t_live, mesh)
    apply_step(state, ("dec_k", "dec_v"), logits, k_news, v_news, length_penalty,
               cfg.eos_token_id, reorder_mode, t_live, spare)
    return state


def causal_admit_program(
    params: Params, cfg: CausalLMConfig, state: CausalEngineState, slots: List[int],
    ids: torch.Tensor, mask: torch.Tensor, mesh: Any = None,
) -> None:
    """Wave admission, in place: prefill all prompts but their last column
    (``[A, max_src_len-1]``), install the per-slot prompt K/V, bias and RoPE
    start, and arm the beams with each prompt's last token as the start
    token (also written to column 0 of the tokens, as the classic path
    seeds it)."""
    _, cache = prefill(params, cfg, ids[:, :-1], mask[:, :-1], max_decode_len=0, mesh=mesh)
    idx = torch.tensor(slots, dtype=torch.long, device=state.n.device)
    state.prompt_k[:, idx] = cache.k
    state.prompt_v[:, idx] = cache.v
    zero = torch.zeros((), dtype=torch.float32, device=idx.device)
    state.prompt_bias[idx] = torch.where(mask[:, :-1].bool(), zero, NEG_INF)
    state.pos0[idx] = cache.position
    start = ids[:, -1].long()
    reset_slots(state, idx, cfg.pad_token_id, start)
    state.tokens[idx, :, 0] = start[:, None]


class CausalStepwiseEngine(StepwiseEngineBase):
    """Decoder-only continuous-batching beam-search engine. ``max_src_len``
    is the LEFT-padded prompt bucket: every admission row is ``[A,
    max_src_len]`` with the last column holding the prompt's final real
    token (the beam-search start token)."""

    _bucket_cache_fields = ("dec_k", "dec_v")

    def __init__(
        self,
        params: Params,
        cfg: CausalLMConfig,
        num_slots: int,
        num_beams: int,
        max_src_len: int,
        max_decode_len: int,
        length_penalty: float = 0.0,
        chunk_size: int = 8,
        mesh: Any = None,
        step_buckets: Any = None,
        quantize: "bool | str" = False,
        reorder_mode: str = "auto",
    ) -> None:
        self.cfg = cfg
        if quantize:
            params = quantize_causal_params(params, bits=resolve_quantize_bits(quantize))
        if mesh is not None:
            params, _ = shard_for_model(params, cfg, mesh)
        super().__init__(
            params, num_slots, num_beams, max_src_len, max_decode_len, length_penalty,
            chunk_size, mesh=mesh, step_buckets=step_buckets, reorder_mode=reorder_mode,
        )

    def _init_state(self) -> CausalEngineState:
        return init_causal_engine_state(self.cfg, self.num_slots, self.num_beams,
                                        self.max_src_len, self.max_decode_len,
                                        self.params["final_norm"].device,
                                        local_heads(self.params["layers"], self.cfg)[1])

    def _step_program(self, state: CausalEngineState, t_live: int) -> None:
        causal_engine_step(self.params, self.cfg, state, self.length_penalty,
                           reorder_mode=self.reorder_mode, t_live=t_live, spare=self._spare,
                           mesh=self.mesh)

    def _admit_program(self, state: CausalEngineState, slots: List[int], ids: torch.Tensor,
                       mask: torch.Tensor) -> None:
        causal_admit_program(self.params, self.cfg, state, slots, ids, mask, self.mesh)
