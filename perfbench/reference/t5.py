"""Plain T5 (ByT5) in PyTorch: the yardstick the benchmark holds the port to.

Written from the T5 description (Raffel et al. 2020; HF ``modeling_t5``):
RMS layer norm without mean or bias, unscaled dot-product attention with a
learned relative-position bias (log buckets; bidirectional in the encoder,
causal in the decoder, none in cross-attention), gated-GELU (tanh) MLP,
untied output projection. It imports nothing of the program: it reads only
the weight tree and inputs that the benchmark made (``perfbench.weights``
layout: per-layer weights stacked on a leading axis, dense weights
``[in, out]``, the MLP's input projection fused as gate | up).

Everything runs in float32 with TF32 off (:func:`exact_matmuls`), or, as the
precision control, with every dense product's operands rounded to fp8
(e4m3; per-row scales for activations, per-output-column scales for
weights) before a float32 product: ``prec="fp8"``. The encoder runs one row
at a time, so a full ``[H, L, L]`` score matrix of one row is the largest
temporary.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

Params = Dict[str, Any]
Sizes = Dict[str, Any]

NEG_INF = -1e10
PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def exact_matmuls() -> Iterator[None]:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN inside the
    block, restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """``x @ w`` in float32; under ``prec="fp8"`` both operands are first
    rounded to fp8 (per row of ``x``, per column of ``w``)."""
    x, w = x.float(), w.float()
    if prec == "fp8":
        x, w = fp8_round(x, -1), fp8_round(w, -2)
    elif prec != "fp32":
        raise ValueError(f"prec must be one of {PRECISIONS}: {prec!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def relative_bucket(rel: torch.Tensor, bidirectional: bool, num_buckets: int,
                    max_distance: int) -> torch.Tensor:
    """T5's bucket of each relative position ``key - query``: exact up to
    half the buckets, then log-spaced up to ``max_distance`` (the log in
    float32, as the published implementation takes it)."""
    rel = rel.long()
    out = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        out = out + (rel > 0).long() * num_buckets
        dist = rel.abs()
    else:
        dist = (-rel).clamp_min(0)
    exact = num_buckets // 2
    scale = torch.tensor(math.log(max_distance / exact), dtype=torch.float32)
    far = exact + (torch.log(dist.float() / exact + 1e-20) / scale
                   * (num_buckets - exact)).long()
    far = far.clamp_max(num_buckets - 1)
    return out + torch.where(dist < exact, dist, far)


def position_bias(table: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                  bidirectional: bool, sizes: Sizes) -> torch.Tensor:
    """``[H, Q, K]`` float32 bias from the ``[buckets, H]`` table."""
    b = relative_bucket(k_pos[None, :] - q_pos[:, None], bidirectional,
                        sizes["relative_attention_num_buckets"],
                        sizes["relative_attention_max_distance"])
    return table.float()[b].permute(2, 0, 1)


def _heads(x: torch.Tensor, sizes: Sizes) -> torch.Tensor:
    """``[..., L, H*d]`` -> ``[..., H, L, d]``."""
    *lead, n, _ = x.shape
    return x.reshape(*lead, n, sizes["num_heads"], sizes["d_kv"]).transpose(-3, -2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    *lead, h, n, d = x.shape
    return x.transpose(-3, -2).reshape(*lead, n, h * d)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
           ) -> torch.Tensor:
    """Unscaled softmax attention in float32 (T5 folds the scale into q)."""
    p = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
    return p @ v


def _layer(params: Params, i: int) -> Params:
    def take(t: Any) -> Any:
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return take(params)


def _mlp(x: torch.Tensor, p: Params, prec: str) -> torch.Tensor:
    gate, up = linear(x, p["wi"], prec).chunk(2, dim=-1)
    return linear(gelu_tanh(gate) * up, p["wo"], prec)


def _attn_proj(x: torch.Tensor, kv: torch.Tensor, p: Params, bias: torch.Tensor,
               sizes: Sizes, prec: str) -> torch.Tensor:
    q = _heads(linear(x, p["q"], prec), sizes)
    k = _heads(linear(kv, p["k"], prec), sizes)
    v = _heads(linear(kv, p["v"], prec), sizes)
    return linear(_merge(attend(q, k, v, bias)), p["o"], prec)


@torch.no_grad()
def encode(params: Params, sizes: Sizes, ids: torch.Tensor, prec: str = "fp32"
           ) -> torch.Tensor:
    """Encoder states ``[L, d_model]`` of one unpadded row of token ids."""
    return _encode(params, sizes, ids, prec)


def _encode(params: Params, sizes: Sizes, ids: torch.Tensor, prec: str) -> torch.Tensor:
    enc, eps = params["encoder"], sizes["layer_norm_epsilon"]
    pos = torch.arange(ids.shape[0], device=ids.device)
    bias = position_bias(enc["rel_bias"], pos, pos, True, sizes)
    h = params["shared_embedding"].float()[ids]
    for i in range(sizes["num_layers"]):
        lp = _layer(enc["layers"], i)
        n = rms_norm(h, lp["attn_norm"], eps)
        h = h + _attn_proj(n, n, lp["attn"], bias, sizes, prec)
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], eps), lp["mlp"], prec)
    return rms_norm(h, enc["final_norm"], eps)


@torch.no_grad()
def embed(params: Params, sizes: Sizes, ids: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """The retriever's embedding of one unpadded row: the encoder's states
    averaged over its tokens, scaled to unit length, ``[d_model]``."""
    mean = _encode(params, sizes, ids, prec).mean(0)
    return mean / mean.norm().clamp_min(1e-12)


def _decoder(params: Params, sizes: Sizes, enc: torch.Tensor, dec_in: torch.Tensor,
             prec: str) -> torch.Tensor:
    """Teacher-forced decoder logits ``[N, T, V]`` of ``N`` target rows over
    the states ``enc`` ``[S, d]`` of one source."""
    dec, eps = params["decoder"], sizes["layer_norm_epsilon"]
    t = dec_in.shape[1]
    pos = torch.arange(t, device=dec_in.device)
    causal = pos[None, :] <= pos[:, None]
    self_bias = position_bias(dec["rel_bias"], pos, pos, False, sizes)
    self_bias = torch.where(causal[None], self_bias, torch.full_like(self_bias, NEG_INF))
    cross_bias = torch.zeros((), device=enc.device)
    h = params["shared_embedding"].float()[dec_in]
    for i in range(sizes["num_decoder_layers"]):
        lp = _layer(dec["layers"], i)
        n = rms_norm(h, lp["self_norm"], eps)
        h = h + _attn_proj(n, n, lp["self_attn"], self_bias, sizes, prec)
        n = rms_norm(h, lp["cross_norm"], eps)
        h = h + _attn_proj(n, enc, lp["cross_attn"], cross_bias, sizes, prec)
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], eps), lp["mlp"], prec)
    return linear(rms_norm(h, dec["final_norm"], eps), params["lm_head"], prec)


@torch.no_grad()
def decoder_logits(params: Params, sizes: Sizes, enc: torch.Tensor, dec_in: torch.Tensor,
                   prec: str = "fp32") -> torch.Tensor:
    return _decoder(params, sizes, enc, dec_in, prec)


@torch.no_grad()
def sequence_logprobs(params: Params, sizes: Sizes, src_ids: torch.Tensor,
                      seqs: List[torch.Tensor], prec: str = "fp32", rows: int = 64
                      ) -> torch.Tensor:
    """Sum of log-probabilities of each generated sequence (without the
    start token) given one source, ``[len(seqs)]`` float64: what a beam
    search scores a hypothesis at length penalty 0."""
    enc = _encode(params, sizes, src_ids, prec)
    start = sizes["decoder_start_token_id"]
    out = torch.zeros(len(seqs), dtype=torch.float64)
    for lo in range(0, len(seqs), rows):
        block = seqs[lo: lo + rows]
        t = max(len(s) for s in block)
        dec_in = torch.full((len(block), t), start, dtype=torch.long, device=src_ids.device)
        labels = torch.full((len(block), t), -1, dtype=torch.long, device=src_ids.device)
        for r, s in enumerate(block):
            dec_in[r, 1: len(s)] = s[:-1]
            labels[r, : len(s)] = s
        logp = torch.log_softmax(_decoder(params, sizes, enc, dec_in, prec), dim=-1)
        picked = torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
        out[lo: lo + len(block)] = torch.where(labels >= 0, picked, 0.0).double().sum(1).cpu()
    return out


# ------------------------------------------------------------------ #
# Incremental decoding and beam search
# ------------------------------------------------------------------ #


class DecodeCache:
    """Self-attention keys and values of the positions decoded so far, one
    ``[N, H, t, d]`` pair per decoder layer, and the cross keys and values
    of the source."""

    def __init__(self, params: Params, sizes: Sizes, enc: torch.Tensor, prec: str) -> None:
        self.k: List[Optional[torch.Tensor]] = [None] * sizes["num_decoder_layers"]
        self.v: List[Optional[torch.Tensor]] = [None] * sizes["num_decoder_layers"]
        self.cross = []
        for i in range(sizes["num_decoder_layers"]):
            p = _layer(params["decoder"]["layers"], i)["cross_attn"]
            self.cross.append((_heads(linear(enc, p["k"], prec), sizes),
                               _heads(linear(enc, p["v"], prec), sizes)))
        self.step = 0

    def reorder(self, parents: torch.Tensor) -> None:
        self.k = [k[parents] for k in self.k]
        self.v = [v[parents] for v in self.v]


@torch.no_grad()
def decode_step(params: Params, sizes: Sizes, cache: DecodeCache, tokens: torch.Tensor,
                prec: str = "fp32") -> torch.Tensor:
    """Logits ``[N, V]`` of the next position given the token ``[N]`` at
    position ``cache.step``; appends its keys and values to ``cache``."""
    dec, eps = params["decoder"], sizes["layer_norm_epsilon"]
    t = cache.step
    dev = tokens.device
    bias = position_bias(dec["rel_bias"], torch.tensor([t], device=dev),
                         torch.arange(t + 1, device=dev), False, sizes)
    h = params["shared_embedding"].float()[tokens][:, None, :]
    for i in range(sizes["num_decoder_layers"]):
        lp = _layer(dec["layers"], i)
        n = rms_norm(h, lp["self_norm"], eps)
        p = lp["self_attn"]
        q = _heads(linear(n, p["q"], prec), sizes)
        k = _heads(linear(n, p["k"], prec), sizes)
        v = _heads(linear(n, p["v"], prec), sizes)
        cache.k[i] = k if cache.k[i] is None else torch.cat([cache.k[i], k], dim=2)
        cache.v[i] = v if cache.v[i] is None else torch.cat([cache.v[i], v], dim=2)
        h = h + linear(_merge(attend(q, cache.k[i], cache.v[i], bias)), p["o"], prec)
        n = rms_norm(h, lp["cross_norm"], eps)
        p = lp["cross_attn"]
        q = _heads(linear(n, p["q"], prec), sizes)
        ck, cv = cache.cross[i]
        h = h + linear(_merge(attend(q, ck, cv, torch.zeros((), device=dev))), p["o"], prec)
        h = h + _mlp(rms_norm(h, lp["mlp_norm"], eps), lp["mlp"], prec)
    cache.step += 1
    return linear(rms_norm(h, dec["final_norm"], eps), params["lm_head"], prec)[:, 0]


@torch.no_grad()
def beam_search(params: Params, sizes: Sizes, src_ids: torch.Tensor, num_beams: int,
                max_len: int, prec: str = "fp32"
                ) -> List[Tuple[List[int], float]]:
    """Beam search at length penalty 0 without early stopping (HF
    ``generate(do_sample=False, early_stopping=False)``): each step ranks the
    ``2K`` best continuations of the live beams; a ranked continuation that
    ends in EOS among the first ``K`` is kept as a hypothesis, the first
    ``K`` others become the next beams. It stops once ``K`` hypotheses are
    kept and none of the live beams can beat the worst, or after
    ``max_len - 1`` tokens, when the live beams join the hypotheses.
    Returns ``K`` (generated tokens, summed log-probability), best first."""
    eos = sizes["eos_token_id"]
    K = num_beams
    enc = _encode(params, sizes, src_ids, prec)
    cache = DecodeCache(params, sizes, enc, prec)
    tokens = torch.full((K,), sizes["decoder_start_token_id"], dtype=torch.long,
                        device=src_ids.device)
    scores = torch.full((K,), -math.inf, dtype=torch.float64)
    scores[0] = 0.0
    beams: List[List[int]] = [[] for _ in range(K)]
    finished: List[Tuple[List[int], float]] = []
    for _ in range(max_len - 1):
        logp = torch.log_softmax(decode_step(params, sizes, cache, tokens, prec), -1)
        total = scores[:, None] + logp.double().cpu()
        flat = torch.argsort(total.reshape(-1), descending=True, stable=True)[: 2 * K]
        vocab = total.shape[1]
        nxt, parents, new_scores = [], [], []
        for rank, idx in enumerate(flat.tolist()):
            b, tok = divmod(idx, vocab)
            s = float(total[b, tok])
            if tok == eos:
                if rank < K:
                    finished.append((beams[b] + [tok], s))
                continue
            if len(nxt) < K:
                nxt.append(beams[b] + [tok])
                parents.append(b)
                new_scores.append(s)
        beams = nxt
        scores = torch.tensor(new_scores, dtype=torch.float64)
        cache.reorder(torch.tensor(parents, device=src_ids.device))
        tokens = torch.tensor([b[-1] for b in beams], device=src_ids.device)
        finished.sort(key=lambda h: -h[1])
        finished = finished[:K]
        if len(finished) >= K and finished[-1][1] >= float(total.max()):
            break
    else:
        finished += list(zip(beams, scores.tolist()))
    finished.sort(key=lambda h: -h[1])
    return finished[:K]


# ------------------------------------------------------------------ #
# Training: loss, gradient, AdamW
# ------------------------------------------------------------------ #


def seq2seq_loss(params: Params, sizes: Sizes, src_ids: torch.Tensor, src_mask: torch.Tensor,
                 labels: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """Token-mean cross entropy of ``labels`` ``[B, T]`` (-100 ignored)
    given padded sources ``[B, S]``, the decoder fed the labels shifted
    right (differentiable)."""
    start, pad = sizes["decoder_start_token_id"], sizes["pad_token_id"]
    dec_in = torch.roll(labels, 1, dims=1)
    dec_in[:, 0] = start
    dec_in = torch.where(dec_in == -100, torch.full_like(dec_in, pad), dec_in)
    total = torch.zeros((), dtype=torch.float32, device=labels.device)
    for b in range(labels.shape[0]):
        n = int(src_mask[b].sum())
        enc = _encode(params, sizes, src_ids[b, :n], prec)
        logp = torch.log_softmax(_decoder(params, sizes, enc, dec_in[b: b + 1], prec), -1)[0]
        valid = labels[b] != -100
        picked = torch.gather(logp, -1, labels[b].clamp_min(0)[:, None])[:, 0]
        total = total - torch.where(valid, picked, torch.zeros_like(picked)).sum()
    return total / (labels != -100).sum().clamp_min(1)


def adamw_step(params: List[torch.Tensor], grads: List[torch.Tensor], m: List[torch.Tensor],
               v: List[torch.Tensor], step: int, lr: float, betas: Tuple[float, float] = (0.9, 0.999),
               eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """One AdamW step in place (decoupled weight decay, bias-corrected
    moments); ``step`` counts from 1."""
    b1, b2 = betas
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        mhat = mi / (1 - b1 ** step)
        vhat = vi / (1 - b2 ** step)
        p.mul_(1 - lr * weight_decay)
        p.sub_(lr * mhat / (vhat.sqrt() + eps))
