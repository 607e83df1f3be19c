"""The plain reference against brute-force forms of the same mathematics,
at a tiny width on the CPU."""

import itertools
import math

import pytest
import torch

from perfbench import weights
from perfbench.reference import t5 as ref

SIZES = dict(d_model=8, d_ff=12, num_heads=2, d_kv=4, num_layers=2, num_decoder_layers=2,
             vocab_size=7, relative_attention_num_buckets=8, relative_attention_max_distance=16,
             layer_norm_epsilon=1e-6, decoder_start_token_id=0, pad_token_id=0, eos_token_id=1)


@pytest.fixture(scope="module")
def params():
    return weights.make_t5(SIZES, 2 ** 35 + 1, "cpu", torch.float32)


def _bucket_loop(rel, bidirectional, nb, maxd):
    out = 0
    if bidirectional:
        nb //= 2
        out += nb if rel > 0 else 0
        n = abs(rel)
    else:
        n = max(-rel, 0)
    exact = nb // 2
    if n < exact:
        return out + n
    far = exact + int(math.log(n / exact) / math.log(maxd / exact) * (nb - exact))
    return out + min(far, nb - 1)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_perfbench_relative_bucket(bidirectional):
    rel = torch.arange(-300, 301)
    got = ref.relative_bucket(rel, bidirectional, 32, 128).tolist()
    assert got == [_bucket_loop(r, bidirectional, 32, 128) for r in rel.tolist()]


def _rms(x, w):
    return [xi * w[i] / math.sqrt(sum(v * v for v in x) / len(x) + SIZES["layer_norm_epsilon"])
            for i, xi in enumerate(x)]


def _matvec(x, w):
    return [sum(x[i] * w[i][j] for i in range(len(x))) for j in range(len(w[0]))]


def _encode_loops(params, ids):
    """The encoder one scalar at a time."""
    s = SIZES
    p = {k: v for k, v in params["encoder"].items()}
    emb = params["shared_embedding"].tolist()
    h = [list(emb[t]) for t in ids]
    L, H, dk = len(ids), s["num_heads"], s["d_kv"]
    table = p["rel_bias"].tolist()
    for layer in range(s["num_layers"]):
        lp = {k: (v[layer] if not isinstance(v, dict) else {kk: vv[layer] for kk, vv in v.items()})
              for k, v in p["layers"].items()}
        n = [_rms(x, lp["attn_norm"].tolist()) for x in h]
        q = [_matvec(x, lp["attn"]["q"].tolist()) for x in n]
        k = [_matvec(x, lp["attn"]["k"].tolist()) for x in n]
        v = [_matvec(x, lp["attn"]["v"].tolist()) for x in n]
        out = [[0.0] * (H * dk) for _ in range(L)]
        for i, hd in itertools.product(range(L), range(H)):
            sl = slice(hd * dk, (hd + 1) * dk)
            scores = []
            for j in range(L):
                b = _bucket_loop(j - i, True, s["relative_attention_num_buckets"],
                                 s["relative_attention_max_distance"])
                scores.append(sum(a * c for a, c in zip(q[i][sl], k[j][sl])) + table[b][hd])
            m = max(scores)
            e = [math.exp(x - m) for x in scores]
            z = sum(e)
            for j in range(L):
                for c in range(dk):
                    out[i][hd * dk + c] += e[j] / z * v[j][hd * dk + c]
        o = [_matvec(x, lp["attn"]["o"].tolist()) for x in out]
        h = [[a + b for a, b in zip(x, y)] for x, y in zip(h, o)]
        n = [_rms(x, lp["mlp_norm"].tolist()) for x in h]
        f = s["d_ff"]
        hid = [_matvec(x, lp["mlp"]["wi"].tolist()) for x in n]
        act = [[0.5 * g * (1 + math.tanh(math.sqrt(2 / math.pi) * (g + 0.044715 * g ** 3))) * u
                for g, u in zip(r[:f], r[f:])] for r in hid]
        m = [_matvec(x, lp["mlp"]["wo"].tolist()) for x in act]
        h = [[a + b for a, b in zip(x, y)] for x, y in zip(h, m)]
    return [_rms(x, p["final_norm"].tolist()) for x in h]


def test_perfbench_encoder_against_loops(params):
    ids = [3, 5, 2, 6, 1]
    got = ref.encode(params, SIZES, torch.tensor(ids))
    want = torch.tensor(_encode_loops(params, ids))
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_perfbench_embed_is_normalised_mean(params):
    ids = torch.tensor([4, 2, 6, 1])
    h = torch.tensor(_encode_loops(params, ids.tolist())).mean(0)
    assert torch.allclose(ref.embed(params, SIZES, ids), h / h.norm(), atol=1e-5)


def test_perfbench_cached_steps_match_teacher_forcing(params):
    src = torch.tensor([3, 4, 5, 6, 1])
    enc = ref.encode(params, SIZES, src)
    seq = torch.tensor([[0, 4, 2, 6, 5], [0, 3, 3, 1, 2]])
    full = ref.decoder_logits(params, SIZES, enc, seq)
    cache = ref.DecodeCache(params, SIZES, enc, "fp32")
    for t in range(seq.shape[1]):
        step = ref.decode_step(params, SIZES, cache, seq[:, t])
        assert torch.allclose(step, full[:, t], atol=1e-5), t


def test_perfbench_beam_of_one_is_greedy(params):
    src = torch.tensor([6, 2, 4, 1])
    enc = ref.encode(params, SIZES, src)
    seq = [0]
    for _ in range(5):
        logits = ref.decoder_logits(params, SIZES, enc, torch.tensor([seq]))[0, -1]
        seq.append(int(logits.argmax()))
        if seq[-1] == SIZES["eos_token_id"]:
            break
    (tokens, score), = ref.beam_search(params, SIZES, src, 1, 6)
    assert tokens == seq[1:]
    assert score == pytest.approx(float(ref.sequence_logprobs(params, SIZES, src,
                                                              [torch.tensor(tokens)])[0]), abs=1e-5)


def test_perfbench_beam_search_finds_the_best_sequence(params):
    """With as many beams as sequences of each length, the best of the K
    returned is the best sequence of all: every sequence of at most two
    tokens after the start, ending in EOS or at the cap."""
    src = torch.tensor([5, 3, 1])
    V, eos = SIZES["vocab_size"], SIZES["eos_token_id"]
    (best, best_score), *_ = ref.beam_search(params, SIZES, src, V * V, 3)
    seqs = [[eos]] + [[a, eos] for a in range(V) if a != eos] + [
        [a, b] for a in range(V) for b in range(V) if a != eos]
    scores = ref.sequence_logprobs(params, SIZES, src, [torch.tensor(s) for s in seqs])
    top = int(torch.argmax(scores))
    assert best == seqs[top]
    assert best_score == pytest.approx(float(scores[top]), abs=1e-5)


def _loss_loops(params, src, mask, labels):
    total, n = 0.0, 0
    for b in range(src.shape[0]):
        m = int(mask[b].sum())
        enc = ref.encode(params, SIZES, src[b, :m])
        dec_in = [SIZES["decoder_start_token_id"]] + [
            SIZES["pad_token_id"] if t == -100 else t for t in labels[b, :-1].tolist()]
        logits = ref.decoder_logits(params, SIZES, enc, torch.tensor([dec_in]))[0]
        for t, y in enumerate(labels[b].tolist()):
            if y != -100:
                total -= float(torch.log_softmax(logits[t].double(), -1)[y])
                n += 1
    return total / n


def test_perfbench_loss_and_gradient(params):
    src = torch.tensor([[3, 4, 5, 1], [6, 2, 1, 0]])
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0]])
    labels = torch.tensor([[4, 2, 1], [5, 1, -100]])
    p = {k: v for k, v in params.items()}
    w = params["lm_head"].clone().requires_grad_(True)
    p["lm_head"] = w
    loss = ref.seq2seq_loss(p, SIZES, src, mask, labels)
    assert float(loss.detach()) == pytest.approx(_loss_loops(params, src, mask, labels), abs=1e-5)
    (g,) = torch.autograd.grad(loss, [w])
    eps = 1e-2
    for i, j in [(0, 1), (3, 4), (7, 6)]:
        bumped = [params["lm_head"].clone() for _ in range(2)]
        bumped[0][i, j] += eps
        bumped[1][i, j] -= eps
        f = [_loss_loops({**params, "lm_head": b}, src, mask, labels) for b in bumped]
        assert float(g[i, j]) == pytest.approx((f[0] - f[1]) / (2 * eps), abs=2e-4)


def test_perfbench_adamw_matches_torch():
    torch.manual_seed(0)
    ps = [torch.randn(5, 3), torch.randn(4)]
    mine = [p.clone() for p in ps]
    theirs = [p.clone().requires_grad_(True) for p in ps]
    opt = torch.optim.AdamW(theirs, lr=1e-2, betas=(0.9, 0.99), eps=1e-8, weight_decay=0.1)
    m = [torch.zeros_like(p) for p in ps]
    v = [torch.zeros_like(p) for p in ps]
    for step in range(1, 4):
        grads = [torch.randn_like(p) for p in ps]
        for t, g in zip(theirs, grads):
            t.grad = g.clone()
        opt.step()
        ref.adamw_step(mine, grads, m, v, step, 1e-2, (0.9, 0.99), 1e-8, 0.1)
        for a, b in zip(mine, theirs):
            assert torch.allclose(a, b.detach(), atol=1e-6)


def test_perfbench_fp8_control_rounds(params):
    src = torch.tensor([3, 4, 5, 6, 1])
    exact = ref.embed(params, SIZES, src, "fp32")
    low = ref.embed(params, SIZES, src, "fp8")
    gap = float((exact - low).norm())
    assert 1e-4 < gap < 0.5
    # the row's scale is 3: multiples of 3 that e4m3 holds stay, 1/3 goes to 11/32
    x = torch.tensor([[1.5, 6.0, -448.0 * 3, 1.0]])
    assert torch.equal(ref.fp8_round(x, -1), torch.tensor([[1.5, 6.0, -1344.0, 3 * 11 / 32]]))
