"""PyTorch port: the fused elementwise kernels of the T5 block
(``ops/fused_elementwise.py``, ``csrc/fused_elementwise.cu``) and the
model's choice between them and the plain composition.

On the CPU: which operands the kernels take (``plain_reason``) and that the
model takes the plain path there, under grad and in float32, counting its
layers; the wrappers' refusals; their plain versions' arithmetic; and the
fused path's structure (the MLP's residual carried into the next norm),
run on the CPU through the plain versions, bit-equal to the plain path
when both compute the gated GELU alike. On the card (``-m cuda``): each
kernel against its float32 reference row by row at the re-index cell's
shapes and at decode rows, ``h_new`` bit-equal to the bf16 add, the
encoder on the fused path against the benchmark's plain reference, a
planted fault failing that check, and the decoders' fused path against
their plain one. The file imports no JAX, so the card tests also run on a
machine without it:

    python -m pytest tests/test_torch_fused_elementwise.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from reprover_tpu_torch.generation import engine as te
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.ops import fused_elementwise as fe
from reprover_tpu_torch.utils.misc import cap_cpu_threads
from reprover_tpu_torch.utils.profiling import counters

cap_cpu_threads()

EPS = 1e-6
CFG = tt5.T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_heads=4,
                   num_encoder_layers=2, num_decoder_layers=3)
# On the card: a head width the attention kernels take.
CARD_CFG = tt5.T5Config(vocab_size=64, d_model=128, d_kv=64, d_ff=176, num_heads=2,
                        num_encoder_layers=2, num_decoder_layers=3)


def _layers() -> dict:
    c = counters()
    return {k: c.get(f"model.{k}_layers", 0) for k in ("fused", "plain")}


def _moved(before: dict) -> dict:
    after = _layers()
    return {k: after[k] - before[k] for k in after}


def _bf16(*shape, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, torch.bfloat16)


# ------------------------------------------------------------------ #
# Which operands the kernels take
# ------------------------------------------------------------------ #


def _misaligned(x):
    flat = torch.empty(x.numel() + 8, dtype=x.dtype)
    return flat[1:1 + x.numel()].view(x.shape)


@pytest.mark.parametrize("case,want", [
    ("cpu", "device"),
    ("grad", "autograd"),
    ("grad_off", "device"),
    ("fp32", "dtype"),
    ("shapes_differ", "shape"),
    ("misaligned", "layout"),
    ("last_dim_strided", "layout"),
    ("width_not_vectors", "layout"),
    ("rows_of_two_strides", "layout"),
    ("weight_bf16", "dtype"),
    ("weight_width", "layout"),
    ("too_wide", "layout"),
])
def test_plain_reason(case, want):
    x, w = _bf16(4, 5, 32), torch.ones(32)
    acts, weights = [x], [w]
    if case == "grad":
        acts = [x.requires_grad_()]
    elif case == "grad_off":
        with torch.no_grad():
            assert fe.plain_reason([x.requires_grad_()], weights) == want
        return
    elif case == "fp32":
        acts = [x.float()]
    elif case == "shapes_differ":
        acts = [x, _bf16(4, 6, 32)]
    elif case == "misaligned":
        acts = [_misaligned(x)]
    elif case == "last_dim_strided":
        acts = [_bf16(4, 32, 16).transpose(1, 2)]
        weights = [torch.ones(32)]
    elif case == "width_not_vectors":
        acts, weights = [_bf16(4, 5, 36)], [torch.ones(36)]
    elif case == "rows_of_two_strides":
        acts = [_bf16(4, 6, 32)[:, :5]]
    elif case == "weight_bf16":
        weights = [w.bfloat16()]
    elif case == "weight_width":
        weights = [torch.ones(40)]
    elif case == "too_wide":
        acts, weights = [_bf16(2, fe.MAX_NORM_WIDTH + 8)], [torch.ones(fe.MAX_NORM_WIDTH + 8)]
    assert fe.plain_reason(acts, weights) == want


def test_rows_of_chunk_views_and_stacked_weights():
    wi = _bf16(3, 7, 96)
    gate, up = wi.chunk(2, dim=-1)
    assert fe._rows(gate) == (21, 96) and fe._rows(up) == (21, 96)
    assert fe._rows(_bf16(1, 1, 32)) == (1, 32)
    assert fe._rows(_bf16(4, 6, 32)[:, :5]) is None
    # Stacked [L, D] norm weights pass as rows of the activations' width.
    assert fe.plain_reason([gate, up]) == "device"
    assert fe.plain_reason([_bf16(2, 48)], [torch.ones(3, 48)]) == "device"


# ------------------------------------------------------------------ #
# The wrappers
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("case", ["fp32", "shape", "weight_dtype", "weight_shape", "misaligned",
                                  "too_wide", "gelu_shape", "gelu_fp32", "gelu_strided"])
def test_wrappers_raise(case):
    h, d, w = _bf16(3, 32), _bf16(3, 32, seed=1), torch.ones(32)
    with pytest.raises(ValueError):
        if case == "fp32":
            fe.add_rms_norm(h.float(), d.float(), w, EPS)
        elif case == "shape":
            fe.add_rms_norm(h, _bf16(2, 32), w, EPS)
        elif case == "weight_dtype":
            fe.add_rms_norm(h, d, w.bfloat16(), EPS)
        elif case == "weight_shape":
            fe.add_rms_norm(h, d, torch.ones(16), EPS)
        elif case == "misaligned":
            fe.add_rms_norm(_misaligned(h), None, w, EPS)
        elif case == "too_wide":
            n = fe.MAX_NORM_WIDTH + 8
            fe.add_rms_norm(_bf16(1, n), None, torch.ones(n), EPS)
        elif case == "gelu_shape":
            fe.gated_gelu(h, _bf16(3, 40))
        elif case == "gelu_fp32":
            fe.gated_gelu(h.float(), d.float())
        elif case == "gelu_strided":
            fe.gated_gelu(_bf16(32, 3).t(), _bf16(32, 3).t())


def test_add_rms_norm_plain_version_is_the_model_chain():
    h, d = _bf16(4, 7, 32), _bf16(4, 7, 32, seed=1)
    w = torch.rand(32) + 0.5
    h_new, normed = fe.add_rms_norm(h, d, w, EPS)
    assert torch.equal(h_new, h + d)
    assert torch.equal(normed, tt5.rms_norm(h + d, w, EPS))
    same, normed = fe.add_rms_norm(h, None, w, EPS)
    assert same is h and torch.equal(normed, tt5.rms_norm(h, w, EPS))


def test_gated_gelu_plain_version_on_chunk_views_is_closer_than_the_bf16_chain():
    wi = _bf16(64, 2 * 48) * 2
    gate, up = wi.chunk(2, dim=-1)
    out = fe.gated_gelu(gate, up)
    assert out.is_contiguous() and out.dtype == torch.bfloat16
    assert torch.equal(out, fe.gated_gelu_reference(gate.contiguous(), up.contiguous()))
    x, u = gate.double(), up.double()
    exact = 0.5 * x * (1 + torch.tanh(fe.GELU_C * (x + 0.044715 * x ** 3))) * u
    fused_err = (out.double() - exact).abs().mean()
    chain_err = ((tt5.gelu_new(gate) * up).double() - exact).abs().mean()
    assert fused_err < chain_err


# ------------------------------------------------------------------ #
# The model's path on the CPU
# ------------------------------------------------------------------ #


def _model(dtype, fused_mlp=True, base=CFG, device="cpu"):
    params = tt5.init_params(base, torch.Generator().manual_seed(3))
    if fused_mlp:
        params = tt5.fuse_mlp_params(params)
    cfg = tt5.T5Config(**{**base.__dict__, "compute_dtype": dtype})
    return tt5.place_params(params, cfg, device), cfg


def _inputs():
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(3, 60, (3, 11))).long()
    mask = torch.ones_like(ids)
    mask[1, 8:] = 0
    mask[2, 4:] = 0
    dec = torch.from_numpy(rng.integers(3, 60, (3, 6))).long()
    return ids, mask, dec


def _engine_step(params, cfg, enc, mask):
    eng = te.StepwiseBeamEngine(params, cfg, num_slots=2, num_beams=4, max_src_len=enc.shape[1],
                                max_decode_len=8)
    for slot in range(2):
        eng.admit(slot, enc[slot:slot + 1], mask[slot:slot + 1])
    return te._engine_decode_step(eng.params, cfg, eng.state, 4)[0]


def _calls(params, cfg):
    """Each of the four layer stacks once -> {name: (output, layers)}."""
    ids, mask, dec = _inputs()
    enc = tt5.encode(params, cfg, ids, mask)
    out = {"encode": (enc, cfg.num_encoder_layers)}
    for flash in (True, False):
        out[f"decode_flash_{flash}"] = (
            tt5.decode(params, cfg, enc, mask, dec, flash_attention=flash), cfg.num_decoder_layers)
    state = tt5.init_decode_state(params, cfg, enc, mask, 8, num_beams=2)
    token = dec[:, 0].repeat_interleave(2)
    out["decode_step"] = (tt5.decode_step(params, cfg, state, token)[0], cfg.num_decoder_layers)
    out["engine_step"] = (_engine_step(params, cfg, enc, mask), cfg.num_decoder_layers)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_takes_the_plain_path_and_counts_its_layers(dtype):
    params, cfg = _model(dtype)
    launches = dict(fe.KERNEL_LAUNCHES)
    before = _layers()
    calls = _calls(params, cfg)
    total = sum(layers for _, layers in calls.values())
    assert _moved(before) == {"fused": 0, "plain": total}
    assert fe.KERNEL_LAUNCHES == launches


def test_grad_takes_the_plain_path(monkeypatch):
    """Even where the operands pass every other condition, a parameter that
    requires grad keeps the model on the plain path (and training's remat
    with it)."""
    real = fe.plain_reason
    monkeypatch.setattr(fe, "plain_reason",
                        lambda *a, **k: "" if real(*a, **k) == "device" else real(*a, **k))
    params, cfg = _model(torch.bfloat16)
    for t in torch.utils._pytree.tree_leaves(params):
        t.requires_grad_(True)
    ids, mask, _ = _inputs()
    before = _layers()
    out = tt5.encode(params, cfg, ids, mask)
    out.float().sum().backward()
    assert _moved(before) == {"fused": 0, "plain": cfg.num_encoder_layers}
    with torch.no_grad():
        tt5.encode(params, cfg, ids, mask)
    assert _moved(before) == {"fused": cfg.num_encoder_layers, "plain": cfg.num_encoder_layers}


@pytest.mark.parametrize("fused_mlp", [True, False])
def test_fused_structure_equals_the_plain_path(monkeypatch, fused_mlp):
    """The fused path's blocks, run through the plain versions on the CPU
    with the gated GELU computed as the plain chain does, give the plain
    path's outputs bit for bit: carrying the MLP's residual into the next
    norm changes no value. With the kernels' float32 GELU the outputs stay
    within bf16 rounding of it."""
    params, cfg = _model(torch.bfloat16, fused_mlp)
    plain = _calls(params, cfg)
    monkeypatch.setattr(fe, "plain_reason", lambda *a, **k: "")
    real_gelu = fe.gated_gelu
    monkeypatch.setattr(fe, "gated_gelu", lambda g, u: tt5.gelu_new(g) * u)
    before = _layers()
    fused = _calls(params, cfg)
    total = sum(layers for _, layers in plain.values())
    assert _moved(before) == {"fused": total, "plain": 0}
    for name, (out, _) in plain.items():
        assert torch.equal(fused[name][0], out), name
    monkeypatch.setattr(fe, "gated_gelu", real_gelu)
    for name, (out, _) in _calls(params, cfg).items():
        want = plain[name][0].float()
        assert (out.float() - want).abs().max() <= 0.1 * want.abs().max(), name


# ------------------------------------------------------------------ #
# On the card
# ------------------------------------------------------------------ #


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _row_excess(out, ref):
    """Each row's largest distance from the float32 reference over what
    one bf16 rounding of it allows (half a step, at most 2^-8 of the value,
    with 1e-3 of that and 1e-6 of the row's largest magnitude for float32's
    own reordering); <= 1 in every row for a kernel that rounds once."""
    ref = ref.reshape(-1, ref.shape[-1])
    err = (out.to(ref.dtype).reshape(ref.shape) - ref).abs()
    allowed = 2 ** -8 * (1 + 1e-3) * ref.abs() + 1e-6 * ref.abs().amax(-1, keepdim=True)
    return (err / allowed.clamp_min(1e-30)).amax(-1)


NORM_SHAPES = [(64, 1, 1472), (64, 33, 1472), (64, 257, 1472), (64, 1024, 1472),
               (1024, 1, 1472)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", NORM_SHAPES, ids=["x".join(map(str, s)) for s in NORM_SHAPES])
@pytest.mark.parametrize("with_delta", [True, False])
def test_add_rms_norm_kernel(card, shape, with_delta):
    h = _bf16(*shape, seed=1, device=card) * 3
    delta = _bf16(*shape, seed=2, device=card) if with_delta else None
    w = torch.rand(shape[-1], generator=torch.Generator().manual_seed(3)).to(card) + 0.5
    n0 = fe.KERNEL_LAUNCHES["add_rms_norm"]
    h_new, normed = fe.add_rms_norm(h, delta, w, EPS)
    torch.cuda.synchronize()
    assert fe.KERNEL_LAUNCHES["add_rms_norm"] == n0 + 1
    want_h = h + delta if with_delta else h
    assert torch.equal(h_new, want_h)
    x = want_h.float()
    ref = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w
    excess = _row_excess(normed, ref)
    assert excess.max() <= 1, f"row {int(excess.argmax())}: {float(excess.max())}"
    chain = tt5.rms_norm(want_h, w, EPS)
    assert (normed.float() - ref).abs().mean() <= (chain.float() - ref).abs().mean() * 1.01


GELU_CASES = {
    "wi_chunks": (64 * 257, 3584, True),
    "wi_chunks_1024": (64 * 1024, 3584, True),
    "split_wi0_wi1": (64 * 257, 3584, False),
    "decode_rows": (1024, 3584, True),
    "tp2_chunks": (64 * 257, 1792, True),
    "tp2_split": (64 * 33, 1792, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GELU_CASES))
def test_gated_gelu_kernel(card, case):
    n, f, chunked = GELU_CASES[case]
    if chunked:
        gate, up = (_bf16(n, 2 * f, seed=4, device=card) * 2).chunk(2, dim=-1)
    else:
        gate, up = _bf16(n, f, seed=4, device=card) * 2, _bf16(n, f, seed=5, device=card)
    n0 = fe.KERNEL_LAUNCHES["gated_gelu"]
    out = fe.gated_gelu(gate, up)
    torch.cuda.synchronize()
    assert fe.KERNEL_LAUNCHES["gated_gelu"] == n0 + 1
    # float64: float32's tanh form cancels where tanh(y) nears -1.
    x = gate.double()
    ref = 0.5 * x * (1.0 + torch.tanh(fe.GELU_C * (x + 0.044715 * x * x * x))) * up.double()
    excess = _row_excess(out, ref)
    assert excess.max() <= 1, f"row {int(excess.argmax())}: {float(excess.max())}"
    chain = tt5.gelu_new(gate) * up
    assert (out.double() - ref).abs().mean() < (chain.double() - ref).abs().mean()


def _cell_inputs(card, seed=11, rows=8):
    from perfbench import harness, traffic
    from perfbench import weights as pw

    sizes = harness.load_json(harness.HERE, "configs", "byt5-small-retriever.json")
    params = pw.make_t5(sizes, seed, card, torch.bfloat16, encoder_only=True)
    cfg = harness.port_t5_config(sizes, torch.bfloat16)
    lengths = np.array([1023, 700, 256, 100, 31, 500, 64, 5])[:rows]
    texts = traffic.texts(lengths, seed)
    rows_ids = [harness.byte_ids(t, 1024) for t in texts]
    width = max(map(len, rows_ids))
    ids = torch.zeros((len(rows_ids), width), dtype=torch.long)
    mask = torch.zeros_like(ids)
    for i, r in enumerate(rows_ids):
        ids[i, :len(r)] = torch.tensor(r)
        mask[i, :len(r)] = 1
    return sizes, params, cfg, ids.to(card), mask.to(card), rows_ids


def _embedding_gap(sizes, params, cfg, ids, mask, rows_ids):
    """The re-index cell's check at its configuration: the largest L2
    distance between the port's pooled unit embeddings and the float32
    reference's (``perfbench/reference/t5.py``)."""
    from perfbench import weights as pw
    from perfbench.reference import t5 as ref

    from reprover_tpu_torch.ops.pooling import masked_mean_normalize

    with torch.inference_mode():
        emb = masked_mean_normalize(tt5.encode(params, cfg, ids, mask), mask).float()
    params32 = pw.to_float32(params)
    gap = 0.0
    with ref.exact_matmuls():
        for i, r in enumerate(rows_ids):
            want = ref.embed(params32, sizes, torch.tensor(r, device=ids.device), "fp32")
            gap = max(gap, float((emb[i] - want).norm()))
    return gap


@pytest.mark.cuda
def test_encode_on_the_fused_path_matches_the_reference(card):
    inputs = _cell_inputs(card)
    before, launches = _layers(), dict(fe.KERNEL_LAUNCHES)
    gap = _embedding_gap(*inputs)
    assert _moved(before) == {"fused": 12, "plain": 0}
    assert fe.KERNEL_LAUNCHES["add_rms_norm"] == launches["add_rms_norm"] + 25
    assert fe.KERNEL_LAUNCHES["gated_gelu"] == launches["gated_gelu"] + 12
    assert gap <= 0.01, gap


def _norm_before_the_add(monkeypatch):
    real = fe.add_rms_norm

    def faulty(h, delta, w, eps):
        h_new, _ = real(h, delta, w, eps)
        return h_new, real(h, None, w, eps)[1]

    monkeypatch.setattr(fe, "add_rms_norm", faulty)


def _gate_for_up(monkeypatch):
    real = fe.gated_gelu
    monkeypatch.setattr(fe, "gated_gelu", lambda gate, up: real(gate, gate))


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [_norm_before_the_add, _gate_for_up],
                         ids=["norm-before-the-add", "gate-read-for-up"])
def test_planted_fault_fails_the_check(card, monkeypatch, fault):
    inputs = _cell_inputs(card)
    fault(monkeypatch)
    assert _embedding_gap(*inputs) > 0.01


@pytest.mark.cuda
def test_grad_on_the_card_takes_the_plain_path(card):
    params, cfg = _model(torch.bfloat16, base=CARD_CFG, device=card)
    for t in torch.utils._pytree.tree_leaves(params):
        t.requires_grad_(True)
    ids, mask, _ = (t.to(card) for t in _inputs())
    before = _layers()
    tt5.encode(params, cfg, ids, mask).float().sum().backward()
    assert _moved(before) == {"fused": 0, "plain": cfg.num_encoder_layers}


@pytest.mark.cuda
def test_decoders_fused_path_against_the_plain_path(card, monkeypatch):
    """decode, decode_step and the engine's step on the fused path against
    the same calls forced onto the plain path, at a width the kernels take."""
    params, cfg = _model(torch.bfloat16, base=CARD_CFG, device=card)
    ids, mask, dec = (t.to(card) for t in _inputs())
    with torch.no_grad():
        before = _layers()
        fused = _calls_on(params, cfg, ids, mask, dec)
        assert _moved(before)["plain"] == 0
        monkeypatch.setattr(fe, "plain_reason", lambda *a, **k: "device")
        plain = _calls_on(params, cfg, ids, mask, dec)
    for name, out in plain.items():
        want = out.float()
        assert (fused[name].float() - want).abs().max() <= 0.05 * want.abs().max(), name


def _calls_on(params, cfg, ids, mask, dec):
    enc = tt5.encode(params, cfg, ids, mask)
    state = tt5.init_decode_state(params, cfg, enc, mask, 8, num_beams=2)
    return {"encode": enc,
            "decode": tt5.decode(params, cfg, enc, mask, dec),
            "decode_step": tt5.decode_step(params, cfg, state, dec[:, 0].repeat_interleave(2))[0],
            "engine_step": _engine_step(params, cfg, enc, mask)}
