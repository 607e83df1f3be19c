"""PyTorch port on the card: the attention CUDA kernels (encoder, causal
decoder and cross-attention, the LLaMA family's scaled causal attention at
head width 64 and 128, and kernel 1's ablation variants; forward and
backward; the full-row and the long route) against their plain versions,
and the encoder, the teacher-forced decoder and the decoder-only loss
through the kernels against the CPU, forward and gradients; the forward's
and the backward's edges (lengths around the 64-row tile, ragged key
lengths, rows with no valid key, every mode on every route, a misaligned
bf16 operand, a misaligned output gradient). bf16 gradients are also held
row by row (``chip_smoke.grad_row_error``). These tests need a CUDA card and
skip elsewhere. The file imports no JAX, so it also runs on a machine
without it:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.ops import flash_attention as tfa
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

HEADS = 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(device, dtype, b, L, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, L, HEADS * 64)).astype(np.float32))
               .to(device, dtype) for _ in range(3))
    mask = torch.from_numpy((rng.random((b, L)) > 0.2).astype(np.int32)).to(device)
    if b > 1:
        mask[-1] = 0  # a row with no valid key: output 0, zero gradients
    mask[0, 0] = 1
    rel = torch.from_numpy(rng.normal(size=(32, HEADS)).astype(np.float32)).to(device)
    return q, k, v, mask, rel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, L", [(2, 200), (1, 64), (3, 7)])
def test_kernel_matches_plain(cuda_device, dtype, b, L):
    q, k, v, mask, rel = _case(cuda_device, dtype, b, L, L)
    before = dict(tfa.KERNEL_LAUNCHES)
    out = tfa.encoder_flash_attention(q, k, v, mask, rel, num_heads=HEADS)
    torch.cuda.synchronize()
    assert tfa.KERNEL_LAUNCHES["encoder_attn"] == before["encoder_attn"] + 1
    ref = tfa.encoder_attention_reference(q, k, v, mask, rel, num_heads=HEADS)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if b > 1:
        assert out[-1].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, L, max_distance", [(2, 200, 128), (1, 64, 128), (3, 7, 128),
                                                (2, 300, 32)])
def test_backward_kernels_match_plain(cuda_device, dtype, b, L, max_distance):
    """dq/dk/dv within 1e-4 (fp32) and d_rel within 1e-3 (its atomics sum
    L^2 terms in any order) of max(1, max|ref|), everything within 2e-2 of it
    in bf16, against autograd of the plain version; the LSE against its
    plain version."""
    q, k, v, mask, rel = _case(cuda_device, dtype, b, L, L + 1)
    dout = torch.randn(q.shape, device=cuda_device).to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rel)]
    before = dict(tfa.KERNEL_LAUNCHES)
    out = tfa.encoder_flash_attention(leaves[0], leaves[1], leaves[2], mask, leaves[3],
                                      num_heads=HEADS, max_distance=max_distance)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    for name in ("encoder_attn", "encoder_attn_bwd_dq", "encoder_attn_bwd_dkv"):
        assert tfa.KERNEL_LAUNCHES[name] == before[name] + 1, name

    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rel)]
    ref = tfa.encoder_attention_reference(ref_leaves[0], ref_leaves[1], ref_leaves[2], mask,
                                          ref_leaves[3], num_heads=HEADS,
                                          max_distance=max_distance)
    want = torch.autograd.grad(ref, ref_leaves, dout)
    tols = (1e-4, 1e-4, 1e-4, 1e-3) if dtype == torch.float32 else (2e-2,) * 4
    for name, g, w, tol in zip(("dq", "dk", "dv", "d_rel"), got, want, tols):
        scale = max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * scale, (name, err, scale)
    _check_grad_rows(got, _chain(dtype, tfa.ENCODER, q, k, v, mask, rel, dout, out,
                                 max_distance=max_distance), dtype, tfa.ENCODER, mask, q)
    if b > 1:
        for g in got[:3]:
            assert g[-1].abs().max().item() == 0.0

    mask32, rel32, table = tfa._kernel_operands(tfa.ENCODER, mask, rel, 32, max_distance)
    _, lse = tfa._forward_cuda(tfa.ENCODER, q, k, v, mask32, rel32, table, HEADS, max_distance,
                               True)
    lse_ref = tfa.encoder_attention_lse_reference(q, k, mask, rel, HEADS,
                                                  max_distance=max_distance)
    rows = mask.bool().any(dim=1)
    assert torch.isinf(lse[~rows]).all()
    assert (lse[rows] - lse_ref[rows]).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_encode_on_card_matches_cpu(cuda_device):
    """fp32 encode through the kernel equals fp32 encode on the CPU (plain
    attention) at head width 64."""
    cfg = tt5.T5Config(d_model=128, d_kv=64, d_ff=256, num_heads=2, num_encoder_layers=2,
                       num_decoder_layers=1)
    params = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(3, 259, (3, 150)))
    mask = torch.ones((3, 150), dtype=torch.int32)
    mask[1, 100:] = 0
    cpu = tt5.encode(params, cfg, ids, mask)
    on_card = tt5.place_params(params, cfg, cuda_device)
    before = dict(tfa.KERNEL_LAUNCHES)
    gpu = tt5.encode(on_card, cfg, ids.to(cuda_device), mask.to(cuda_device)).cpu()
    assert tfa.KERNEL_LAUNCHES["encoder_attn"] == before["encoder_attn"] + cfg.num_encoder_layers
    np.testing.assert_allclose(gpu.numpy(), cpu.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_encode_gradients_on_card_match_cpu(cuda_device, remat):
    """fp32 master params that require grad: every parameter gradient of a
    pooled-embedding loss through the kernels equals the CPU's (plain
    autograd). Before the backward kernels, the card path returned outputs
    with no grad_fn and q/k/v/rel_bias silently got no gradient."""
    from reprover_tpu_torch.ops.pooling import masked_mean_normalize
    from reprover_tpu_torch.training.tasks import param_leaves

    cfg = tt5.T5Config(d_model=128, d_kv=64, d_ff=256, num_heads=2, num_encoder_layers=2,
                       num_decoder_layers=1, remat=remat)
    full = tt5.init_params(cfg, torch.Generator().manual_seed(0))
    base = tt5.fuse_mlp_params({"shared_embedding": full["shared_embedding"],
                                "encoder": full["encoder"]})
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(3, 259, (3, 150)))
    mask = torch.ones((3, 150), dtype=torch.int32)
    mask[1, 90:] = 0
    target = torch.from_numpy(rng.normal(size=(3, cfg.d_model)).astype(np.float32))

    def grads(device):
        params = tt5.place_master_params(base, device)
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        emb = masked_mean_normalize(tt5.encode(params, cfg, ids.to(device), mask.to(device)),
                                    mask.to(device))
        (emb * target.to(device)).sum().backward()
        return [t.grad.cpu() for t in leaves]

    before = dict(tfa.KERNEL_LAUNCHES)
    on_card = grads(cuda_device)
    torch.cuda.synchronize()
    for name in ("encoder_attn_bwd_dq", "encoder_attn_bwd_dkv"):
        assert tfa.KERNEL_LAUNCHES[name] == before[name] + cfg.num_encoder_layers, name
    cpu = grads(torch.device("cpu"))
    for g, w in zip(on_card, cpu):
        scale = max(1e-6, w.abs().max().item())
        assert (g - w).abs().max().item() <= 1e-3 * scale
        assert g.abs().max().item() > 0


def _decoder_case(device, dtype, b, t, s, seed):
    """q [b, t], k/v [b, s] at 6 heads x 64, ragged encoder mask (every row
    keeps a valid key), a masked key >= 100 above query 0's valid scores in
    row 0, random bias and output gradient."""
    rng = np.random.default_rng(seed)

    def x(n):
        return torch.from_numpy(rng.normal(size=(b, n, HEADS * 64)).astype(np.float32))

    q, k, v = x(t), x(s), x(s)
    lengths = rng.integers(s // 2, s + 1, b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    mask[0, s - 3] = 0
    qh = q[0, 0, :64]
    best = float((k[0, :, :64] @ qh)[torch.from_numpy(mask[0]).bool()].max())
    k[0, s - 3, :64] = qh * ((best + 120.0) / float(qh @ qh))
    rel = torch.from_numpy(rng.normal(size=(32, HEADS)).astype(np.float32))
    dout = x(t)
    return ([t_.to(device, dtype) for t_ in (q, k, v)], torch.from_numpy(mask).to(device),
            rel.to(device), dout.to(device, dtype))


def _check_grads(got, want, dtype):
    """fp32 within 1e-4 (d_rel 1e-3), bf16 within 2e-2, of max(1, max|ref|)."""
    for i, (g, w) in enumerate(zip(got, want)):
        tol = 2e-2 if dtype == torch.bfloat16 else (1e-3 if i == 3 else 1e-4)
        scale = max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * scale, (i, err, scale)


def _check_grad_rows(got, want, dtype, mode, mask, q, heads=HEADS):
    """bf16 dq, dk, dv (the first three of ``got``) also row by row against
    ``want``, the backward's algorithm in plain torch (``_chain``, or the
    step-by-step plain versions): each (batch row, position, head) within
    2e-2 of its own max|ref| plus 2e-3 x max(1, max|ref|), the rows of
    queries with no valid key and of masked keys exactly zero
    (``chip_smoke.grad_row_error``). Returns the largest reading (0 for
    fp32, which the limits above already hold to 1e-4)."""
    if dtype != torch.bfloat16:
        return 0.0
    zero_q, zero_k = chip_smoke.zero_grad_rows(tfa, mode, mask, q)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got[:3], want[:3])):
        ratio = chip_smoke.grad_row_error(g, w, heads, zero_q if i == 0 else zero_k)
        assert ratio <= chip_smoke.BF16_REL_TOL, (("dq", "dk", "dv")[i], ratio)
        worst = max(worst, ratio)
    return worst


def _chain(dtype, mode, q, k, v, mask, rel, dout, out, heads=HEADS, max_distance=128):
    """``chip_smoke.plain_grad_chain`` for bf16 (None for fp32, which has no
    row check): the reference of a gradient taken through the kernels'
    autograd, delta from ``out``, the forward kernel's output."""
    if dtype != torch.bfloat16:
        return None
    return chip_smoke.plain_grad_chain(tfa, mode, q, k, v, mask, rel, dout, heads, max_distance,
                                       out.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, t, max_distance", [(2, 200, 128), (1, 64, 128), (3, 7, 128),
                                                (2, 300, 32)])
def test_causal_kernels_match_plain(cuda_device, dtype, b, t, max_distance):
    """Causal forward, LSE and autograd backward (kernels 1c, 3c, 4c) against
    the plain version."""
    (q, k, v), _, rel, dout = _decoder_case(cuda_device, dtype, b, t, t, t)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, rel)]
    names = ("causal_attn", "causal_attn_bwd_dq", "causal_attn_bwd_dkv")
    before = dict(tfa.KERNEL_LAUNCHES)
    out = tfa.causal_flash_attention(*leaves, num_heads=HEADS, max_distance=max_distance)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    for name in names:
        assert tfa.KERNEL_LAUNCHES[name] == before[name] + 1, name
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v, rel)]
    ref = tfa.causal_attention_reference(*ref_leaves, num_heads=HEADS, max_distance=max_distance)
    want = torch.autograd.grad(ref, ref_leaves, dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    _check_grads(got, want, dtype)
    ones = torch.ones((b, t), dtype=torch.int32, device=cuda_device)
    _check_grad_rows(got, _chain(dtype, tfa.CAUSAL, q, k, v, ones, rel, dout, out,
                                 max_distance=max_distance), dtype, tfa.CAUSAL, ones, q)

    mask32, rel32, table = tfa._kernel_operands(tfa.CAUSAL, ones, rel, 32, max_distance)
    _, lse = tfa._forward_cuda(tfa.CAUSAL, q, k, v, mask32, rel32, table, HEADS, max_distance,
                               True)
    lse_ref = tfa.causal_attention_lse_reference(q, k, rel, HEADS, max_distance=max_distance)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, t, s", [(2, 128, 384), (3, 200, 1000), (1, 7, 64)])
def test_cross_kernels_match_plain(cuda_device, dtype, b, t, s):
    """Cross forward, LSE and autograd backward (kernels 8, 9, 10) against
    the plain version; an encoder row with no valid key gives 0 and zero
    gradients."""
    (q, k, v), mask, _, dout = _decoder_case(cuda_device, dtype, b, t, s, t + s)
    if b > 2:
        mask[-1] = 0
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    names = ("cross_attn", "cross_attn_bwd_dq", "cross_attn_bwd_dkv")
    before = dict(tfa.KERNEL_LAUNCHES)
    out = tfa.cross_flash_attention(leaves[0], leaves[1], leaves[2], mask, num_heads=HEADS)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    for name in names:
        assert tfa.KERNEL_LAUNCHES[name] == before[name] + 1, name
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = tfa.cross_attention_reference(ref_leaves[0], ref_leaves[1], ref_leaves[2], mask,
                                        num_heads=HEADS)
    want = torch.autograd.grad(ref, ref_leaves, dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    _check_grads(got, want, dtype)
    _check_grad_rows(got, _chain(dtype, tfa.CROSS, q, k, v, mask, None, dout, out), dtype,
                     tfa.CROSS, mask, q)
    if b > 2:
        assert out[-1].abs().max().item() == 0.0
        for g in got:
            assert g[-1].abs().max().item() == 0.0

    mask32, _, _ = tfa._kernel_operands(tfa.CROSS, mask, None, 32, 128)
    _, lse = tfa._forward_cuda(tfa.CROSS, q, k, v, mask32, None, None, HEADS, 128, True)
    lse_ref = tfa.cross_attention_lse_reference(q, k, mask, HEADS)
    rows = mask.bool().any(dim=1)
    assert torch.isinf(lse[~rows]).all()
    assert (lse[rows] - lse_ref[rows]).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_generation_loss_gradients_on_card_match_cpu(cuda_device, remat):
    """fp32 master params: the seq2seq loss and every parameter gradient
    through the nine kernels equal the CPU's (plain autograd), at head width
    64 with ragged sources and -100 label padding."""
    from reprover_tpu_torch.training.tasks import generation_loss, param_leaves

    cfg = tt5.T5Config(d_model=128, d_kv=64, d_ff=256, num_heads=2, num_encoder_layers=2,
                       num_decoder_layers=2, remat=remat)
    base = tt5.fuse_mlp_params(tt5.init_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(3)
    state_ids = torch.from_numpy(rng.integers(3, 259, (3, 150)))
    state_mask = torch.ones((3, 150), dtype=torch.int32)
    state_mask[1, 90:] = 0
    tactic_ids = torch.from_numpy(rng.integers(3, 259, (3, 70)))
    tactic_ids[2, 40:] = -100

    def run(device):
        params = tt5.place_master_params(base, device)
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        batch = {"state_ids": state_ids.to(device), "state_mask": state_mask.to(device),
                 "tactic_ids": tactic_ids.to(device)}
        loss = generation_loss(params, cfg, batch)
        loss.backward()
        return loss.item(), [t.grad.cpu() for t in leaves]

    before = dict(tfa.KERNEL_LAUNCHES)
    loss_card, on_card = run(cuda_device)
    torch.cuda.synchronize()
    # The T5 attentions' full-row kernels (no length passes 4096); the scaled
    # causal mode is the decoder-only family's.
    for name in (n for n in tfa.KERNEL_LAUNCHES if not n.startswith("scaled_causal_attn")):
        assert (tfa.KERNEL_LAUNCHES[name] > before[name]) == ("_long" not in name), name
    loss_cpu, cpu = run(torch.device("cpu"))
    assert abs(loss_card - loss_cpu) <= 1e-4 * max(1.0, abs(loss_cpu))
    for g, w in zip(on_card, cpu):
        scale = max(1e-6, w.abs().max().item())
        assert (g - w).abs().max().item() <= 1e-3 * scale


# ------------------------------------------------------------------ #
# The long route: kernels 2, 5, 6, 7
# ------------------------------------------------------------------ #


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode, b, t, s, max_distance", [
    (tfa.ENCODER, 3, 300, 300, 32), (tfa.ENCODER, 2, 1000, 1000, 128),
    (tfa.CAUSAL, 2, 333, 333, 128), (tfa.CAUSAL, 1, 200, 200, 32),
    (tfa.CROSS, 3, 200, 1000, 128), (tfa.CROSS, 2, 70, 130, 128)])
def test_long_kernels_match_plain(cuda_device, dtype, mode, b, t, s, max_distance):
    """The long route forced with ``block_kv``: kernel 2's output and kernel
    5's LSE against their plain versions, and the autograd gradients
    (kernels 5, 6, 7) against autograd of the full-row plain version; an
    encoder row with no valid key gives 0 and zero gradients."""
    (q, k, v), mask, rel, dout = _decoder_case(cuda_device, dtype, b, t, s, t + s + mode)
    if mode == tfa.CAUSAL:
        mask = torch.ones_like(mask)
    elif b > 2:
        mask[-1] = 0
    if mode == tfa.CROSS:
        rel = None
    fns = {
        tfa.ENCODER: (lambda q, k, v, r: tfa.encoder_flash_attention(
                          q, k, v, mask, r, HEADS, max_distance=max_distance, block_kv=64),
                      lambda q, k, v, r: tfa.encoder_attention_reference(
                          q, k, v, mask, r, HEADS, max_distance=max_distance)),
        tfa.CAUSAL: (lambda q, k, v, r: tfa.causal_flash_attention(
                         q, k, v, r, HEADS, max_distance=max_distance, block_kv=64),
                     lambda q, k, v, r: tfa.causal_attention_reference(
                         q, k, v, r, HEADS, max_distance=max_distance)),
        tfa.CROSS: (lambda q, k, v, r: tfa.cross_flash_attention(q, k, v, mask, HEADS,
                                                                 block_kv=64),
                    lambda q, k, v, r: tfa.cross_attention_reference(q, k, v, mask, HEADS)),
    }
    kernel, plain = fns[mode]
    n = 3 if rel is None else 4
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, rel)[:n]]
    base = tfa.KERNEL_NAMES[mode]
    names = [base + "_long" + part for part in ("", "_lse", "_bwd_dq", "_bwd_dkv")]
    before = dict(tfa.KERNEL_LAUNCHES)
    out = kernel(*leaves, *([None] * (4 - n)))
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    for name in tfa.KERNEL_LAUNCHES:
        assert tfa.KERNEL_LAUNCHES[name] == before[name] + (name in names), name
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v, rel)[:n]]
    ref = plain(*ref_leaves, *([None] * (4 - n)))
    want = torch.autograd.grad(ref, ref_leaves, dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    long_ref = tfa.long_attention_reference(mode, q, k, v, mask, rel, HEADS,
                                            max_distance=max_distance)
    assert (out.float() - long_ref.float()).abs().max().item() <= tol
    _check_grads(got, want, dtype)
    _check_grad_rows(got, _chain(dtype, mode, q, k, v, mask, rel, dout, out,
                                 max_distance=max_distance), dtype, mode, mask, q)
    if mode != tfa.CAUSAL and b > 2:
        assert out[-1].abs().max().item() == 0.0
        for g in got[:3]:
            assert g[-1].abs().max().item() == 0.0

    mask32, rel32, table = tfa._kernel_operands(mode, mask, rel, 32, max_distance)
    _, lse = tfa._forward_cuda(mode, q, k, v, mask32, rel32, table, HEADS, max_distance, True,
                               tfa.LONG_LSE)
    lse_ref = tfa.long_lse_reference(mode, q, k, mask, rel, HEADS, max_distance=max_distance)
    rows = torch.isfinite(lse_ref)
    assert torch.equal(torch.isinf(lse), ~rows)
    assert (lse[rows] - lse_ref[rows]).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_long_generation_loss_gradients_on_card_match_cpu(cuda_device):
    """``flash_block_kv``: the encoder on the long route (kernels 2, 5, 6, 7),
    the loss and every parameter gradient on the card equal the CPU's (the
    long route's plain versions)."""
    from reprover_tpu_torch.training.tasks import generation_loss, param_leaves

    cfg = tt5.T5Config(d_model=128, d_kv=64, d_ff=256, num_heads=2, num_encoder_layers=2,
                       num_decoder_layers=1, remat=True, flash_block_kv=128)
    base = tt5.fuse_mlp_params(tt5.init_params(cfg, torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(4)
    state_ids = torch.from_numpy(rng.integers(3, 259, (2, 400)))
    state_mask = torch.ones((2, 400), dtype=torch.int32)
    state_mask[1, 250:] = 0
    tactic_ids = torch.from_numpy(rng.integers(3, 259, (2, 50)))

    def run(device):
        params = tt5.place_master_params(base, device)
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        batch = {"state_ids": state_ids.to(device), "state_mask": state_mask.to(device),
                 "tactic_ids": tactic_ids.to(device)}
        loss = generation_loss(params, cfg, batch)
        loss.backward()
        return loss.item(), [t.grad.cpu() for t in leaves]

    before = dict(tfa.KERNEL_LAUNCHES)
    loss_card, on_card = run(cuda_device)
    torch.cuda.synchronize()
    for name in ("encoder_attn_long", "encoder_attn_long_lse", "encoder_attn_long_bwd_dq",
                 "encoder_attn_long_bwd_dkv"):
        assert tfa.KERNEL_LAUNCHES[name] > before[name], name
    assert tfa.KERNEL_LAUNCHES["encoder_attn"] == before["encoder_attn"]
    loss_cpu, cpu = run(torch.device("cpu"))
    assert abs(loss_card - loss_cpu) <= 1e-4 * max(1.0, abs(loss_cpu))
    for g, w in zip(on_card, cpu):
        scale = max(1e-6, w.abs().max().item())
        assert (g - w).abs().max().item() <= 1e-3 * scale


# ------------------------------------------------------------------ #
# Serving kernels: beam reorder (kernel 13), w8a16 and w4a16 (11, 12)
# ------------------------------------------------------------------ #


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["default", "bulk", "vector"])
@pytest.mark.parametrize("index", [torch.int64, torch.int32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, t_live", [((2, 3, 4, 2, 9, 64), 9), ((2, 3, 4, 2, 9, 64), 5),
                                           ((1, 2, 8, 4, 17, 128), 11),
                                           ((2, 3, 3, 2, 300, 64), 257),
                                           ((1, 3, 2, 1, 140, 128), 129)])
def test_beam_reorder_kernel_bit_equal(cuda_device, dtype, shape, t_live, index, branch,
                                       monkeypatch):
    """The gather kernel equals its plain version bit for bit on a T prefix
    of the full buffers, with a frozen slot, a column past t_live and one at
    t_live - 1, int64 and int32 indices, by either branch (spans of one
    chunk and of several in the bulk branch)."""
    from reprover_tpu_torch.ops import beam_reorder as br

    if branch != "default":
        monkeypatch.setattr(br, "VECTOR_ROW_BYTES", 1 << 30 if branch == "bulk" else 16)
    gen = torch.Generator(device=cuda_device).manual_seed(t_live)
    L, S, K, H, T, d = shape
    k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype) for _ in range(2))
    kc, vc = (torch.randn((L, S, K, H, 1, d), generator=gen, device=cuda_device).to(dtype)
              for _ in range(2))
    parent = torch.randint(0, K, (S, K), generator=gen, device=cuda_device).to(index)
    frozen = torch.zeros(S, dtype=torch.bool, device=cuda_device)
    frozen[-1] = True
    pos = torch.randint(0, t_live, (S,), generator=gen, device=cuda_device).to(index)
    pos[0] = t_live + 1 if t_live + 1 < T else pos[0]
    if S > 2:
        pos[1] = t_live - 1
    out_k, out_v = torch.zeros_like(k), torch.zeros_like(v)
    before = br.KERNEL_LAUNCHES["beam_reorder"]
    br.reorder_append_gather(k[..., :t_live, :], v[..., :t_live, :], kc, vc, parent, frozen, pos,
                             out_k[..., :t_live, :], out_v[..., :t_live, :])
    torch.cuda.synchronize()
    assert br.KERNEL_LAUNCHES["beam_reorder"] == before + 1
    want_k, want_v = br.reorder_append_gather_reference(
        k[..., :t_live, :], v[..., :t_live, :], kc, vc, parent, frozen, pos)
    assert torch.equal(out_k[..., :t_live, :], want_k) and torch.equal(out_v[..., :t_live, :], want_v)
    assert bool((out_k[..., t_live:, :] == 0).all())  # untouched past t_live


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m, k, n", [(32, 4096, 1024), (5, 256, 200), (130, 1472, 384),
                                     (1100, 512, 512)])
def test_quant_matmul_kernels_match_plain(cuda_device, bits, m, k, n):
    """w8a16 / w4a16 kernels against their plain versions in bf16, within
    2e-2 of max(1, max|ref|) (bf16 output rounding; fp32 sums in another
    order), bf16 and fp32 outputs, ragged M/N edges and split-K decode."""
    from reprover_tpu_torch.models import quantize as qz
    from reprover_tpu_torch.ops import quant_matmul as qm

    rng = np.random.default_rng(m + k + n + bits)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    for out_dtype in (torch.bfloat16, torch.float32):
        if bits == 8:
            qw = qz.quantize_weight(w).to(cuda_device)
            name = "quant_matmul"
            got = qm.quant_matmul(x, qw.q, qw.scale.reshape(-1), out_dtype=out_dtype)
            ref = qm.quant_matmul_reference(x, qw.q, qw.scale, out_dtype=torch.float32)
        else:
            qw = qz.quantize_weight4(w, group=64).to(cuda_device)
            name = "quant4_matmul"
            got = qm.quant4_matmul(x, qw.q, qw.scale, qw.group, out_dtype=out_dtype)
            ref = qm.quant4_matmul_reference(x, qw.q, qw.scale, qw.group, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and qm.KERNEL_LAUNCHES[name] > 0
        tol = 2e-2 * max(1.0, ref.abs().max().item())
        assert (got.float() - ref).abs().max().item() <= tol


QUANT_EDGE_M = [1, 31, 32, 33, 64, 65, 129, 2044]
# (K, bits, group): int8; int4 at groups 64 and 128, where a 64-deep k tile
# lies in one group, and at groups 16 and 32, where one tile holds several
# (LLaMA-7B's down projection takes group 32 at K 11008).
QUANT_EDGE_WEIGHTS = [(1472, 8, 0), (1472, 4, 64), (11008, 8, 0), (11008, 4, 64),
                      (11008, 4, 128), (1472, 4, 32), (11008, 4, 32), (1472, 4, 16),
                      (11008, 4, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("k, bits, group", QUANT_EDGE_WEIGHTS)
@pytest.mark.parametrize("m", QUANT_EDGE_M)
def test_quant_matmul_edges_match_plain(cuda_device, m, k, bits, group):
    """The w8a16 / w4a16 kernels around their tiles: decode rows (1-64: 32
    or 64 wide), admission rows (65, 129, 2044: 256-row tiles, a ragged
    last one), N = 320 (a ragged 128-channel tile), split K;
    bf16 and fp32 outputs within 2e-2 of max(1, max|ref|) and every output
    row within 2e-2 of its own max|ref| (``chip_smoke.row_error``); two
    launches bit-equal; the tensor-core body on aligned operands, and a
    weight view at an odd offset (the simple body) held alike."""
    from reprover_tpu_torch.ops import quant_matmul as qm

    n = 320
    rng = np.random.default_rng(m * 7 + k + bits + group)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    rows = k if bits == 8 else k // 2
    raw = rng.integers(-127, 128, size=(rows, n)) if bits == 8 else rng.integers(0, 256, size=(rows, n))
    w = torch.from_numpy(raw.astype(np.int8 if bits == 8 else np.uint8)).to(cuda_device)
    scale_shape = (n,) if bits == 8 else (k // group, n)
    scale = torch.from_numpy(rng.uniform(1e-3, 2e-2, size=scale_shape).astype(np.float32)).to(
        cuda_device)
    # The same bytes at an odd address: a contiguous view one byte into a buffer.
    buf = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda_device)
    odd = buf[1:].view(w.shape)
    odd.copy_(w)

    def run(weight, out_dtype):
        if bits == 8:
            return qm.quant_matmul(x, weight, scale, out_dtype=out_dtype)
        return qm.quant4_matmul(x, weight, scale, group, out_dtype=out_dtype)

    ref = (qm.quant_matmul_reference(x, w, scale, torch.float32) if bits == 8 else
           qm.quant4_matmul_reference(x, w, scale, group, torch.float32))
    tol = 2e-2 * max(1.0, ref.abs().max().item())
    assert qm.plan_for(bits, x, w, scale, group).body == "tma"
    assert qm.plan_for(bits, x, odd, scale, group).body == "simple"
    for weight, body in ((w, "tma"), (odd, "simple")):
        for out_dtype in (torch.bfloat16, torch.float32):
            before = qm.BODY_LAUNCHES[body]
            got, again = run(weight, out_dtype), run(weight, out_dtype)
            torch.cuda.synchronize()
            assert qm.BODY_LAUNCHES[body] == before + 2
            assert got.dtype == out_dtype and got.shape == (m, n)
            assert torch.equal(got, again)
            assert (got.float() - ref).abs().max().item() <= tol
            assert chip_smoke.row_error(got[None], ref[None], 1) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, t, h, d, block_kv", [(3, 1000, 4, 128, 0), (2, 256, 4, 64, 0),
                                                  (2, 640, 2, 128, 64), (1, 7, 2, 128, 0)])
def test_scaled_causal_kernels_match_plain(cuda_device, dtype, b, t, h, d, block_kv):
    """The scaled causal kernels (kernels 1s/3s/4s, or 2/5/6/7 on the long
    route) against their plain version: a ragged key mask and a left-padded
    row, whose padded queries have no valid key (0, zero gradients)."""
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    q, k, v, dout = (torch.randn((b, t, h * d), generator=gen, device=cuda_device).to(dtype)
                     for _ in range(4))
    mask = torch.ones((b, t), dtype=torch.int32, device=cuda_device)
    mask[0, t - t // 3:] = 0
    mask[-1, : t // 4] = 0
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa.scaled_causal_flash_attention(*leaves, mask, h, d ** -0.5, block_kv=block_kv)
    got = torch.autograd.grad(out, leaves, dout)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = tfa.scaled_causal_attention_reference(*plain, mask, h, d ** -0.5)
    want = torch.autograd.grad(ref, plain, dout)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    for g, w in [(out, ref)] + list(zip(got, want)):
        tol = (2e-2 if bf16 else 1e-4) * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol
    chain = _chain(dtype, tfa.SCALED_CAUSAL, tfa.scale_queries(q, d ** -0.5), k, v, mask, None,
                   dout, out, h)
    if chain is not None:  # dq with respect to q, as autograd through scale_queries gives it
        chain = ((chain[0].float() * d ** -0.5).to(dtype),) + chain[1:]
    _check_grad_rows(got, chain, dtype, tfa.SCALED_CAUSAL, mask, q, h)
    if t // 4:
        assert out[-1, : t // 4].abs().max().item() == 0.0
        assert all(g[-1, : t // 4].abs().max().item() == 0.0 for g in got)


@pytest.mark.cuda
def test_causal_lm_loss_gradients_on_card_match_cpu(cuda_device):
    """``causal_lm_loss`` with the fused attention (head width 128, GQA) on
    the card in fp32 against the CPU: the loss within 1e-4, every gradient
    within 1e-3 of max(1, max|ref|)."""
    from reprover_tpu_torch.models import causal_lm as tcl

    cfg = tcl.CausalLMConfig(vocab_size=96, d_model=256, num_layers=2, num_heads=2,
                             num_kv_heads=1, d_ff=128, flash_attention=True)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(3, 96, (2, 256)))
    mask = torch.ones_like(ids)
    mask[1, 200:] = 0
    labels = torch.where(mask == 1, ids, -100)
    params = tcl.init_params(cfg, torch.Generator().manual_seed(0))
    grads = {}
    for dev in ("cpu", cuda_device):
        with torch.no_grad():
            leaves = tcl.place_params(params, cfg, dev)
        flat = [leaves["embedding"], leaves["lm_head"], leaves["final_norm"]] + list(
            leaves["layers"].values())
        for t in flat:
            t.requires_grad_(True)
        loss = tcl.causal_lm_loss(leaves, cfg, ids.to(dev), mask.to(dev), labels.to(dev))
        grads[str(dev)] = (loss.item(), [g.cpu() for g in torch.autograd.grad(loss, flat)])
    assert tfa.KERNEL_LAUNCHES["scaled_causal_attn_bwd_dkv"] > 0
    (cpu_loss, cpu_grads), (card_loss, card_grads) = grads.values()
    assert abs(card_loss - cpu_loss) <= 1e-4
    for g, w in zip(card_grads, cpu_grads):
        assert (g - w).abs().max().item() <= 1e-3 * max(1.0, w.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bisect_variants_match_plain(cuda_device, dtype):
    """Kernel 14: each ablation variant of kernel 1 against its plain
    version (``variant_error``'s limits, from the output's own size), and
    ``full`` bit-equal to kernel 1. ``nosoftmax`` runs on all keys (a masked
    key adds -1e10, which would swamp the rest of its row), and on the
    ragged mask only the row with masked keys is compared, to show the
    mask term is there."""
    from reprover_tpu_torch.benchmarks import flash_kernel_bisect as fkb

    q, k, v, mask, rel = _case(cuda_device, dtype, 2, 200, 5)
    mask[-1] = 1
    every = torch.ones_like(mask)
    for variant in fkb.VARIANTS:
        m = every if variant == "nosoftmax" else mask
        got = fkb.bisect_attention(variant, q, k, v, m, rel, HEADS)
        want = fkb.bisect_attention_reference(variant, q, k, v, m, rel, HEADS)
        check = fkb.variant_error(got, want)
        assert check["ok"], (variant, check)
    row0 = (q[:1], k[:1], v[:1], mask[:1], rel)  # about 20% of its keys masked
    want = fkb.bisect_attention_reference("nosoftmax", *row0, HEADS)
    assert want.float().abs().max().item() > 1e5
    assert fkb.variant_error(fkb.bisect_attention("nosoftmax", *row0, HEADS), want)["ok"]
    assert torch.equal(fkb.bisect_attention("full", q, k, v, mask, rel, HEADS),
                       tfa.encoder_flash_attention(q, k, v, mask, rel, HEADS))


# ------------------------------------------------------------------ #
# The forward's edges: the bf16 body (tensor cores, TMA tiles) and the fp32
# body, every mode on every route
# ------------------------------------------------------------------ #

# (mode, batch, query length, key length, head width, max_distance): the
# self-attentions at lengths around the 64-row tile, cross-attention with
# key lengths that are not multiples of 64, head width 128 at T = 1000, and
# max_distance 32 so that far tile pairs (one bias scalar) and clamped near
# pairs both occur.
FORWARD_EDGES = (
    [(tfa.ENCODER, 2, n, n, 64, 128) for n in (1, 63, 64, 65, 129)]
    + [(tfa.CAUSAL, 2, n, n, 64, 128) for n in (1, 63, 64, 65, 129)]
    + [(tfa.SCALED_CAUSAL, 2, n, n, 64, 0) for n in (1, 63, 64, 65, 129)]
    + [(tfa.SCALED_CAUSAL, 2, n, n, 128, 0) for n in (65, 129, 1000)]
    + [(tfa.CROSS, 3, t, s, 64, 0) for t, s in ((1, 1), (63, 65), (65, 129), (7, 1000),
                                                (130, 200))]
    + [(tfa.ENCODER, 2, 333, 333, 64, 32), (tfa.CAUSAL, 1, 300, 300, 64, 32)]
)


def _edge_case(device, dtype, mode, b, t, s, d, seed):
    """q [b, t, H*d], k/v [b, s, H*d] (2 heads at d 128, else 6); a ragged key
    mask whose last batch row has no valid key (all ones for CAUSAL); the
    bias table for the modes that have one."""
    heads = 2 if d == 128 else HEADS
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, heads * d)) * (d ** -0.5 if mode == tfa.SCALED_CAUSAL else 1.0)
    k, v = (rng.normal(size=(b, s, heads * d)) for _ in range(2))
    mask = (rng.random((b, s)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    if mode == tfa.CAUSAL:
        mask[:] = 1
    elif b > 1:
        mask[-1] = 0
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(device, dtype) for x in (q, k, v))
    rel = None
    if tfa.has_bias(mode):
        rel = torch.from_numpy(rng.normal(size=(32, heads)).astype(np.float32)).to(device)
    return q, k, v, torch.from_numpy(mask).to(device), rel, heads


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", [tfa.FULL_ROW, tfa.LONG, tfa.LONG_LSE])
@pytest.mark.parametrize("mode, b, t, s, d, max_distance", FORWARD_EDGES)
def test_forward_edges_match_plain(cuda_device, dtype, route, mode, b, t, s, d, max_distance):
    """One forward launch (kernel 1, 1c, 1s, 8 on the full-row route, 2 on
    the long one, 5 the LSE sweep) against the plain online-softmax sweep:
    out within 1e-4 (fp32) or 2e-2 of max(1, max|ref|) (bf16), bf16 also
    each (row, head) within 2e-2 of its own max|ref| (``chip_smoke.row_error``),
    the LSE within 1e-3 where finite; a row with no valid key gives 0 and
    LSE +inf; the launch counted under its own name."""
    q, k, v, mask, rel, heads = _edge_case(cuda_device, dtype, mode, b, t, s, d, t * 7 + s)
    mask32, rel32, table = tfa._kernel_operands(mode, mask, rel, 32, max_distance)
    name = tfa.KERNEL_NAMES[mode] + tfa.ROUTE_SUFFIX[route]
    before = tfa.KERNEL_LAUNCHES[name]
    out, lse = tfa._forward_cuda(mode, q, k, v, mask32, rel32, table, heads, max_distance,
                                 route != tfa.LONG, route)
    torch.cuda.synchronize()
    assert tfa.KERNEL_LAUNCHES[name] == before + 1
    md = max_distance or 128
    lse_ref = tfa.long_lse_reference(mode, q, k, mask, rel, heads, max_distance=md)
    empty = torch.isinf(lse_ref)  # [B, H, Lq]: rows with no valid key
    if route != tfa.LONG_LSE:
        ref = tfa.long_attention_reference(mode, q, k, v, mask, rel, heads, max_distance=md)
        tol = 1e-4 if dtype == torch.float32 else 2e-2 * max(1.0, ref.float().abs().max().item())
        assert torch.isfinite(out).all()
        assert (out.float() - ref.float()).abs().max().item() <= tol
        if dtype == torch.bfloat16:
            assert chip_smoke.row_error(out, ref, heads) <= 2e-2
        rows = empty.all(dim=1)  # [B, Lq]: no valid key in any head
        if rows.any():
            assert out[rows].abs().max().item() == 0.0
    if route != tfa.LONG:
        assert torch.equal(torch.isinf(lse), empty)
        assert (lse[~empty] - lse_ref[~empty]).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_misaligned_bf16_operand_raises(cuda_device):
    """The bf16 forward reads q, k and v through TMA tensor maps, which need
    16-byte aligned bases: a view at an odd offset raises in the wrapper's
    checks, and the C entry refuses it too when called past them."""
    q, k, v, mask, rel = _case(cuda_device, torch.bfloat16, 2, 64, 0)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tfa.encoder_flash_attention(shifted, k, v, mask, rel, num_heads=HEADS)
    mask32, rel32, table = tfa._kernel_operands(tfa.ENCODER, mask, rel, 32, 128)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfa._forward_cuda(tfa.ENCODER, shifted, k, v, mask32, rel32, table, HEADS, 128, False)
    out = tfa.encoder_flash_attention(q, k, v, mask, rel, num_heads=HEADS)  # aligned: runs
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", [tfa.FULL_ROW, tfa.LONG])
@pytest.mark.parametrize("mode, b, t, s, d, max_distance", FORWARD_EDGES)
def test_backward_edges_match_plain(cuda_device, dtype, route, mode, b, t, s, d, max_distance):
    """One dQ and one dK/dV launch (kernels 3, 4 and their causal, cross
    and scaled forms on the full-row route, 6 and 7 on the long one) on the
    plain LSE and delta, against the plain step-by-step backward: dq, dk, dv
    within 1e-4 (fp32) or 2e-2 of max(1, max|ref|) (bf16, and row by row,
    ``chip_smoke.grad_row_error``), d_rel within 1e-3 (fp32) or 2e-2 of
    max(1, max|ref|); the rows of queries with no valid key (a batch row
    with none, three left-padded scaled causal queries) and of masked keys
    exactly zero; each launch counted under its own name. Prints the row
    check's reading as a ``[bwd_edge]`` line."""
    q, k, v, mask, rel, heads = _edge_case(cuda_device, dtype, mode, b, t, s, d, t * 7 + s + 1)
    if mode == tfa.SCALED_CAUSAL and t > 3:
        mask[0, :3] = 0
    rng = np.random.default_rng(t + s)
    dout = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32)).to(cuda_device, dtype)
    md = max_distance or 128
    lse = tfa.long_lse_reference(mode, q, k, mask, rel, heads, max_distance=md)
    out = tfa.long_attention_reference(mode, q, k, v, mask, rel, heads, max_distance=md)
    delta = tfa.row_delta(dout, out, heads)
    plain = (mode, q, k, v, dout, mask, rel, lse, delta, heads, 32, md)
    dq_ref, bins_ref = tfa.long_backward_dq_reference(*plain)
    dk_ref, dv_ref = tfa.long_backward_dkv_reference(*plain)

    mask32, rel32, table = tfa._kernel_operands(mode, mask, rel, 32, max_distance)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bins = None
    if tfa.has_bias(mode):
        bins = torch.zeros((heads, 2 * max_distance + 1), dtype=torch.float32, device=cuda_device)
    names = [f"{tfa.KERNEL_NAMES[mode]}{tfa.ROUTE_SUFFIX[route]}_bwd_{part}" for part in
             ("dq", "dkv")]
    before = dict(tfa.KERNEL_LAUNCHES)
    common = (q, k, v, dout, mask32, rel32, table, lse, delta)
    tfa._backward_cuda(mode, "dq", *common, dq, bins, heads, max_distance, route)
    tfa._backward_cuda(mode, "dkv", *common, dk, dv, heads, max_distance, route)
    torch.cuda.synchronize()
    for name in tfa.KERNEL_LAUNCHES:
        assert tfa.KERNEL_LAUNCHES[name] == before[name] + (name in names), name

    got, want = [dq, dk, dv], [dq_ref, dk_ref, dv_ref]
    if bins is not None:
        got.append(tfa.fold_rel_bins(bins, table, 32))
        want.append(tfa.fold_rel_bins(bins_ref, table, 32))
    _check_grads(got, want, dtype)
    ratio = _check_grad_rows(got, want, dtype, mode, mask, q, heads)
    zero_q, zero_k = chip_smoke.zero_grad_rows(tfa, mode, mask, q)
    for g, zero in ((dq, zero_q), (dk, zero_k), (dv, zero_k)):
        rows = g.float().abs().reshape(g.shape[0], g.shape[1], heads, -1).amax(-1)
        assert rows[zero.expand(g.shape[0], g.shape[1], heads)].sum().item() == 0.0
    print("[bwd_edge] " + json.dumps({
        "mode": tfa.KERNEL_NAMES[mode], "route": route, "B": b, "Lq": t, "Lk": s, "d": d,
        "dtype": str(dtype).replace("torch.", ""), "grad_row_err": ratio}))


@pytest.mark.cuda
@pytest.mark.parametrize("block_kv", [0, 64])
def test_misaligned_dout_gives_plain_gradients(cuda_device, block_kv):
    """An output gradient that is a view one element into a larger tensor
    (not 16-byte aligned, so no TMA tensor map can read it): the backward
    copies it and gives the plain version's gradients, on the full-row and
    the long route."""
    q, k, v, mask, rel = _case(cuda_device, torch.bfloat16, 2, 200, 5)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    dout = flat[1:].view(q.shape)
    dout.copy_(torch.randn(q.shape, device=cuda_device).to(q.dtype))
    assert dout.is_contiguous() and dout.data_ptr() % tfa.TMA_ALIGN
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rel)]
    out = tfa.encoder_flash_attention(*leaves[:3], mask, leaves[3], num_heads=HEADS,
                                      block_kv=block_kv)
    got = torch.autograd.grad(out, leaves, dout)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rel)]
    ref = tfa.encoder_attention_reference(*ref_leaves[:3], mask, ref_leaves[3], num_heads=HEADS)
    want = torch.autograd.grad(ref, ref_leaves, dout)
    torch.cuda.synchronize()
    _check_grads(got, want, torch.bfloat16)
    _check_grad_rows(got, _chain(torch.bfloat16, tfa.ENCODER, q, k, v, mask, rel, dout, out),
                     torch.bfloat16, tfa.ENCODER, mask, q)
