"""PyTorch port on the card: the T5 attention CUDA kernels (encoder, causal
decoder and cross-attention; forward and backward) against their plain
versions, and the encoder and the teacher-forced decoder through the
kernels against the CPU, forward and gradients. These tests need a CUDA
card and skip elsewhere. The file imports no JAX, so it also runs on a
machine without it:

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.ops import flash_attention as tfa

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
    for name in tfa.KERNEL_LAUNCHES:
        assert tfa.KERNEL_LAUNCHES[name] > before[name], name
    loss_cpu, cpu = run(torch.device("cpu"))
    assert abs(loss_card - loss_cpu) <= 1e-4 * max(1.0, abs(loss_cpu))
    for g, w in zip(on_card, cpu):
        scale = max(1e-6, w.abs().max().item())
        assert (g - w).abs().max().item() <= 1e-3 * scale
