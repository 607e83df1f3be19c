"""The attention backward's checks on the CPU.

The smoke and the card tests hold a bf16 gradient (dq, dk, dv) row by row
(``chip_smoke.grad_row_error``): every (batch row, position, head) within
2e-2 of its own max|ref| plus 2e-3 x max(1, max|ref|) of the whole tensor,
and the rows that must be zero (``chip_smoke.zero_grad_rows``) exactly
zero. Here that check is shown to fail faults that the global bf16 limit,
2e-2 x max(1, max|ref|), passes, and to pass the bf16 rounding of P and dS
that the tensor-core kernels do; its reference is the backward's algorithm
in plain torch, since autograd of the fp32 plain forward differs from that
algorithm on cancelling rows. The backward kernels read dout through a
TMA tensor map; the wrapper copies a misaligned one
(``flash_attention._kernel_dout``).
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from reprover_tpu_torch.ops import flash_attention as tfa
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

# Scaled causal attention at T 4096, one head of 64: late rows are diffuse
# (P ~ 1/T), so their gradients are small beside the first rows'.
T, HEADS, D = 4096, 1, 64


def _case():
    """Operands (q already scaled), fp32 P and dS ``[1, 1, T, T]`` and the
    output gradient in heads, from bf16 inputs made with a seed."""
    rng = np.random.default_rng(0)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(1, T, HEADS * D)).astype(np.float32))
                     .to(torch.bfloat16) for _ in range(4))
    mask = torch.ones((1, T), dtype=torch.int32)
    qs = tfa.scale_queries(q, D ** -0.5)
    mode = tfa.SCALED_CAUSAL
    out = tfa.scaled_causal_attention_reference(q, k, v, mask, HEADS, D ** -0.5)
    lse = tfa.scaled_causal_attention_lse_reference(qs, k, mask, HEADS)
    s = tfa._scores_plain(mode, qs, k, None, HEADS, 32, 128)
    p = torch.where(tfa._valid(mode, mask, qs), torch.exp(s - lse[..., None]), torch.zeros_like(s))
    gh = tfa._heads(dout, HEADS)
    dp = gh @ tfa._heads(v, HEADS).transpose(-1, -2)
    ds = p * (dp - tfa.row_delta(dout, out, HEADS)[..., None])
    return qs, k, p, ds, gh


def _grads(qs, k, p, ds, gh, operands=lambda x: x):
    """bf16 ``(dq, dk, dv)`` from P and dS, each passed through ``operands``
    before its product."""
    dq = operands(ds) @ tfa._heads(k, HEADS)
    dk = operands(ds).transpose(-1, -2) @ tfa._heads(qs, HEADS)
    dv = operands(p).transpose(-1, -2) @ gh
    return [tfa._flat(x, torch.bfloat16) for x in (dq, dk, dv)]


@pytest.fixture(scope="module")
def case():
    qs, k, p, ds, gh = _case()
    return qs, k, p, ds, gh, _grads(qs, k, p, ds, gh)


def _old_limit_passes(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return 0 < err <= chip_smoke.BF16_REL_TOL * max(1.0, want.float().abs().max().item())


def test_grad_row_error_fails_a_dq_missing_a_key_tile(case):
    """The last query tile's dQ without key tile 0 (a dQ block that skips a
    tile): those rows are diffuse and small beside the first rows' dQ, so
    the global limit passes it; the row check does not."""
    qs, k, p, ds, gh, want = case
    faulty = ds.clone()
    faulty[..., T - 64:, :64] = 0
    got = _grads(qs, k, p, faulty, gh)[0]
    assert _old_limit_passes(got, want[0])
    assert chip_smoke.grad_row_error(got, want[0], HEADS) > chip_smoke.BF16_REL_TOL


def test_grad_row_error_fails_a_dkv_missing_a_query_tile(case):
    """dK and dV of keys T-128 .. T-65 without the last query tile (a dK/dV
    block that stops one tile early): half of what those late keys get, and
    still within the global limit."""
    qs, k, p, ds, gh, want = case
    p_faulty, ds_faulty = p.clone(), ds.clone()
    for x in (p_faulty, ds_faulty):
        x[..., T - 64:, T - 128:T - 64] = 0
    _, dk, dv = _grads(qs, k, p_faulty, ds_faulty, gh)
    for got, ref in ((dk, want[1]), (dv, want[2])):
        assert _old_limit_passes(got, ref)
        assert chip_smoke.grad_row_error(got, ref, HEADS) > chip_smoke.BF16_REL_TOL


def test_grad_row_error_passes_bf16_p_and_ds(case):
    """P and dS rounded to bf16 before their products, as the tensor-core
    kernels round them: every row well inside the limit."""
    qs, k, p, ds, gh, want = case
    got = _grads(qs, k, p, ds, gh, lambda x: x.to(torch.bfloat16).float())
    for g, w in zip(got, want):
        assert chip_smoke.grad_row_error(g, w, HEADS) <= chip_smoke.BF16_REL_TOL / 2


def test_grad_row_error_zero_rows():
    """A row marked as one that must be zero fails at any value; a row whose
    reference cancels to zero elsewhere is held to the floor, 2e-3 x max(1,
    max|ref|)."""
    want = torch.zeros((2, 3, 4))
    want[0] = 1.0
    got = want.clone()
    zero = torch.tensor([False, True])[:, None, None]
    assert chip_smoke.grad_row_error(got, want, 2, zero) == 0.0
    got[1, 2, 3] = 1e-6
    assert chip_smoke.grad_row_error(got, want, 2, zero) == math.inf
    got[1, 2, 3] = 0.0
    got[0, 1, 3] = 0.0
    got[0, 1, 2] = 0.0  # want[0, 1] row has max 1: 100% off
    assert chip_smoke.grad_row_error(got, want, 2) == pytest.approx(1 / 1.1)
    cancelled = want.clone()
    cancelled[0, 0, :2] = 0.0
    near = cancelled.clone()
    near[0, 0, 0] = 1e-3
    assert chip_smoke.grad_row_error(near, cancelled, 2, zero) == pytest.approx(1e-2)


@pytest.mark.parametrize("mode", [tfa.ENCODER, tfa.CAUSAL, tfa.CROSS, tfa.SCALED_CAUSAL])
def test_zero_grad_rows(mode):
    """dq rows of queries with no valid key, dk/dv rows of masked keys."""
    b, lq, lk = 2, 5, 7 if mode == tfa.CROSS else 5
    q = torch.zeros((b, lq, 8))
    mask = torch.ones((b, lk), dtype=torch.int32)
    mask[0, 1] = 0
    mask[1] = 0
    if mode == tfa.SCALED_CAUSAL:
        mask[1, 2:] = 1  # left-padded: queries 0 and 1 see no valid key
    zq, zk = chip_smoke.zero_grad_rows(tfa, mode, mask, q)
    zq, zk = zq.expand(b, lq, 1)[..., 0], zk.expand(b, lk, 1)[..., 0]
    if mode == tfa.CAUSAL:  # no mask: every query sees itself
        assert not zq.any() and not zk.any()
        return
    assert torch.equal(zk, mask == 0)
    want_q = torch.zeros((b, lq), dtype=torch.bool)
    if mode == tfa.SCALED_CAUSAL:
        want_q[1, :2] = True
    else:
        want_q[1] = True
    assert torch.equal(zq, want_q)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_dout_is_contiguous_aligned_and_typed(dtype):
    """A view one element into a larger gradient is copied to an aligned
    base; an aligned contiguous one is passed as it is."""
    shape = (2, 8, 128)
    flat = torch.arange(2 * 8 * 128 + 1, dtype=torch.float32).to(dtype)
    shifted = flat[1:].view(shape)
    assert shifted.data_ptr() % tfa.TMA_ALIGN
    got = tfa._kernel_dout(shifted, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.data_ptr() % tfa.TMA_ALIGN == 0
    assert torch.equal(got.float(), shifted.to(torch.bfloat16).float())
    aligned = torch.zeros(shape, dtype=torch.bfloat16)
    assert tfa._kernel_dout(aligned, torch.bfloat16) is aligned


def test_grad_row_reference_is_the_backward_chain():
    """Why the row check's reference is ``chip_smoke.plain_grad_chain`` and
    not autograd of the fp32 plain forward: the backward takes delta =
    rowsum(dO * O) from the bf16 output, and that alone moves a dq row whose
    dS cancels (encoder attention, unscaled scores: nearly one-hot rows) by
    more than the limit, with no kernel involved. The chain agrees with the
    full-row step-by-step plain backward."""
    rng = np.random.default_rng(1)
    b, length, heads = 2, 200, 6
    q, k, v, dout = (torch.from_numpy(rng.normal(size=(b, length, heads * 64)).astype(np.float32))
                     .to(torch.bfloat16) for _ in range(4))
    mask = torch.from_numpy((rng.random((b, length)) > 0.2).astype(np.int32))
    mask[:, 0] = 1
    rel = torch.from_numpy(rng.normal(size=(32, heads)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.encoder_attention_reference(*leaves, mask, rel, num_heads=heads)
    autograd = torch.autograd.grad(out, leaves, dout)
    chain = chip_smoke.plain_grad_chain(tfa, tfa.ENCODER, q, k, v, mask, rel, dout, heads,
                                        out=out.detach())
    lse = tfa.encoder_attention_lse_reference(q, k, mask, rel, heads)
    step = tfa.encoder_attention_backward_reference(q, k, v, mask, rel, out.detach(), lse, dout,
                                                    heads)
    zero_q, zero_k = chip_smoke.zero_grad_rows(tfa, tfa.ENCODER, mask, q)
    assert chip_smoke.grad_row_error(chain[0], autograd[0], heads, zero_q) > (
        chip_smoke.BF16_REL_TOL)
    for c, s, zero in zip(chain, step[:3], (zero_q, zero_k, zero_k)):
        assert chip_smoke.grad_row_error(c, s, heads, zero) <= chip_smoke.BF16_REL_TOL / 4
