"""PyTorch port, encoder-attention gradient on the CPU: autograd of the
plain version against ``jax.grad`` through the Pallas kernels (interpret
mode), the plain version of the backward kernels (LSE, dS binned by
relative position, folded into buckets) against that autograd, the
bin -> bucket fold against JAX bucketing, and zero gradients for a row with
no valid key. The CUDA kernels are held to the plain version on the card by
``tests/test_torch_kernel.py`` and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from reprover_tpu.models import t5 as jt5
from reprover_tpu.ops.flash_attention import encoder_flash_attention as jax_flash
from reprover_tpu_torch.ops import flash_attention as tfa
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

B, H, D = 3, 4, 16


def _inputs(L, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(B, L, H * D)).astype(np.float32) for _ in range(4))
    mask = (rng.random((B, L)) > 0.25).astype(np.int32)
    mask[:, :4] = 1
    mask[2, L // 2 :] = 0  # a padded tail
    rel = rng.normal(size=(32, H)).astype(np.float32)
    return q, k, v, mask, rel, w


def _torch_grads(q, k, v, mask, rel, w, max_distance=128):
    """Autograd of sum(out * w) through the port's CPU path."""
    tq, tk, tv, trel = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, rel))
    out = tfa.encoder_flash_attention(tq, tk, tv, torch.from_numpy(mask), trel, num_heads=H,
                                      max_distance=max_distance)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), [t.grad.numpy() for t in (tq, tk, tv, trel)]


@pytest.mark.parametrize("L, max_distance", [(256, 128), (256, 32), (200, 128)])
def test_plain_grad_matches_pallas_interpret(L, max_distance):
    """L=256 with padding, and L=200 (not a multiple of 128: the Pallas path
    takes it as one block): dq, dk, dv within 1e-5, d_rel within 1e-4 of
    max|ref|, fp32."""
    q, k, v, mask, rel, w = _inputs(L, seed=L + max_distance)
    _, ours = _torch_grads(q, k, v, mask, rel, w, max_distance)

    def loss(q, k, v, rel):
        out = jax_flash(q, k, v, jnp.asarray(mask), rel, num_heads=H,
                        max_distance=max_distance, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, rel)))
    for name, got, want in zip(("dq", "dk", "dv"), ours[:3], ref[:3]):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5, err_msg=name)
    want_rel = np.asarray(ref[3])
    scale = np.abs(want_rel).max()
    np.testing.assert_allclose(ours[3], want_rel, atol=1e-4 * scale, rtol=0, err_msg="d_rel")


@pytest.mark.parametrize("L, max_distance", [(256, 128), (100, 16)])
def test_backward_reference_matches_autograd(L, max_distance):
    """The plain version of the two backward kernels (P from the forward's
    LSE, delta = rowsum(dO O), dS binned by clamp(k - q) and folded) equals
    autograd of the plain forward, with an empty row and a masked key far
    above its row."""
    q, k, v, mask, rel, w = _inputs(L, seed=7)
    mask[1] = 0  # a row with no valid key
    mask[0, 9] = 0
    k[0, 9, :D] = q[0, 3, :D] * (150.0 / float(q[0, 3, :D] @ q[0, 3, :D]))
    out, want = _torch_grads(q, k, v, mask, rel, w, max_distance)
    t = [torch.from_numpy(x) for x in (q, k, v, mask, rel)]
    lse = tfa.encoder_attention_lse_reference(t[0], t[1], t[3], t[4], H, max_distance=max_distance)
    assert torch.isinf(lse[1]).all() and torch.isfinite(lse[0]).all()
    before = dict(tfa.KERNEL_LAUNCHES)
    got = tfa.encoder_attention_backward(*t, out, lse, torch.from_numpy(w), H,
                                         max_distance=max_distance)
    assert tfa.KERNEL_LAUNCHES == before
    for name, g, ref in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-5, rtol=1e-5, err_msg=name)
    scale = np.abs(want[3]).max()
    np.testing.assert_allclose(got[3].numpy(), want[3], atol=1e-5 * scale, rtol=0, err_msg="d_rel")


@pytest.mark.parametrize("num_buckets, max_distance", [(32, 128), (32, 32), (16, 64)])
def test_bin_fold_matches_jax_bucketing(num_buckets, max_distance):
    """Every rel in [-4096, 4096]: values binned by the dQ kernel's clamped
    index and folded through the bucket table sum to what JAX's bucket
    function assigns each bucket."""
    rel = np.arange(-4096, 4097, dtype=np.int32)
    rng = np.random.default_rng(num_buckets + max_distance)
    vals = rng.normal(size=(2, rel.size)).astype(np.float64)  # two heads
    buckets = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), True, num_buckets,
                                                      max_distance))
    want = np.zeros((num_buckets, 2))
    for h in range(2):
        np.add.at(want[:, h], buckets, vals[h])
    bins = np.zeros((2, 2 * max_distance + 1))
    for h in range(2):
        np.add.at(bins[h], np.clip(rel, -max_distance, max_distance) + max_distance, vals[h])
    table = tfa.bucket_table(num_buckets, max_distance, torch.device("cpu"))
    got = tfa.fold_rel_bins(torch.from_numpy(bins).float(), table, num_buckets).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    idx = tfa.rel_index(64, max_distance, torch.device("cpu")).numpy()
    pos = np.arange(64)
    np.testing.assert_array_equal(
        idx, np.clip(pos[None, :] - pos[:, None], -max_distance, max_distance) + max_distance)


def test_empty_row_gives_zero_gradients():
    """A batch row whose keys are all masked: output 0, and zero, finite
    gradients for its q, k and v (plain autograd and the plain backward)."""
    q, k, v, mask, rel, w = _inputs(64, seed=3)
    mask[1] = 0
    out, grads = _torch_grads(q, k, v, mask, rel, w)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_array_equal(out[1].numpy(), 0.0)
    for g in grads:
        assert np.isfinite(g).all()
    for g in grads[:3]:
        np.testing.assert_array_equal(g[1], 0.0)
        assert np.abs(g[0]).max() > 0


def test_backward_off_cpu_without_kernel_raises():
    """A tensor off the CPU never falls back to the plain backward."""
    _, _, _, mask, rel, _ = (torch.from_numpy(x).to("meta") for x in _inputs(16))
    q, k, v, dout = (torch.randn(B, 16, H * 64, device="meta") for _ in range(4))
    lse = torch.zeros(B, H, 16, device="meta")
    with pytest.raises(ValueError):
        tfa.encoder_attention_backward(q, k, v, mask, rel, q, lse, dout, H)


class _OpCalls(TorchDispatchMode):
    """Counts the attention operators' calls while active."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += func in tfa.ATTENTION_OPS
        return func(*args, **(kwargs or {}))


def _mode_call(mode, q, k, v, mask, rel, block_kv):
    if mode == "encoder":
        return tfa.encoder_flash_attention(q, k, v, mask, rel, num_heads=H, block_kv=block_kv)
    if mode == "causal":
        return tfa.causal_flash_attention(q, k, v, rel, num_heads=H, block_kv=block_kv)
    if mode == "cross":
        return tfa.cross_flash_attention(q, k, v, mask, num_heads=H, block_kv=block_kv)
    return tfa.scaled_causal_flash_attention(q, k, v, mask, num_heads=H, scale=D ** -0.5,
                                             block_kv=block_kv)


@pytest.mark.parametrize("block_kv", [0, 64])
@pytest.mark.parametrize("mode", ["encoder", "causal", "cross", "scaled_causal"])
def test_cpu_gradient_goes_through_operator(monkeypatch, mode, block_kv):
    """On CPU tensors with no remat policy, a gradient is taken through the
    attention operator (one forward call, and on the full-row route one call
    of its CPU gradient), and on the full-row route dq, dk and dv are
    bit-equal to autograd of the plain forward (d_rel, whose buckets the
    two sum in different orders, within 1e-5 of its max)."""
    q, k, v, mask, rel, w = _inputs(128, seed=11)
    grad_calls = []
    plain_grads = tfa._plain_grads
    monkeypatch.setattr(tfa, "_plain_grads",
                        lambda *a: grad_calls.append(1) or plain_grads(*a))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, rel)]
    counter = _OpCalls()
    with counter:
        out = _mode_call(mode, *leaves[:3], torch.from_numpy(mask), leaves[3], block_kv)
    (out * torch.from_numpy(w)).sum().backward()
    assert counter.calls == 1
    assert len(grad_calls) == (0 if block_kv else 1)
    if block_kv:
        return
    plain = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, rel)]
    tm, m = torch.from_numpy(mask), {"encoder": tfa.ENCODER, "causal": tfa.CAUSAL,
                                     "cross": tfa.CROSS, "scaled_causal": tfa.SCALED_CAUSAL}[mode]
    qs = tfa.scale_queries(plain[0], D ** -0.5) if mode == "scaled_causal" else plain[0]
    ref = tfa._plain_forward(m, qs, plain[1], plain[2], tm,
                             plain[3] if tfa.has_bias(m) else None, H, 32, 128)
    (ref * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for got, want in zip(leaves[:3], plain[:3]):
        torch.testing.assert_close(got.grad, want.grad, rtol=0, atol=0)
    if plain[3].grad is None:
        assert leaves[3].grad is None
    else:
        scale = plain[3].grad.abs().max().item()
        torch.testing.assert_close(leaves[3].grad, plain[3].grad, rtol=0, atol=1e-5 * scale)
