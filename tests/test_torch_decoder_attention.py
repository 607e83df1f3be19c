"""PyTorch port, the teacher-forced decoder's attention on the CPU: the plain
causal and cross versions, forward and autograd, against the JAX package's
``causal_flash_attention`` and ``cross_flash_attention`` (Pallas kernels in
interpret mode) and ``jax.grad`` through them; the step-by-step backward
references and the LSE references against autograd of the plain versions.
fp32 throughout. The CUDA kernels are held to the plain versions on the card
by ``tests/test_torch_kernel.py`` and ``chip_smoke.py``.

Every encoder row keeps a valid key here: for a row with none the Pallas
cross kernel returns the mean of ``v`` and the port 0 (documented in
``reprover_tpu_torch/ops/flash_attention.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.ops.flash_attention import causal_flash_attention as jax_causal
from reprover_tpu.ops.flash_attention import cross_flash_attention as jax_cross
from reprover_tpu_torch.ops import flash_attention as tfa
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

B, D = 2, 8


def _inputs(t, s, heads, seed):
    rng = np.random.default_rng(seed)
    q, w = (rng.normal(size=(B, t, heads * D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, s, heads * D)).astype(np.float32) for _ in range(2))
    mask = (rng.random((B, s)) > 0.25).astype(np.int32)
    mask[:, :2] = 1
    mask[1, s // 2 :] = 0  # a padded tail
    rel = rng.normal(size=(32, heads)).astype(np.float32)
    return q, k, v, mask, rel, w


def _torch_grads(fn, inputs, w):
    """Autograd of sum(out * w) through ``fn`` on CPU tensors."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_grads(fn, inputs, w):
    def loss(*args):
        return jnp.sum(fn(*args) * jnp.asarray(w))

    args = [jnp.asarray(x) for x in inputs]
    out = fn(*args)
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("t, heads, max_distance", [(128, 4, 128), (256, 2, 32)])
def test_causal_plain_matches_pallas_interpret(t, heads, max_distance):
    """Output, dq, dk, dv within 1e-5 and d_rel within 1e-4 of max|ref|;
    ``max_distance`` 32 at T=256 reaches the saturated log buckets."""
    q, k, v, _, rel, w = _inputs(t, t, heads, seed=t + max_distance)
    before = dict(tfa.KERNEL_LAUNCHES)
    out, ours = _torch_grads(
        lambda q, k, v, r: tfa.causal_flash_attention(q, k, v, r, num_heads=heads,
                                                      max_distance=max_distance),
        (q, k, v, rel), w)
    assert tfa.KERNEL_LAUNCHES == before
    ref_out, ref = _jax_grads(
        lambda q, k, v, r: jax_causal(q, k, v, r, num_heads=heads, max_distance=max_distance,
                                      interpret=True),
        (q, k, v, rel), w)
    np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=1e-5)
    for name, got, want in zip(("dq", "dk", "dv"), ours[:3], ref[:3]):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=name)
    scale = np.abs(ref[3]).max()
    np.testing.assert_allclose(ours[3], ref[3], atol=1e-4 * scale, rtol=0, err_msg="d_rel")


@pytest.mark.parametrize("t, s, heads", [(128, 384, 4), (256, 256, 2)])
def test_cross_plain_matches_pallas_interpret(t, s, heads):
    """T != S with a padded encoder tail: output, dq, dk, dv within 1e-5."""
    q, k, v, mask, _, w = _inputs(t, s, heads, seed=t + s)
    before = dict(tfa.KERNEL_LAUNCHES)
    out, ours = _torch_grads(
        lambda q, k, v: tfa.cross_flash_attention(q, k, v, torch.from_numpy(mask),
                                                  num_heads=heads),
        (q, k, v), w)
    assert tfa.KERNEL_LAUNCHES == before
    ref_out, ref = _jax_grads(
        lambda q, k, v: jax_cross(q, k, v, jnp.asarray(mask), num_heads=heads, interpret=True),
        (q, k, v), w)
    np.testing.assert_allclose(out, ref_out, atol=1e-5, rtol=1e-5)
    for name, got, want in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("max_distance", [128, 32])
def test_causal_backward_reference_matches_autograd(max_distance):
    """The kernels' step-by-step plan (LSE, dS, bins folded into
    unidirectional buckets) equals autograd of the plain version."""
    t, heads = 200, 3
    q, k, v, _, rel, w = _inputs(t, t, heads, seed=max_distance)
    out, want = _torch_grads(
        lambda q, k, v, r: tfa.causal_attention_reference(q, k, v, r, heads,
                                                          max_distance=max_distance),
        (q, k, v, rel), w)
    tq, tk, tv, trel = (torch.from_numpy(x) for x in (q, k, v, rel))
    lse = tfa.causal_attention_lse_reference(tq, tk, trel, heads, max_distance=max_distance)
    got = tfa.causal_attention_backward_reference(
        tq, tk, tv, trel, torch.from_numpy(out), lse, torch.from_numpy(w), heads,
        max_distance=max_distance)
    for name, g, ref in zip(("dq", "dk", "dv", "d_rel"), got, want):
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * max(1.0, np.abs(ref).max()),
                                   rtol=0, err_msg=name)


def test_cross_backward_reference_matches_autograd():
    """The cross kernels' plan equals autograd of the plain version, and an
    encoder row with no valid key gives output 0, LSE +inf and zero
    gradients."""
    t, s, heads = 100, 300, 2
    q, k, v, mask, _, w = _inputs(t, s, heads, seed=7)
    mask[0] = 0
    tmask = torch.from_numpy(mask)
    out, want = _torch_grads(
        lambda q, k, v: tfa.cross_attention_reference(q, k, v, tmask, heads), (q, k, v), w)
    np.testing.assert_array_equal(out[0], 0.0)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    lse = tfa.cross_attention_lse_reference(tq, tk, tmask, heads)
    assert torch.isinf(lse[0]).all() and torch.isfinite(lse[1]).all()
    got = tfa.cross_attention_backward_reference(tq, tk, tv, tmask, torch.from_numpy(out), lse,
                                                 torch.from_numpy(w), heads)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-4 * max(1.0, np.abs(ref).max()),
                                   rtol=0, err_msg=name)
        np.testing.assert_array_equal(g.numpy()[0], 0.0)


def test_unidirectional_table_matches_jax_bucketing():
    """The decoder's bucket table equals JAX's unidirectional bucketing at
    every clamped relative position; every future position is bucket 0."""
    from reprover_tpu.models import t5 as jt5

    for nb, md in [(32, 128), (32, 32), (16, 64)]:
        table = tfa.bucket_table(nb, md, torch.device("cpu"), bidirectional=False).numpy()
        rel = np.arange(-md, md + 1)
        want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), False, nb, md))
        np.testing.assert_array_equal(table, want)
        assert (table[md + 1 :] == 0).all()


@pytest.mark.parametrize(
    "fn, error",
    [
        (lambda t: tfa._check_kernel_inputs(t["q"], t["k"], t["v"], t["mask"], None, 6, 32,
                                            tfa.CROSS), None),
        (lambda t: tfa._check_kernel_inputs(t["q"], t["k"], t["v"], t["mask"][:, :-1], None, 6,
                                            32, tfa.CROSS), ValueError),
        (lambda t: tfa._check_kernel_inputs(t["q"], t["k"], t["v"], t["mask"], t["rel"], 6, 32,
                                            tfa.CAUSAL), ValueError),  # T != S
        (lambda t: tfa._check_kernel_inputs(t["q"], t["q"], t["q"], t["qmask"], None, 6, 32,
                                            tfa.CAUSAL), ValueError),  # no bias
        (lambda t: tfa._check_kernel_inputs(t["q"], t["k"], t["v"][:, :-1], t["mask"], None, 6,
                                            32, tfa.CROSS), ValueError),
    ],
)
def test_decoder_kernel_input_checks(fn, error):
    """What the causal and cross CUDA paths refuse, checked on CPU tensors."""
    rng = np.random.default_rng(0)
    t = {name: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
         for name, shape in (("q", (2, 16, 384)), ("k", (2, 40, 384)), ("v", (2, 40, 384)),
                             ("rel", (32, 6)))}
    t["mask"] = torch.ones((2, 40), dtype=torch.int32)
    t["qmask"] = torch.ones((2, 16), dtype=torch.int32)
    if error is None:
        fn(t)
    else:
        with pytest.raises(error):
            fn(t)


def test_meta_tensors_raise():
    """A tensor off the CPU never falls back to the plain versions."""
    q = torch.zeros((1, 8, 384), device="meta")
    rel = torch.zeros((32, 6), device="meta")
    with pytest.raises(ValueError):
        tfa.causal_flash_attention(q, q, q, rel, num_heads=6)
    with pytest.raises(ValueError):
        tfa.cross_flash_attention(q, q, q, torch.ones((1, 8), dtype=torch.int32, device="meta"),
                                  num_heads=6)
