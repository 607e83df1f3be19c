"""PyTorch port, the long route of the T5 attentions on the CPU: the
KV-blocked plain versions of kernels 2, 5, 6 and 7 (behind
``encoder_flash_attention``, ``causal_flash_attention`` and
``cross_flash_attention`` when ``block_kv > 0`` or a length passes 4096)
against the JAX package's blockwise Pallas kernels in interpret mode and
``jax.grad`` through them; ``forward_loss`` and its gradients with
``flash_block_kv`` against the JAX package's flash encoder and decoder; and
the route's thresholds. fp32 throughout. Tolerances: outputs atol 2e-5 /
rtol 1e-5, gradients atol 3e-4 / rtol 1e-4 (those of the JAX package's own
blockwise tests); the loss 1e-4 and parameter gradients 1e-4 of max(1,
max|ref|) (those of ``tests/test_torch_generation.py``). The CUDA kernels are
held to these plain versions on the card by ``tests/test_torch_kernel.py``
and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.models import t5 as jt5
from reprover_tpu.ops.flash_attention import causal_flash_attention as jax_causal
from reprover_tpu.ops.flash_attention import cross_flash_attention as jax_cross
from reprover_tpu.ops.flash_attention import encoder_flash_attention as jax_encoder
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.ops import flash_attention as tfa

FWD_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=3e-4, rtol=1e-4)
D = 8


def _inputs(b, t, s, heads, seed, mask_kind):
    rng = np.random.default_rng(seed)
    q, w = (rng.normal(size=(b, t, heads * D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, s, heads * D)).astype(np.float32) for _ in range(2))
    mask = np.ones((b, s), np.int32)
    if mask_kind == "ragged":
        mask = (rng.random((b, s)) > 0.3).astype(np.int32)
        mask[:, 0] = 1
    elif mask_kind == "tail":  # every key of the last 128-block (and more) masked
        mask[:, s - 160:] = 0
    rel = rng.normal(size=(32, heads)).astype(np.float32)
    return q, k, v, mask, rel, w


def _port(kind, mask, heads, block_kv):
    m = torch.from_numpy(mask)
    if kind == "encoder":
        return lambda q, k, v, r: tfa.encoder_flash_attention(q, k, v, m, r, heads,
                                                              block_kv=block_kv)
    if kind == "causal":
        return lambda q, k, v, r: tfa.causal_flash_attention(q, k, v, r, heads,
                                                             block_kv=block_kv)
    return lambda q, k, v: tfa.cross_flash_attention(q, k, v, m, heads, block_kv=block_kv)


def _jax(kind, mask, heads, block_kv):
    m = jnp.asarray(mask)
    blocks = dict(block_q=128, block_kv=block_kv) if block_kv else {}
    if kind == "encoder":
        return lambda q, k, v, r: jax_encoder(q, k, v, m, r, num_heads=heads, interpret=True,
                                              **blocks)
    if kind == "causal":
        return lambda q, k, v, r: jax_causal(q, k, v, r, num_heads=heads, interpret=True,
                                             **blocks)
    return lambda q, k, v: jax_cross(q, k, v, m, num_heads=heads, interpret=True, **blocks)


def _compare(kind, b, t, s, heads, seed, mask_kind, block_kv):
    q, k, v, mask, rel, w = _inputs(b, t, s, heads, seed, mask_kind)
    args = (q, k, v) if kind == "cross" else (q, k, v, rel)
    names = ("dq", "dk", "dv", "d_rel")[: len(args)]

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    before = dict(tfa.KERNEL_LAUNCHES)
    out = _port(kind, mask, heads, block_kv)(*leaves)
    (out * torch.from_numpy(w)).sum().backward()
    assert tfa.KERNEL_LAUNCHES == before  # CPU tensors launch nothing

    fn = _jax(kind, mask, heads, block_kv)
    jargs = [jnp.asarray(x) for x in args]
    want_out = fn(*jargs)
    want = jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(w)),
                    argnums=tuple(range(len(args))))(*jargs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **FWD_TOL)
    for name, leaf, g in zip(names, leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize(
    "kind, t, s, mask_kind",
    [
        ("encoder", 512, 512, "tail"),  # near and far blocks, a fully masked tail block
        ("encoder", 384, 384, "ragged"),
        ("causal", 384, 384, "ones"),  # skipped future blocks, a far-past block
        ("cross", 256, 384, "tail"),
    ],
)
def test_long_route_matches_pallas_blockwise(kind, t, s, mask_kind):
    """``block_kv=128`` on both sides: the JAX package's blockwise kernels
    with 128-blocks, the port's plain versions with the kernels' 64-tiles
    (its result does not depend on ``block_kv``)."""
    _compare(kind, 2, t, s, 4, seed=t + s, mask_kind=mask_kind, block_kv=128)


def test_long_route_by_length_matches_pallas():
    """No ``block_kv``: at L = 4224 > 4096 both packages switch to the long
    route by themselves."""
    _compare("encoder", 1, 4224, 4224, 2, seed=4224, mask_kind="ragged", block_kv=0)


TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
            num_decoder_layers=2)
B, S, T = 2, 256, 128  # the JAX flash paths take multiples of 128 only


def _flat_grads(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in leaves}


@pytest.mark.parametrize("remat", [False, True])
def test_forward_loss_with_flash_block_kv_matches_jax(monkeypatch, remat):
    """The slice: the port's ``forward_loss`` with ``flash_block_kv=128``
    (the encoder on the long route, the decoder on the full-row plain
    versions) and every parameter gradient against ``jax.grad`` of the JAX
    package's with ``flash_encoder``, ``flash_decoder`` and the same
    ``flash_block_kv``."""
    jcfg = jt5.T5Config(**TINY, flash_encoder=True, flash_decoder=True, flash_block_kv=128,
                        remat=remat)
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 259, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, S // 3:] = 0
    labels = rng.integers(3, 259, (B, T)).astype(np.int32)
    labels[0, T // 2:] = -100
    args = (jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels))
    want_loss, want = jax.value_and_grad(lambda p: jt5.forward_loss(p, jcfg, *args))(jparams)

    params = jax.tree.map(lambda t: t.clone().requires_grad_(True),
                          params_from_jax(jax.tree.map(np.asarray, jparams)))
    cfg = tt5.T5Config(**TINY, flash_block_kv=128, remat=remat)
    calls = []
    real = tfa.long_attention_reference

    def spy(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "long_attention_reference", spy)
    loss = tt5.forward_loss(params, cfg, *(torch.from_numpy(x).long()
                                           for x in (ids, mask, labels)))
    assert calls == [tfa.ENCODER] * TINY["num_encoder_layers"]
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-4
    want = _flat_grads(want)
    got = _flat_grads(jax.tree.map(lambda t: t.grad.numpy(), params))
    assert got.keys() == want.keys()
    for name in want:
        scale = max(1.0, np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], atol=1e-4 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize(
    "kind, t, s, block_kv, long",
    [
        ("encoder", 4096, 4096, 0, False),
        ("encoder", 4097, 4097, 0, True),
        ("encoder", 100, 100, 64, True),
        ("causal", 4096, 4096, 0, False),
        ("causal", 4097, 4097, 0, True),
        ("cross", 100, 4096, 0, False),
        ("cross", 100, 4097, 0, True),  # on S
        ("cross", 4097, 100, 0, True),  # on T
        ("cross", 100, 100, 128, True),
    ],
)
def test_long_route_thresholds(monkeypatch, kind, t, s, block_kv, long):
    """The JAX package's switch: the long route when ``block_kv > 0`` or a
    length passes 4096 (cross: S or T), else the full-row path."""
    assert tfa.takes_long_route(block_kv, t, s) == long
    taken = []
    for name in ("long_attention_reference", "encoder_attention_reference",
                 "causal_attention_reference", "cross_attention_reference"):
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, **kw: taken.append(_n))
    q, k, rel = torch.zeros((1, t, 2)), torch.zeros((1, s, 2)), torch.zeros((32, 1))
    mask = torch.ones((1, s), dtype=torch.int32)
    if kind == "encoder":
        tfa.encoder_flash_attention(q, k, k, mask, rel, 1, block_kv=block_kv)
    elif kind == "causal":
        tfa.causal_flash_attention(q, k, k, rel, 1, block_kv=block_kv)
    else:
        tfa.cross_flash_attention(q, k, k, mask, 1, block_kv=block_kv)
    assert taken == ["long_attention_reference" if long else f"{kind}_attention_reference"]
