"""PyTorch port, encoder attention: the plain version against the JAX
package (Pallas kernel in interpret mode, and the einsum/naive paths), the
bucket table against JAX bucketing, and the wrapper's input checks. The
CUDA kernel itself is compared with the plain version on the card by
``tests/test_torch_kernel.py`` and ``chip_smoke.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.models import t5 as jt5
from reprover_tpu.ops.flash_attention import encoder_flash_attention as jax_flash
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.ops import flash_attention as tfa

B, H, D = 3, 4, 16


def _inputs(L, seed=0, d=D, heads=H):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, L, heads * d)).astype(np.float32) for _ in range(3))
    mask = (rng.random((B, L)) > 0.25).astype(np.int32)
    mask[:, :4] = 1
    mask[2, L // 2 :] = 0  # a padded tail
    rel = rng.normal(size=(32, heads)).astype(np.float32)
    return q, k, v, mask, rel


def _port(q, k, v, mask, rel, heads=H, **kw):
    out = tfa.encoder_flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v, mask, rel)), num_heads=heads, **kw
    )
    return out.numpy()


def _einsum_reference(q, k, v, mask, rel, heads, d):
    """The naive JAX composition (`tests/test_flash_attention.py`)."""
    Bq, L = q.shape[:2]
    cfg = jt5.T5Config(num_heads=heads, d_kv=d)
    split = lambda x: jnp.asarray(x).reshape(Bq, L, heads, d).transpose(0, 2, 1, 3)  # noqa: E731
    pos = jnp.arange(L)
    bias = jt5.compute_position_bias(jnp.asarray(rel), pos, pos, True, cfg) + jt5._mask_bias(
        jnp.asarray(mask)
    )
    probs = jax.nn.softmax(jnp.einsum("bhqd,bhkd->bhqk", split(q), split(k)) + bias, axis=-1)
    out = jnp.einsum("bhqk,bhkd->bhqd", probs, split(v))
    return np.asarray(out.transpose(0, 2, 1, 3).reshape(Bq, L, heads * d))


@pytest.mark.parametrize("max_distance", [128, 32])
def test_plain_matches_pallas_interpret_and_einsum(max_distance):
    """L=256 with padding: the port's plain version against the Pallas kernel
    (interpret mode) and the einsum reference, fp32 at 1e-5."""
    q, k, v, mask, rel = _inputs(256)
    ours = _port(q, k, v, mask, rel, max_distance=max_distance)
    pallas = np.asarray(
        jax_flash(
            *(jnp.asarray(x) for x in (q, k, v, mask, rel)),
            num_heads=H,
            max_distance=max_distance,
            interpret=True,
        )
    )
    np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=1e-5)
    if max_distance == 128:
        ref = _einsum_reference(q, k, v, mask, rel, H, D)
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_bucket_table_matches_jax_bucketing():
    """Every rel in [-4096, 4096]: the kernel's table lookup (clamped index)
    equals the JAX package's bucket function, in both the byt5 geometry and
    a short max_distance."""
    rel = np.arange(-4096, 4097, dtype=np.int32)
    for nb, md in ((32, 128), (32, 32), (16, 64)):
        want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), True, nb, md))
        table = tfa.bucket_table(nb, md, torch.device("cpu")).numpy()
        got = table[np.clip(rel, -md, md) + md]
        np.testing.assert_array_equal(got, want)
        plain = tt5.relative_position_bucket(torch.from_numpy(rel), True, nb, md).numpy()
        np.testing.assert_array_equal(plain, want)


def test_masked_column_far_above_matches_naive_encode():
    """Masked keys whose scores lie >= 100 above the valid ones: the port
    takes the row max over valid keys only, so it matches the JAX naive
    path (the Pallas kernel's max spans masked columns and underflows)."""
    cfg = jt5.T5Config(
        d_model=64, d_kv=16, d_ff=128, num_heads=4, num_encoder_layers=2, num_decoder_layers=1
    )
    params = jax.tree.map(np.array, jt5.init_params(jax.random.PRNGKey(0), cfg))
    # Spread layer 0's scores wide: some masked key then sits far above.
    params["encoder"]["layers"]["attn"]["k"][0] *= 400.0
    rng = np.random.default_rng(5)
    L = 40
    ids = rng.integers(3, 259, (2, L)).astype(np.int32)
    mask = np.ones((2, L), np.int32)
    mask[0, 24:] = 0

    # The case occurs: in layer 0, head h, some valid query's best masked
    # score beats its best valid score by >= 100.
    x = params["shared_embedding"][ids[0]]
    n = x / np.sqrt((x * x).mean(-1, keepdims=True) + cfg.layer_norm_epsilon)
    q = (n @ params["encoder"]["layers"]["attn"]["q"][0]).reshape(L, 4, 16)
    k = (n @ params["encoder"]["layers"]["attn"]["k"][0]).reshape(L, 4, 16)
    s = np.einsum("qhd,khd->hqk", q, k)[:, :24]
    assert (s[:, :, 24:].max(-1) - s[:, :, :24].max(-1)).max() >= 100.0

    naive = np.asarray(jt5.encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask)))
    ours = tt5.encode(params_from_jax(params), tt5.T5Config(**_shared_fields(cfg)),
                      torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(ours[valid], naive[valid], atol=1e-4, rtol=1e-4)

    # And the attention op alone: one masked column ~150 above its row.
    q, k, v, m, rel = _inputs(64, seed=2)
    m[0, :] = 1
    m[0, 7] = 0
    qh = q[0, 3, :D]
    k[0, 7, :D] = qh * (150.0 / float(qh @ qh))
    ours = _port(q, k, v, m, rel)
    ref = _einsum_reference(q, k, v, m, rel, H, D)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def _shared_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tt5.T5Config)
            if f.name != "compute_dtype"}


def test_fully_masked_row_gives_zero_and_cpu_launches_nothing():
    q, k, v, mask, rel = _inputs(64, seed=3)
    mask[1] = 0
    before = tfa.KERNEL_LAUNCHES
    out = _port(q, k, v, mask, rel)
    assert tfa.KERNEL_LAUNCHES == before
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[1], 0.0)


@pytest.mark.parametrize(
    "change, error",
    [
        (lambda t: dict(t, q=t["q"].half(), k=t["k"].half(), v=t["v"].half()), TypeError),
        (lambda t: dict(t, heads=2), ValueError),  # head width 128
        (lambda t: dict(t, k=t["k"].transpose(0, 1).contiguous().transpose(0, 1)), ValueError),
        (lambda t: dict(t, mask=t["mask"][:, :-1]), ValueError),
        (lambda t: dict(t, rel=t["rel"][:16]), ValueError),
    ],
)
def test_kernel_input_checks(change, error):
    """What the CUDA path refuses, checked on CPU tensors: dtype, head
    width 64, contiguity, mask and bias shapes."""
    q, k, v, mask, rel = _inputs(16, d=64)
    t = dict(q=torch.from_numpy(q), k=torch.from_numpy(k), v=torch.from_numpy(v),
             mask=torch.from_numpy(mask), rel=torch.from_numpy(rel), heads=H)
    tfa._check_kernel_inputs(t["q"], t["k"], t["v"], t["mask"], t["rel"], H, 32)
    t = change(t)
    with pytest.raises(error):
        tfa._check_kernel_inputs(t["q"], t["k"], t["v"], t["mask"], t["rel"], t["heads"], 32)


def test_non_cpu_tensor_without_kernel_raises():
    """A tensor off the CPU never falls back to the plain version."""
    q, k, v, mask, rel = (torch.from_numpy(x) for x in _inputs(16, d=64))
    with pytest.raises(ValueError):
        tfa.encoder_flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), mask.to("meta"),
                                    rel.to("meta"), num_heads=H)
    with pytest.raises(ValueError):
        tfa.encoder_flash_attention(q, k, v, mask, rel.to("meta"), num_heads=H)
