"""PyTorch port: the ablation harness of the encoder attention kernel
(``reprover_tpu_torch/benchmarks/flash_kernel_bisect.py``, kernel 14)
against the JAX package's ``benchmarks/flash_kernel_bisect.py::_kernel``.

The port's plain versions of the variants take the same numpy inputs as the
JAX kernel, run through ``pl.pallas_call(..., interpret=True)`` at a small
shape (the module's head count ``H`` set by ``monkeypatch``), fp32, within
1e-5 of max|ref| (the same products summed in another order). The softmax
variants take a ragged key mask. ``nosoftmax`` adds -1e10 for a masked key,
which makes a row with one ~1e6 while the rows without are ~1e-2: it is
held to the JAX kernel on an all-ones mask, and on the ragged mask row by
row, each row within 1e-5 of its own max|ref|. The port's
``sharedcmp`` drops the bias-table gather, which the TPU harness's
``sharedcmp`` keeps (its hoisted compares compute ``full``'s function), so
it is held to a numpy transcription of its own definition."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import benchmarks.flash_kernel_bisect as jbisect
from reprover_tpu_torch.benchmarks import flash_kernel_bisect as bisect
from reprover_tpu_torch.ops import flash_attention as tfa
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

B, L, H, D = 2, 256, 2, 64


def _inputs(seed: int = 0, ragged: bool = True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, L, H * D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), np.int32)
    if ragged:
        mask[1, 200:] = 0
    rel = rng.normal(size=(32, H)).astype(np.float32)  # [num_buckets, H]
    return q, k, v, mask, rel


def _jax_variant(variant: str, q, k, v, mask, rel, monkeypatch) -> np.ndarray:
    monkeypatch.setattr(jbisect, "H", H)
    kern = functools.partial(jbisect._kernel, variant=variant)
    spec = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((B, L, H * D), jnp.float32),
        grid=(B, 1),
        in_specs=[spec((1, L, H * D), lambda bi, qi: (bi, qi, 0)),
                  spec((1, L, H * D), lambda bi, qi: (bi, 0, 0)),
                  spec((1, L, H * D), lambda bi, qi: (bi, 0, 0)),
                  spec((1, 1, L), lambda bi, qi: (bi, 0, 0)),
                  spec((H, 1, 32), lambda bi, qi: (0, 0, 0))],
        out_specs=spec((1, L, H * D), lambda bi, qi: (bi, qi, 0)),
        interpret=True,
    )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)[:, None, :],
      jnp.asarray(rel.T)[:, None, :])
    return np.asarray(out)


def _ours(variant: str, q, k, v, mask, rel) -> np.ndarray:
    args = [torch.from_numpy(x) for x in (q, k, v, mask, rel)]
    return bisect.bisect_attention(variant, *args, H).numpy()


@pytest.mark.parametrize("variant", ["full", "nobias", "nosoftmax", "matmulonly"])
def test_variant_matches_jax_kernel(variant, monkeypatch):
    q, k, v, mask, rel = _inputs(ragged=variant != "nosoftmax")
    want = _jax_variant(variant, q, k, v, mask, rel, monkeypatch)
    got = _ours(variant, q, k, v, mask, rel)
    np.testing.assert_allclose(got, want, atol=1e-5 * float(np.abs(want).max()), rtol=0)
    assert float(np.abs(want).max()) > 1e-2  # the limit is not vacuous


def test_nosoftmax_mask_term_matches_jax_kernel(monkeypatch):
    """On the ragged mask, row 0 (no masked key) keeps ~1e-2 outputs and
    row 1 carries the -1e10 term of its 56 masked keys: each row against
    the JAX kernel within 1e-5 of its own max|ref|."""
    q, k, v, mask, rel = _inputs()
    want = _jax_variant("nosoftmax", q, k, v, mask, rel, monkeypatch)
    got = _ours("nosoftmax", q, k, v, mask, rel)
    scale = np.abs(want).reshape(B, -1).max(axis=1)
    assert scale[0] < 1.0 < 1e5 < scale[1]
    for row in range(B):
        np.testing.assert_allclose(got[row], want[row], atol=1e-5 * scale[row], rtol=0)


def test_sharedcmp_is_full_with_one_bias_entry_per_tile(monkeypatch):
    """The TPU harness's sharedcmp computes full's function; the port's adds
    to every pair of a (64-query, 64-key) tile pair the table entry of the
    tiles' first positions: a numpy transcription of that definition."""
    q, k, v, mask, rel = _inputs(1)
    np.testing.assert_allclose(_jax_variant("sharedcmp", q, k, v, mask, rel, monkeypatch),
                               _jax_variant("full", q, k, v, mask, rel, monkeypatch),
                               atol=1e-5)
    table = tfa.bucket_table(32, 128, torch.device("cpu")).numpy()
    start = np.arange(L) // 64 * 64
    rel_idx = np.clip(start[None, :] - start[:, None], -128, 128) + 128
    bias = rel[table[rel_idx]].transpose(2, 0, 1)  # [H, L, L]
    qh, kh, vh = (x.reshape(B, L, H, D).transpose(0, 2, 1, 3) for x in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", qh.astype(np.float64), kh) + bias[None]
    s = np.where(mask[:, None, None, :] == 1, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), vh)
    want = want.transpose(0, 2, 1, 3).reshape(B, L, H * D)
    np.testing.assert_allclose(_ours("sharedcmp", q, k, v, mask, rel), want, atol=1e-5)


def test_full_is_the_encoder_attention():
    q, k, v, mask, rel = (torch.from_numpy(x) for x in _inputs(2))
    torch.testing.assert_close(bisect.bisect_attention("full", q, k, v, mask, rel, H),
                               tfa.encoder_attention_reference(q, k, v, mask, rel, H),
                               atol=0, rtol=0)


def test_harness_runs_on_cpu_and_refuses_a_block_sweep():
    rows = bisect.main(["--device", "cpu", "--batch", "1", "--seq", "128", "--heads", "2",
                        "--layers", "2", "--reps", "1", "--block-kv", "64"])
    assert [r["variant"] for r in rows] == ["production", "production_bk64", *bisect.VARIANTS]
    assert all(r["ms_per_layer"] > 0 and r["device"] == "cpu" for r in rows)
    with pytest.raises(SystemExit):
        bisect.main(["--device", "cpu", "--sweep-block-q", "256"])
    with pytest.raises(ValueError, match="variant"):
        bisect.bisect_attention("nope", *(torch.zeros(1) for _ in range(5)), 1)


def test_variant_error_scales_with_the_output():
    """The card checks' limits follow the output's own size: an error of 1%
    of a ~1e-2 output fails in float32 and passes in bf16; a 5% one fails
    both; a non-finite value fails, and so does a comparison of zeros."""
    want = torch.from_numpy(np.random.default_rng(3).normal(0, 1e-2, (4, 64)).astype(np.float32))
    assert bisect.variant_error(want.clone(), want)["ok"]
    assert not bisect.variant_error(want * 1.01, want)["ok"]
    assert bisect.variant_error((want * 1.01).bfloat16(), want.bfloat16())["ok"]
    assert not bisect.variant_error((want * 1.05).bfloat16(), want.bfloat16())["ok"]
    bad = want.clone()
    bad[0, 0] = float("nan")
    assert not bisect.variant_error(bad, want)["ok"]
    assert not bisect.variant_error(torch.zeros(4, 64), torch.zeros(4, 64))["ok"]


def test_launch_keys_of_profiled_kernels():
    """Profiled kernel names map to their launch counts: the modes and
    routes of every attention kernel; the forward's ablation variants (the
    harness's own counts) map to none."""
    assert tfa.launch_key("void attn_fwd_kernel<float, 0, 0, 64, 3>(...)") is None
    assert tfa.launch_key("void attn_fwd_kernel<float, 0, 0, 64, 0>(...)") == "encoder_attn"
    assert tfa.launch_key("attn_fwd_kernel<__nv_bfloat16, 3, 0, 128, 0>") == "scaled_causal_attn"
    assert tfa.launch_key("attn_bwd_dkv_kernel<float, 3, 1, 128>") == (
        "scaled_causal_attn_long_bwd_dkv")
    assert tfa.launch_key("attn_fwd_kernel<float, 2, 2, 64, 0>") == "cross_attn_long_lse"
    assert tfa.launch_key("sm90_xmma_gemm_bf16bf16") is None
    assert set(bisect.KERNEL_LAUNCHES) == {f"bisect_{v}" for v in bisect.VARIANTS}
