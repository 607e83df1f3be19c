"""PyTorch port, kernels 11 and 12 (``ops/quant_matmul.py``): the plan that
picks each product's kernel body and tiling, checked on the CPU.

The plan must cover every 64-deep K tile exactly once over its splits (a
tile lost or taken twice is a wrong output tile the card would only show
as a rare bad value), size the split workspace to the plan, send every
routed LLaMA-7B product to a tensor-core body, and keep the shapes a TMA
tensor map cannot describe on the simple body. The decode body rounds the
int4 scale to bf16 before its product with the nibble (one bf16x2 multiply)
where the JAX kernel multiplies in fp32: a plain emulation of that order is
held to the JAX kernel in interpret mode at K 4096, group 128, and its
largest error is stated as a fraction of the card tests' limit. Also the
timing script's ``--quant`` arguments."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from reprover_tpu.ops.quant_matmul import quant4_matmul as jax_quant4_matmul
from reprover_tpu_torch.models import quantize as qz
from reprover_tpu_torch.ops import kernel_timing
from reprover_tpu_torch.ops import quant_matmul as qm
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

SMS = 132  # the H100's SMs
ROWS = [1, 2, 7, 31, 32, 33, 63, 64, 65, 127, 128, 129, 511, 1000, 2044, 2048]
RAGGED = [(1472, 384), (200, 96), (100, 16), (11008, 200), (64, 4096), (1472, 24)]


def _groups(bits, k):
    return [0] if bits == 8 else sorted({qz._group_for(k, 128), 16, 64})


def _cases():
    for k, n in chip_smoke.LLAMA_WEIGHT_SHAPES + RAGGED:
        for bits in (8, 4):
            if bits == 4 and k % 2:
                continue
            for group in _groups(bits, k):
                if bits == 4 and k % group:
                    continue
                yield k, n, bits, group


def _k_ranges(plan, k_tiles):
    """The ``[begin, end)`` k-tile range of each split, as the kernels take
    them: blockIdx.z * tiles_per_split onward, up to the last tile."""
    return [(z * plan.tiles_per_split, min(k_tiles, (z + 1) * plan.tiles_per_split))
            for z in range(plan.splits)]


def _decode_dequantize4(packed, scale, group):
    """``[K, N]`` bf16 as the decode body dequantizes int4: the exact bf16
    nibble times the group scale rounded to bf16, one bf16 rounding of the
    product (the plain version rounds the fp32 product instead)."""
    w_int = qm.unpack_int4(packed)
    k, n = w_int.shape
    s_full = scale[:, None, :].expand(k // group, group, n).reshape(k, n)
    return w_int.to(torch.bfloat16) * s_full.to(torch.bfloat16)


@pytest.mark.parametrize("k, n, bits, group", list(_cases()))
def test_plan_covers_every_k_tile_once(k, n, bits, group):
    k_tiles = -(-k // qm.K_TILE)
    for m in ROWS:
        plan = qm.quant_plan(bits, m, n, k, group, SMS)
        ranges = _k_ranges(plan, k_tiles)
        assert len(ranges) == plan.splits >= 1
        covered = [t for begin, end in ranges for t in range(begin, end)]
        assert covered == list(range(k_tiles)), (m, plan)
        assert all(end > begin for begin, end in ranges), (m, plan)
        assert plan.workspace_bytes == (4 * plan.splits * m * n if plan.splits > 1 else 0)
        if plan.body == "simple":
            assert plan.splits == 1 and plan.tile_m == plan.tile_n == qm.SIMPLE_TILE
        elif plan.regime == "decode":
            assert m <= qm.DECODE_MAX_ROWS and plan.tile_m in (32, 64) and m <= plan.tile_m
            assert plan.out_tiles == -(-n // qm.DECODE_TILE_N)
        else:
            assert m > qm.DECODE_MAX_ROWS and plan.out_tiles == (
                -(-m // qm.ADMIT_TILE_M) * -(-n // qm.ADMIT_TILE_N))
        # Split only to fill the card: never more blocks than the target needs.
        if plan.splits > 1:
            target = qm.BLOCKS_PER_SM[plan.regime] * SMS
            assert plan.out_tiles < target
            assert plan.out_tiles * (plan.splits - 1) < target


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k, n", chip_smoke.LLAMA_WEIGHT_SHAPES)
@pytest.mark.parametrize("m, regime", [(chip_smoke.LLAMA["num_slots"] * chip_smoke.LLAMA["num_beams"],
                                        "decode"), (chip_smoke.LLAMA_ADMIT_ROWS, "admission")])
def test_routed_llama_shapes_take_a_tensor_core_body(bits, k, n, m, regime):
    """Every LLaMA-7B weight shape at the engine's decode and admission rows,
    with the group the quantizer picks (32 at K = 11008)."""
    group = qz._group_for(k, 128) if bits == 4 else 2
    plan = qm.quant_plan(bits, m, n, k, group, SMS)
    assert (plan.body, plan.regime) == ("tma", regime)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m, k, n, group, aligned", [
    (5, 256, 200, 64, True),     # the card test's N = 200: a weight row of 200 bytes
    (32, 4096, 4096, 128, False),  # a base off a 16-byte boundary
    (32, 4100, 4096, 4, True),   # an x row of 8200 bytes; an int4 group of 4
    (32, 4096, 4104, 8, True),   # a weight row of 4104 bytes; a group of 8
])
def test_shapes_tma_cannot_describe_take_the_simple_body(bits, m, k, n, group, aligned):
    plan = qm.quant_plan(bits, m, n, k, group, SMS, aligned)
    assert plan.body == "simple" and plan.splits == 1


def test_int4_groups_that_split_a_tile_take_the_simple_body():
    """A 64-deep tile must lie in one group or hold whole groups."""
    assert qm.tma_shape_ok(4, 32, 4096, 4096, 16) and qm.tma_shape_ok(4, 32, 4096, 4096, 32)
    assert qm.tma_shape_ok(4, 32, 4096, 4096, 128) and qm.tma_shape_ok(4, 32, 4096, 4608, 192)
    assert not qm.tma_shape_ok(4, 32, 4096, 4800, 96)  # 96 neither divides 64 nor is a multiple
    assert not qm.tma_shape_ok(4, 32, 4096, 4096, 8)


def test_decode_int4_rounding_against_the_jax_kernel():
    """The decode body's order, bf16(nibble * bf16(scale)) then an fp32
    product, against the JAX kernel (bf16(nibble * scale)) in interpret
    mode at K 4096, group 128, on bf16 activations, stated as a fraction of
    the limits the card holds the kernel to: 2e-2 x max(1, max|ref|) and,
    row by row, 2e-2 of the row's own max|ref|. Measured at this seed: 0.106
    of the first (about one bf16 rounding of the output: 2^-9 of max|ref| is
    0.098 of it) and 0.184 of the second; the plain version (the JAX order,
    fp32 sums in another order) 1.1e-5. 6.6% of the weights move by one bf16
    step."""
    rng = np.random.default_rng(4096)
    m, k, n, group = 32, 4096, 256, 128
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * rng.uniform(0.1, 10.0, size=n)).astype(np.float32)
    qw = qz.quantize_weight4(torch.from_numpy(w), group=group)
    assert qw.group == group
    x_bf16 = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jax_quant4_matmul(
        jnp.asarray(x_bf16.float().numpy()).astype(jnp.bfloat16), jnp.asarray(qw.q.numpy()),
        jnp.asarray(qw.scale.numpy()), group=group, out_dtype=jnp.float32, interpret=True))
    emulated = (x_bf16.float() @ _decode_dequantize4(qw.q, qw.scale, group).float()).numpy()
    plain = qm.quant4_matmul_reference(x_bf16, qw.q, qw.scale, group, torch.float32).numpy()
    limit = 2e-2 * max(1.0, float(np.abs(want).max()))
    row_limit = 2e-2 * np.abs(want).max(axis=1, keepdims=True)
    emulated_frac = float(np.abs(emulated - want).max()) / limit
    emulated_row_frac = float((np.abs(emulated - want) / row_limit).max())
    plain_frac = float(np.abs(plain - want).max()) / limit
    assert 0.05 < emulated_frac < 0.15 and emulated_row_frac < 0.25
    assert plain_frac < 1e-4
    # The orders differ by at most one bf16 step of a weight.
    dec = _decode_dequantize4(qw.q, qw.scale, group).float()
    jax_order = qm.dequantize4_weight(qw.q, qw.scale, group, torch.bfloat16).float()
    moved = dec != jax_order
    assert 0.0 < float(moved.float().mean()) < 0.1
    assert float(((dec - jax_order).abs()[moved] / jax_order.abs()[moved]).max()) <= 2 ** -7


def test_kernel_timing_quant_arguments():
    assert kernel_timing.parse_quant("32x4096x11008, 2044x4096x4096") == [
        (32, 4096, 11008), (2044, 4096, 4096)]
    assert kernel_timing.parse_quant("") == []
    for bad in ("32x4096", "0x4096x4096", "32x4096xN"):
        with pytest.raises(ValueError):
            kernel_timing.parse_quant(bad)
    args = kernel_timing.build_parser().parse_args(
        ["--checkout", "parent", "--label", "p", "--shapes", "", "--quant", "32x4096x4096"])
    assert args.quant == "32x4096x4096" and args.shapes == ""
    args = kernel_timing.build_parser().parse_args(
        ["--checkout", "parent", "--label", "p", "--shapes", "", "--engine", "3"])
    assert args.engine == 3 and args.quant == ""


def test_kernel_timing_engine_samples_on_cpu():
    """``--engine``'s loop at a tiny width on the CPU: every sample admits a
    wave and steps it (times on the host clock)."""
    from reprover_tpu_torch.models.causal_lm import CausalLMConfig

    cfg = CausalLMConfig(vocab_size=512, d_model=64, num_layers=2, num_heads=4, num_kv_heads=4,
                         d_ff=128, compute_dtype=torch.float32)
    row = kernel_timing.time_engine(2, seed=0, cfg=cfg, device="cpu", num_slots=2, num_beams=2,
                                    src=16, dec=9, chunk=2, chunks=2)
    assert row["d_model"] == 64 and row["steps_per_sample"] == 4
    assert len(row["admit_ms"]) == len(row["ms_per_step"]) == 2
    assert all(t > 0 for t in row["admit_ms"] + row["ms_per_step"])
