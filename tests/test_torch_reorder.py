"""PyTorch port, kernel 13: the per-beam cache reorder + fresh-column append
(``ops/beam_reorder.py`` and the engine's ``"einsum"``/``"scan"`` modes)
against the JAX package. The same numpy inputs go through the JAX Pallas
kernel in interpret mode, the JAX einsum path, the port's plain gather
(the CPU side of ``reorder_append_gather``) and the port's einsum and scan
modes: all must be bit-equal (a reorder moves values and computes none)."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reprover_tpu.generation.engine import reorder_append as jax_reorder_append
from reprover_tpu.ops.beam_reorder import reorder_append_gather as jax_gather
from reprover_tpu_torch.generation import engine as te
from reprover_tpu_torch.ops import beam_reorder as br
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

L, S, K, H, T, D = 2, 3, 4, 2, 8, 4
# [L, S, K, H, T, d]: the default, one beam a slot, one head.
SHAPES = [(L, S, K, H, T, D), (L, S, 1, H, T, D), (L, S, K, 1, T, D)]
# The index dtypes the engines pass (int64 parents and positions) and int32.
INDEX = [np.int64, np.int32]


def _case(seed, shape=SHAPES[0], index=np.int32):
    l, s, k_, h, t, d = shape
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(l, s, k_, h, t, d)).astype(np.float32)
    v = rng.normal(size=(l, s, k_, h, t, d)).astype(np.float32)
    kc = rng.normal(size=(l, s, k_, h, 1, d)).astype(np.float32)
    vc = rng.normal(size=(l, s, k_, h, 1, d)).astype(np.float32)
    parent = rng.integers(0, k_, (s, k_)).astype(index)
    frozen = np.array([False, True, False])
    pos = np.array([0, 5, t - 1], index)
    return k, v, kc, vc, parent, frozen, pos


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("index", INDEX)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_einsum_scan_bit_equal_to_jax(seed, shape, index):
    """pos at 0, inside and at T - 1; a frozen slot; int64 and int32 indices
    read as they are; K = 1 and H = 1."""
    k, v, kc, vc, parent, frozen, pos = _case(seed, shape, index)
    want_k, want_v = jax_gather(*map(jnp.asarray, (k, v, kc, vc, parent, frozen, pos)),
                                interpret=True)
    np.testing.assert_array_equal(
        np.asarray(want_k), np.asarray(jax_reorder_append(k, kc, parent, frozen, pos)))

    tk, tv, tkc, tvc, tparent, tfrozen, tpos = _torch(k, v, kc, vc, parent, frozen, pos)
    before = br.KERNEL_LAUNCHES["beam_reorder"]
    got_k, got_v = br.reorder_append_gather(tk, tv, tkc, tvc, tparent, tfrozen, tpos)
    assert br.KERNEL_LAUNCHES["beam_reorder"] == before  # a CPU tensor runs the plain version
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))

    ein_k = te.reorder_append(tk, tkc, tparent, tfrozen, tpos)
    np.testing.assert_array_equal(ein_k.numpy(), np.asarray(want_k))
    sk, sv = te.reorder_append_scan(tk.clone(), tv.clone(), tkc, tvc, tparent, tfrozen, tpos)
    np.testing.assert_array_equal(sk.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(sv.numpy(), np.asarray(want_v))


def test_gather_frozen_slot_keeps_rows():
    """A fully frozen batch reduces to the identity copy plus the column
    installed at each slot's pos (never read)."""
    k = np.arange(L * S * K * H * T * D, dtype=np.float32).reshape(L, S, K, H, T, D)
    v = k + 1.0
    kc = np.full((L, S, K, H, 1, D), -1.0, np.float32)
    vc = np.full((L, S, K, H, 1, D), -2.0, np.float32)
    parent = np.zeros((S, K), np.int32)  # would collapse all beams to 0 ...
    frozen = np.ones((S,), bool)  # ... but frozen forces the identity
    pos = np.full((S,), 3, np.int32)
    got_k, got_v = br.reorder_append_gather(*_torch(k, v, kc, vc, parent, frozen, pos))
    want_k = np.asarray(jax_reorder_append(k, kc, parent, frozen, pos))
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_v.numpy()[:, :, :, :, :3], v[:, :, :, :, :3])
    np.testing.assert_array_equal(got_v.numpy()[:, :, :, :, 3], vc[:, :, :, :, 0])


@pytest.mark.parametrize("index", INDEX)
@pytest.mark.parametrize("positions", [(2, 7, 5), (0, 6, 5)])
def test_gather_on_bucket_prefix_of_full_buffer(positions, index):
    """On the ``T_live`` prefix view of a full buffer (the engine's step
    bucket) the output is the JAX reorder of the sliced cache, written into
    the prefix of the output buffer only; a position at or past the prefix
    (7, 6) installs nothing, one at 0 or ``T_live - 1`` (5) its column."""
    k, v, kc, vc, parent, frozen, pos = _case(3, index=index)
    t_live = 6
    pos = np.array(positions, index)
    tk, tv, tkc, tvc, tparent, tfrozen, tpos = _torch(k, v, kc, vc, parent, frozen, pos)
    out_k, out_v = torch.full_like(tk, 7.0), torch.full_like(tv, 7.0)
    br.reorder_append_gather(tk[..., :t_live, :], tv[..., :t_live, :], tkc, tvc, tparent,
                             tfrozen, tpos, out_k[..., :t_live, :], out_v[..., :t_live, :])
    want = jax_gather(*map(jnp.asarray, (k[..., :t_live, :], v[..., :t_live, :], kc, vc, parent,
                                         frozen, pos)), interpret=True)
    np.testing.assert_array_equal(out_k[..., :t_live, :].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(out_v[..., :t_live, :].numpy(), np.asarray(want[1]))
    assert (out_k[..., t_live:, :] == 7.0).all() and (out_v[..., t_live:, :] == 7.0).all()


@pytest.mark.parametrize("bad", ["in_place", "dtype", "col_shape", "not_prefix", "parent_float",
                                 "parent_int16", "pos_int16", "pos_float", "mixed_index",
                                 "frozen_int"])
def test_gather_checks_operands(bad):
    """The wrapper raises on what the kernel does not take, on either device:
    an index dtype it does not read as it is raises, and is not converted."""
    k, v, kc, vc, parent, frozen, pos = _torch(*_case(4))
    out_k, out_v = torch.empty_like(k), torch.empty_like(v)
    if bad == "in_place":
        out_k = k
    elif bad == "dtype":
        kc = kc.double()
    elif bad == "col_shape":
        kc = kc[:, :, :, :, :, :2].contiguous()
    elif bad == "parent_float":
        parent = parent.float()
    elif bad == "parent_int16":
        parent, pos = parent.to(torch.int16), pos.to(torch.int16)
    elif bad == "pos_int16":
        pos = pos.to(torch.int16)
    elif bad == "pos_float":
        pos = pos.float()
    elif bad == "mixed_index":
        parent = parent.long()
    elif bad == "frozen_int":
        frozen = frozen.to(torch.int32)
    else:
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        br.reorder_append_gather(k, v, kc, vc, parent, frozen, pos, out_k, out_v)


def test_production_reorder_default_is_auto():
    """The engines default to "auto", which resolves as the JAX package
    resolves it (einsum below ``AUTO_SCAN_CACHE_BYTES`` of KV cache, scan at
    or above it; the JAX package's threshold, kept)."""
    from reprover_tpu.generation.engine import AUTO_SCAN_CACHE_BYTES as JAX_THRESHOLD
    from reprover_tpu.generation.engine import resolve_reorder_mode as jax_resolve
    from reprover_tpu_torch.generation.causal_engine import CausalStepwiseEngine

    assert te.AUTO_SCAN_CACHE_BYTES == JAX_THRESHOLD
    for nbytes in (0, JAX_THRESHOLD - 1, JAX_THRESHOLD, 1 << 40):
        for mode in te.REORDER_MODES:
            assert te.resolve_reorder_mode(mode, nbytes) == jax_resolve(mode, nbytes)
    for cls in (te.StepwiseBeamEngine, CausalStepwiseEngine):
        assert inspect.signature(cls.__init__).parameters["reorder_mode"].default == "auto"


def test_reorder_mode_threads_through_serving_stack():
    """``reorder_mode`` is selectable from the serving boundary: the
    generator wrappers and the streaming service expose and forward it."""
    from reprover_tpu_torch.generation.causal_generator import CausalTacticGeneratorModel
    from reprover_tpu_torch.generation.generator import TacticGeneratorModel
    from reprover_tpu_torch.prover.service import StreamingInferenceService

    for fn in (TacticGeneratorModel.make_stepwise_engine,
               CausalTacticGeneratorModel.make_stepwise_engine,
               StreamingInferenceService.__init__):
        assert inspect.signature(fn).parameters["reorder_mode"].default == "auto", fn
    for fn in (TacticGeneratorModel.make_stepwise_engine,
               CausalTacticGeneratorModel.make_stepwise_engine,
               StreamingInferenceService._build_engine):
        src = inspect.getsource(fn).replace('reorder_mode: str = "auto"', "")
        assert "reorder_mode=" in src, f"{fn} does not forward reorder_mode"


@pytest.mark.parametrize("spec, want", [
    ("4x2x64x6x512x64", ((4, 2, 64, 6, 512, 64), 512)),
    ("4x2x64x6x512x64:64", ((4, 2, 64, 6, 512, 64), 64)),
    ("32x4x8x16x129x128:129", ((32, 4, 8, 16, 129, 128), 129)),
])
def test_kernel_timing_parses_reorder_shapes(spec, want):
    from reprover_tpu_torch.ops.kernel_timing import build_parser, parse_reorder

    assert parse_reorder(spec) == want
    args = build_parser().parse_args(["--checkout", ".", "--label", "x", "--reorder", spec,
                                      "--reorder", "1x1x1x1x1x8"])
    assert args.reorder == [spec, "1x1x1x1x1x8"]


@pytest.mark.parametrize("spec", ["4x2x64x6x512", "4x2x64x6x512x64:0", "4x2x64x6x512x64:513",
                                  "4x2x0x6x512x64", "4x2x64x6x512x64:a"])
def test_kernel_timing_rejects_bad_reorder_shapes(spec):
    from reprover_tpu_torch.ops.kernel_timing import parse_reorder

    with pytest.raises(ValueError):
        parse_reorder(spec)


def test_reorder_bound_counts_distinct_parents():
    """The bound reads each slot's distinct effective parents once (a frozen
    slot's beams are their own) and writes every new beam; the second
    figure reads a parent once for every child, with the column."""
    from reprover_tpu_torch.ops.kernel_timing import PEAK_BYTES_PER_S, reorder_bound_ms

    parent = torch.tensor([[0, 0, 1, 1], [0, 0, 0, 0], [3, 3, 3, 3]])
    frozen = torch.tensor([False, True, False])
    needed, every = reorder_bound_ms((L, S, K, H, T, D), 6, parent, frozen, 4)
    row = D * 4
    written = 2 * L * S * K * H * 6 * row
    assert needed == pytest.approx(1e3 * (written + 2 * L * (2 + 4 + 1) * H * 6 * row)
                                   / PEAK_BYTES_PER_S)
    assert every == pytest.approx(1e3 * (2 * written + 2 * L * S * K * H * row) / PEAK_BYTES_PER_S)
