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

L, S, K, H, T, D = 2, 3, 4, 2, 8, 4


def _case(seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(L, S, K, H, T, D)).astype(np.float32)
    v = rng.normal(size=(L, S, K, H, T, D)).astype(np.float32)
    kc = rng.normal(size=(L, S, K, H, 1, D)).astype(np.float32)
    vc = rng.normal(size=(L, S, K, H, 1, D)).astype(np.float32)
    parent = rng.integers(0, K, (S, K)).astype(np.int32)
    frozen = np.array([False, True, False])
    pos = np.array([0, 5, T - 1], np.int32)
    return k, v, kc, vc, parent, frozen, pos


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_einsum_scan_bit_equal_to_jax(seed):
    k, v, kc, vc, parent, frozen, pos = _case(seed)
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


def test_gather_on_bucket_prefix_of_full_buffer():
    """On the ``T_live`` prefix view of a full buffer (the engine's step
    bucket) the output is the JAX reorder of the sliced cache, written into
    the prefix of the output buffer only; a position past the prefix
    installs nothing."""
    k, v, kc, vc, parent, frozen, pos = _case(3)
    t_live = 6
    pos = np.array([2, 7, 5], np.int32)  # slot 1's column lies past the prefix
    tk, tv, tkc, tvc, tparent, tfrozen, tpos = _torch(k, v, kc, vc, parent, frozen, pos)
    out_k, out_v = torch.full_like(tk, 7.0), torch.full_like(tv, 7.0)
    br.reorder_append_gather(tk[..., :t_live, :], tv[..., :t_live, :], tkc, tvc, tparent,
                             tfrozen, tpos, out_k[..., :t_live, :], out_v[..., :t_live, :])
    want = jax_gather(*map(jnp.asarray, (k[..., :t_live, :], v[..., :t_live, :], kc, vc, parent,
                                         frozen, pos)), interpret=True)
    np.testing.assert_array_equal(out_k[..., :t_live, :].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(out_v[..., :t_live, :].numpy(), np.asarray(want[1]))
    assert (out_k[..., t_live:, :] == 7.0).all() and (out_v[..., t_live:, :] == 7.0).all()


@pytest.mark.parametrize("bad", ["in_place", "dtype", "col_shape", "not_prefix"])
def test_gather_checks_operands(bad):
    """The wrapper raises on what the kernel does not take, on either device."""
    k, v, kc, vc, parent, frozen, pos = _torch(*_case(4))
    out_k, out_v = torch.empty_like(k), torch.empty_like(v)
    if bad == "in_place":
        out_k = k
    elif bad == "dtype":
        kc = kc.double()
    elif bad == "col_shape":
        kc = kc[:, :, :, :, :, :2].contiguous()
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
