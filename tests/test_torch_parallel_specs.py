"""PyTorch port, sharding specs: every spec builder of
``reprover_tpu_torch.parallel.sharding`` against the JAX package's, leaf by
leaf (``PartitionSpec`` as tuples), on tiny T5 and causal-LM trees (fused
and split MLP, int8 and int4) and byt5-small's, all as shapes (``jax.
eval_shape``, the port's ``meta`` tensors),
and at ``data`` 2, 4 and 8; ``_legalize_spec`` replicates what the mesh
does not divide, as the JAX package does, and warns where it is silent."""

import functools
import logging

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from reprover_tpu.models import causal_lm as jcausal
from reprover_tpu.models import quantize as jquant
from reprover_tpu.models import t5 as jt5
from reprover_tpu.parallel import make_mesh as jax_make_mesh
from reprover_tpu.parallel import sharding as jsharding
from reprover_tpu_torch.models import quantize as tquant
from reprover_tpu_torch.parallel import sharding as tsharding
from reprover_tpu_torch.parallel.mesh import Mesh
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2, num_decoder_layers=1)
CAUSAL = dict(vocab_size=96, d_model=64, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=128)


def _norm(tree):
    """A spec tree of either package as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return {"q": _norm(tree.q), "scale": _norm(tree.scale)}
    assert isinstance(tree, (P, tuple)), type(tree)
    return tuple(tree)


def _meta(tree):
    """The port's tree of a JAX shape tree: ``meta`` tensors (no memory),
    quantized nodes as the port's classes."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, jquant.QuantWeight):
        q, scale = _meta(tree.q), _meta(tree.scale)
        if isinstance(tree, jquant.Quant4Weight):
            return tquant.Quant4Weight(q=q, scale=scale, group=tree.group)
        return tquant.QuantWeight(q=q, scale=scale)
    return torch.empty(tree.shape, device="meta")


@functools.lru_cache(maxsize=None)
def _t5(kind):
    """(JAX shape tree, port tree) of a T5: tiny with split / fused / int8 /
    int4 MLP weights, or byt5-small's shapes; no weights are made."""
    def build():
        cfg = jt5.byt5_small() if kind == "byt5_shapes" else jt5.T5Config(**TINY)
        params = jt5.init_params(jax.random.PRNGKey(0), cfg)
        if kind != "split":
            params = jt5.fuse_mlp_params(params)
        if kind in ("int8", "int4"):
            params = jquant.quantize_t5_params(params, bits=8 if kind == "int8" else 4)
        return params

    shapes = jax.eval_shape(build)
    return shapes, _meta(shapes)


@functools.lru_cache(maxsize=None)
def _causal(kind):
    def build():
        params = jcausal.init_params(jax.random.PRNGKey(1), jcausal.CausalLMConfig(**CAUSAL))
        if kind in ("int8", "int4"):
            params = jquant.quantize_causal_params(params, bits=8 if kind == "int8" else 4)
        return params

    shapes = jax.eval_shape(build)
    return shapes, _meta(shapes)


T5_KINDS = ("split", "fused", "int8", "int4", "byt5_shapes")


@pytest.mark.parametrize("model_parallel", [False, True])
@pytest.mark.parametrize("kind", T5_KINDS)
def test_param_partition_specs_match_jax(kind, model_parallel):
    jparams, tparams = _t5(kind)
    cfg = jt5.T5Config(**TINY)
    want = _norm(jsharding.param_partition_specs(jparams, cfg, model_parallel))
    assert _norm(tsharding.param_partition_specs(tparams, cfg, model_parallel)) == want


@pytest.mark.parametrize("model_parallel", [False, True])
@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
def test_causal_param_partition_specs_match_jax(kind, model_parallel):
    jparams, tparams = _causal(kind)
    want = _norm(jsharding.causal_param_partition_specs(jparams, model_parallel))
    assert _norm(tsharding.causal_param_partition_specs(tparams, model_parallel)) == want


@pytest.mark.parametrize("with_param_specs", [False, True])
@pytest.mark.parametrize("data", [2, 4, 8])
@pytest.mark.parametrize("kind", ["split", "fused", "byt5_shapes", "causal"])
def test_zero_partition_specs_match_jax(kind, data, with_param_specs):
    """Moment specs at ``data`` 2, 4 and 8, pure data-parallel and keeping
    the tensor-parallel split (``param_specs``)."""
    jparams, tparams = _causal("float") if kind == "causal" else _t5(kind)
    if kind == "causal":
        jspec = jsharding.causal_param_partition_specs(jparams, True)
        tspec = tsharding.causal_param_partition_specs(tparams, True)
    else:
        cfg = jt5.T5Config(**TINY)
        jspec = jsharding.param_partition_specs(jparams, cfg, True)
        tspec = tsharding.param_partition_specs(tparams, cfg, True)
    jmesh = jax_make_mesh(data=data)
    want = jsharding.zero_partition_specs(jparams, jmesh,
                                          param_specs=jspec if with_param_specs else None)
    got = tsharding.zero_partition_specs(tparams, Mesh(data),
                                         param_specs=tspec if with_param_specs else None)
    assert _norm(got) == _norm(want)
    assert any("data" in s for s in jax.tree.leaves(_norm(got), is_leaf=lambda x:
                                                     isinstance(x, tuple)))


@pytest.mark.parametrize("spec, shape, mesh", [
    (("data", None), (6, 4), Mesh(4)),
    ((None, "model"), (8, 3), Mesh(2, 2)),
    ((("data", "model"),), (6,), Mesh(2, 2)),
    (("data", "model"), (8, 4), Mesh(2, 2)),
])
def test_legalize_spec_replicates_like_jax_and_warns(spec, shape, mesh, caplog):
    """Where the mesh does not divide an axis both packages replicate it;
    the port logs a warning for each such axis (reference fault 5)."""
    jmesh = jax_make_mesh(data=mesh.data, model=mesh.model)
    want = tuple(jsharding._legalize_spec(P(*spec), shape, jmesh))
    with caplog.at_level(logging.WARNING, logger="reprover_tpu_torch.parallel.sharding"):
        got = tsharding._legalize_spec(spec, shape, mesh)
    assert got == want
    dropped = sum(1 for a, b in zip(spec, got) if a is not None and b is None)
    warned = [r for r in caplog.records if "replicated" in r.getMessage()]
    assert len(warned) == dropped


def test_shard_pytree_gives_this_ranks_shard():
    """``shard_pytree``: each coordinate's slice of each split axis, in
    ``model``-innermost order; undivided axes whole (with a warning)."""
    x = torch.arange(8 * 6).reshape(8, 6)
    specs = {"a": ("data", "model"), "b": (("data", "model"),), "c": ("model",)}
    tree = {"a": x, "b": torch.arange(8), "c": torch.arange(5)}
    for d in range(2):
        for m in range(2):
            got = tsharding.shard_pytree(tree, specs, Mesh(2, 2, (d, m)))
            assert torch.equal(got["a"], x[4 * d:4 * d + 4, 3 * m:3 * m + 3])
            assert torch.equal(got["b"], torch.arange(8)[2 * (2 * d + m):2 * (2 * d + m) + 2])
            assert torch.equal(got["c"], torch.arange(5))
