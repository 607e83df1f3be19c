"""PyTorch port, kernels 11 and 12 and weight-only quantized serving
(``models/quantize.py``, ``ops/quant_matmul.py``) against the JAX package.

Quantization is integer rounding of the same float32 weights, so the port's
int8 weights, packed nibbles and scales must equal the JAX package's bit for
bit. The plain matrix products (the CPU side of ``quant_matmul`` /
``quant4_matmul``) are held to the JAX Pallas kernels in interpret mode on
the same numpy inputs within atol 2e-4, rtol 1e-4: both compute the same
fp32 products, summed in another order. Engines serving quantized weights
must give their quantized classic path's beams: same texts, scores within
rtol 1e-5 (fp32 sums in another order over a few steps)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reprover_tpu.models import quantize as jqz
from reprover_tpu.ops.quant_matmul import quant4_matmul as jax_quant4_matmul
from reprover_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from reprover_tpu_torch.models import quantize as qz
from reprover_tpu_torch.ops import quant_matmul as qm


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 8), (1472, 24), (2304, 16), (4096, 8)])
def test_quantized_weights_bit_equal_to_jax(shape):
    """int8 weights/scales and int4 packed nibbles/scales/groups, including a
    stacked layer axis and the group fallbacks (1472 -> 64, 2304 -> 32)."""
    rng = np.random.default_rng(sum(shape))
    w = (rng.normal(size=shape) * rng.uniform(0.1, 10.0, size=shape[-1])).astype(np.float32)
    ours, theirs = qz.quantize_weight(torch.from_numpy(w)), jqz.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(ours.q.numpy(), np.asarray(theirs.q))
    np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(theirs.scale))
    ours4 = qz.quantize_weight4(torch.from_numpy(w))
    theirs4 = jqz.quantize_weight4(jnp.asarray(w))
    assert ours4.group == theirs4.group and ours4.q.dtype == torch.uint8
    np.testing.assert_array_equal(ours4.q.numpy(), np.asarray(theirs4.q))
    np.testing.assert_array_equal(ours4.scale.numpy(), np.asarray(theirs4.scale))
    np.testing.assert_array_equal(qz.dequantize4(ours4).numpy(), np.asarray(jqz.dequantize4(theirs4)))
    for k in (1472, 2304, 4096, 11008, 13824, 64, 6):
        assert qz._group_for(k, 128) == jqz._group_for(k, 128), k


def test_unpack_int4_nibble_order():
    """Row 2i is the low nibble of packed row i, row 2i+1 the high one."""
    from reprover_tpu.ops.quant_matmul import unpack_int4 as jax_unpack

    packed = np.arange(256, dtype=np.uint8).reshape(8, 32)
    ours = qm.unpack_int4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_unpack(jnp.asarray(packed))))
    assert ours[0, 1] == 1 and ours[1, 1] == 0 and ours[0, 15] == -1


@pytest.mark.parametrize("m, k, n", [(64, 1472, 384), (5, 256, 128), (1100, 256, 512)])
def test_plain_quant_matmul_matches_jax_interpret(m, k, n):
    rng = np.random.default_rng(m + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jw = jqz.quantize_weight(jnp.asarray(w))
    want = np.asarray(jax_quant_matmul(jnp.asarray(x), jw.q, jw.scale.reshape(-1), interpret=True))
    qw = qz.quantize_weight(torch.from_numpy(w))
    for out_dtype in (None, torch.float32):
        got = qm.quant_matmul(torch.from_numpy(x), qw.q, qw.scale.reshape(-1), out_dtype=out_dtype)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)
    assert qm.KERNEL_LAUNCHES["quant_matmul"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("m, k, n, g", [(8, 384, 1472, 128), (16, 4096, 256, 128),
                                        (4, 2304, 128, 128), (1100, 256, 512, 64)])
def test_plain_quant4_matmul_matches_jax_interpret(m, k, n, g):
    rng = np.random.default_rng(m + k + g)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jw = jqz.quantize_weight4(jnp.asarray(w), group=g)
    want = np.asarray(jax_quant4_matmul(jnp.asarray(x), jw.q, jw.scale, group=jw.group,
                                        interpret=True))
    qw = qz.quantize_weight4(torch.from_numpy(w), group=g)
    got = qm.quant4_matmul(torch.from_numpy(x), qw.q, qw.scale, qw.group)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_dense_and_logits_match_jax(bits):
    """The routed plain products of the models (``quantized_dense``,
    ``quantized_logits``) on weights carried over by the bridge."""
    from reprover_tpu_torch.models.bridge import _convert

    rng = np.random.default_rng(bits)
    x = rng.normal(size=(2, 3, 128)).astype(np.float32)
    w = rng.normal(size=(128, 48)).astype(np.float32)
    jw = (jqz.quantize_weight if bits == 8 else jqz.quantize_weight4)(jnp.asarray(w))
    tw = _convert(jax.tree.map(np.asarray, jw))
    assert isinstance(tw, qz.Quant4Weight if bits == 4 else qz.QuantWeight)
    for ours_fn, jax_fn in ((qz.quantized_dense, jqz.quantized_dense),
                            (qz.quantized_logits, jqz.quantized_logits)):
        got = ours_fn(torch.from_numpy(x), tw, torch.float32).numpy()
        want = np.asarray(jax_fn(jnp.asarray(x), jw, jnp.float32))
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_kernel_routing_thresholds():
    """The JAX package's routing rule, case for case (forced on), and at
    LLaMA-7B: in decode every projection and the lm_head route, int8 and
    int4; byt5-small's largest weight never does."""
    from jax import ShapeDtypeStruct as SDS

    def both(m, k, n, bits, force):
        if bits == 8:
            jw = jqz.QuantWeight(q=SDS((k, n), jnp.int8), scale=SDS((1, n), jnp.float32))
            tw = qz.QuantWeight(q=torch.empty((k, n), dtype=torch.int8, device="meta"),
                                scale=torch.empty((1, n), device="meta"))
            jfn = jqz._use_kernel
        else:
            g = jqz._group_for(k, 128)
            jw = jqz.Quant4Weight(q=SDS((k // 2, n), jnp.uint8), scale=SDS((k // g, n), jnp.float32),
                                  group=g)
            tw = qz.Quant4Weight(q=torch.empty((k // 2, n), dtype=torch.uint8, device="meta"),
                                 scale=torch.empty((k // g, n), device="meta"), group=g)
            jfn = jqz._use_kernel4
        old_j, old_t = jqz.FORCE_KERNEL, qz.FORCE_KERNEL
        jqz.FORCE_KERNEL = qz.FORCE_KERNEL = force
        try:
            theirs = jfn(SDS((m, k), jnp.bfloat16), jw, jnp.bfloat16)
            ours = qz._routes(m, tw, torch.bfloat16, on_card=False)
        finally:
            jqz.FORCE_KERNEL, qz.FORCE_KERNEL = old_j, old_t
        assert ours == theirs, (m, k, n, bits, force)
        return ours

    for bits in (8, 4):
        assert both(512, 11008, 4096, bits, True)
        assert both(512, 4096, 32000, bits, True)
        assert not both(512, 11008, 4096, bits, None)  # no card, no force: plain
        assert not both(512, 1472, 3584, bits, True)  # byt5-small: below the line
        assert not both(4096 * 64, 4096, 32000, bits, True)  # activation too large
        assert not both(2048, 11008, 4096, bits, True)  # admission down-projection
        assert both(2044, 4096, 11008, bits, True)  # admission gate/up
    from reprover_tpu_torch.models.causal_lm import CausalLMConfig, _shapes

    cfg = CausalLMConfig(compute_dtype=torch.bfloat16)
    for bits in (8, 4):
        tree = {}
        for name, (k, n) in list(_shapes(cfg).items()) + [("lm_head", (4096, 32000))]:
            q = (torch.empty((k, n), dtype=torch.int8, device="meta") if bits == 8 else
                 torch.empty((k // 2, n), dtype=torch.uint8, device="meta"))
            g = qz._group_for(k, 128)
            scale = torch.empty((1, n) if bits == 8 else (k // g, n), device="meta")
            tree[name] = (qz.QuantWeight(q=q, scale=scale) if bits == 8 else
                          qz.Quant4Weight(q=q, scale=scale, group=g))
        report = qz.routing_report(tree, 32, torch.bfloat16, torch.device("cuda"))
        kernel = "quant_matmul" if bits == 8 else "quant4_matmul"
        assert report == {name: kernel for name in tree}, report
        assert set(qz.routing_report(tree, 32, torch.bfloat16, torch.device("cpu")).values()) == {
            "plain"}
    assert qz._group_for(11008, 128) == 32 and qm._block_k4(11008, 32) == 256


def test_quantize_flag_strict():
    """Only True / 'int8' / 'int4' are legal, at every serving entry point."""
    from reprover_tpu_torch.generation.engine import StepwiseBeamEngine
    from reprover_tpu_torch.models.t5 import T5Config, init_params

    assert qz.resolve_quantize_bits(True) == 8
    assert qz.resolve_quantize_bits("int8") == 8
    assert qz.resolve_quantize_bits("int4") == 4
    for bad in ("INT4", "w4a16", "int16", 1, "true"):
        with pytest.raises(ValueError):
            qz.resolve_quantize_bits(bad)
    cfg = T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=1,
                   num_decoder_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        StepwiseBeamEngine(params, cfg, num_slots=2, num_beams=4, max_src_len=32,
                           max_decode_len=8, quantize="INT4")
    from reprover_tpu_torch.prover.evaluate import build_parser

    args = build_parser().parse_args(["--data-path", "d", "--quantize"])
    assert args.quantize == "int8"
    assert build_parser().parse_args(["--data-path", "d", "--quantize", "int4"]).quantize == "int4"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--data-path", "d", "--quantize", "INT4"])


def test_quantize_trees_target_matmuls_only_and_idempotent():
    from reprover_tpu_torch.models.causal_lm import CausalLMConfig
    from reprover_tpu_torch.models.causal_lm import init_params as init_causal
    from reprover_tpu_torch.models.t5 import T5Config, init_params

    cfg = T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                   num_decoder_layers=2)
    for bits in (8, 4):
        q = qz.quantize_t5_params(init_params(cfg, torch.Generator().manual_seed(0)), bits=bits)
        assert isinstance(q["encoder"]["layers"]["attn"]["q"], qz.QuantWeight)
        assert isinstance(q["lm_head"], qz.Quant4Weight if bits == 4 else qz.QuantWeight)
        assert not isinstance(q["shared_embedding"], qz.QuantWeight)
        assert not isinstance(q["encoder"]["rel_bias"], qz.QuantWeight)
        assert qz.quantize_t5_params(q, bits=bits)["lm_head"] is q["lm_head"]
    ccfg = CausalLMConfig(vocab_size=64, d_model=32, num_layers=2, num_heads=4, num_kv_heads=2,
                          d_ff=64)
    q = qz.quantize_causal_params(init_causal(ccfg, torch.Generator().manual_seed(0)))
    for key in ("q", "k", "v", "o", "gate", "up", "down"):
        assert isinstance(q["layers"][key], qz.QuantWeight), key
        assert isinstance(q["layers"][key][1], qz.QuantWeight)  # a layer's slice
    assert not isinstance(q["embedding"], qz.QuantWeight)
    assert not isinstance(q["layers"]["input_norm"], qz.QuantWeight)


class IdsTokenizer:
    """Space-separated ids in, ids out (the JAX tests' causal tokenizer)."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [int(t) for t in text.split()]}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _engine_results(model, engine, texts):
    ids, mask = model.tokenize_for_engine(texts)
    engine.admit_batch_tokens(list(range(len(texts))), ids, mask)
    got = {}
    for _ in range(32):
        if not engine.has_active():
            break
        engine.run_chunk()
        for slot in engine.finished_slots():
            got[slot] = model.decode_candidates(*engine.finalize(slot))
    return got


@pytest.mark.parametrize("family", ["t5", "causal"])
@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_engine_matches_quantized_classic(family, quantize):
    """The engine quantizes the raw weights itself; quantization is
    deterministic, so its weights equal the classic model's and so must its
    beams (lazy-append continuous batching changes nothing)."""
    if family == "t5":
        from reprover_tpu_torch.generation.generator import TacticGeneratorModel
        from reprover_tpu_torch.models.t5 import T5Config, init_params

        cfg = T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_heads=4,
                       num_encoder_layers=2, num_decoder_layers=2)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        texts = ["31415", "2718281"]
        classic_model = TacticGeneratorModel(
            qz.quantize_t5_params(params, bits=qz.resolve_quantize_bits(quantize)), cfg,
            max_inp_seq_len=64, max_oup_seq_len=8, bucket_multiple=32)
        raw = TacticGeneratorModel(params, cfg, max_inp_seq_len=64, max_oup_seq_len=8,
                                   bucket_multiple=32)
    else:
        from reprover_tpu_torch.generation.causal_generator import CausalTacticGeneratorModel
        from reprover_tpu_torch.models.causal_lm import CausalLMConfig, init_params

        cfg = CausalLMConfig(vocab_size=64, d_model=32, num_layers=2, num_heads=4,
                             num_kv_heads=2, d_ff=64)
        params = init_params(cfg, torch.Generator().manual_seed(7))
        rng = np.random.default_rng(11)
        texts = [" ".join(str(int(t)) for t in rng.integers(3, 64, n)) for n in (5, 9)]
        kw = dict(max_inp_seq_len=16, max_oup_seq_len=8, template="%s", bucket_multiple=4)
        classic_model = CausalTacticGeneratorModel(params, cfg, IdsTokenizer(), quantize=quantize,
                                                   **kw)
        raw = CausalTacticGeneratorModel(params, cfg, IdsTokenizer(), **kw)
    classic = {t: classic_model.generate([t], num_samples=4)[0] for t in texts}
    engine = raw.make_stepwise_engine(num_slots=2, num_beams=4, chunk_size=3, quantize=quantize)
    kind = qz.Quant4Weight if quantize == "int4" else qz.QuantWeight
    assert isinstance(engine.params["lm_head"], kind)
    got = _engine_results(raw, engine, texts)
    for slot, text in enumerate(texts):
        want = classic[text]
        assert [t for t, _ in got[slot]] == [t for t, _ in want]
        np.testing.assert_allclose([s for _, s in got[slot]], [s for _, s in want],
                                   rtol=1e-5, atol=1e-6)
