"""PyTorch port: the decoder-only (LLaMA-family) serving half
(``models/causal_lm.py``, ``models/hf_import_causal.py``,
``generation/causal_generator.py``, ``generation/causal_engine.py``,
``native/bpe.py``, ``generation/bpe_tokenizer.py``) against the JAX package.

Same numpy weights (JAX init, carried over by the bridge) and inputs at tiny
width with grouped-query attention, fp32: logits within atol 1e-4 (the same
products summed in another order), beams with the same tokens and scores
within rtol 1e-5. The causal engine must reproduce the classic path."""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from reprover_tpu.models import causal_lm as jcl
from reprover_tpu_torch.data import Pos
from reprover_tpu_torch.generation.causal_generator import CausalTacticGeneratorModel
from reprover_tpu_torch.models import causal_lm as tcl
from reprover_tpu_torch.models.bridge import causal_params_from_jax
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

JCFG = jcl.CausalLMConfig(vocab_size=64, d_model=32, num_layers=2, num_heads=4, num_kv_heads=2,
                          d_ff=64)
CFG = tcl.CausalLMConfig(vocab_size=64, d_model=32, num_layers=2, num_heads=4, num_kv_heads=2,
                         d_ff=64)
K, PMAX, TDEC = 4, 16, 8


class IdsTokenizer:
    """Maps space-separated ints <-> token ids (no real vocabulary needed)."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [int(t) for t in text.split()]}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def setup():
    jparams = jcl.init_params(jax.random.PRNGKey(7), JCFG)
    params = causal_params_from_jax(jax.tree.map(np.asarray, jparams))
    model = CausalTacticGeneratorModel(params, CFG, IdsTokenizer(), max_inp_seq_len=PMAX,
                                       max_oup_seq_len=TDEC, template="%s", bucket_multiple=4)
    rng = np.random.default_rng(11)
    texts = [" ".join(str(int(t)) for t in rng.integers(3, 64, n)) for n in (5, 9, 3, 7)]
    classic = {t: model.generate([t], num_samples=K)[0] for t in texts}
    return jparams, params, model, texts, classic


def _assert_same(got, want):
    assert [t for t, _ in got] == [t for t, _ in want], (got, want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5, atol=1e-6)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 64, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, :4] = 0  # left padding
    mask[2, :7] = 0
    return ids, mask


def test_forward_logits_match_jax(setup):
    jparams, params, _, _, _ = setup
    ids, mask = _batch(0)
    want = np.asarray(jcl.forward_logits(jparams, JCFG, jnp.asarray(ids), jnp.asarray(mask)))
    got = tcl.forward_logits(params, CFG, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-4, rtol=1e-4)


def test_prefill_and_decode_step_match_jax(setup):
    """prefill's next-token logits, then three decode steps with the cache
    written in place, against the JAX functions on the same tokens."""
    jparams, params, _, _, _ = setup
    ids, mask = _batch(1)
    jlog, jstate = jcl.prefill(jparams, JCFG, jnp.asarray(ids), jnp.asarray(mask), 3)
    log, state = tcl.prefill(params, CFG, torch.from_numpy(ids), torch.from_numpy(mask), 3)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(state.k[:, :, :, :10].numpy(), np.asarray(jstate.k)[:, :, :, :10],
                               atol=1e-5)
    tokens = np.array([[5, 6, 7], [8, 9, 10], [11, 12, 13]], np.int32)
    for t in range(3):
        jlog, jstate = jcl.decode_step(jparams, JCFG, jstate, jnp.asarray(tokens[:, t]))
        log, state = tcl.decode_step(params, CFG, state, torch.from_numpy(tokens[:, t]))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(state.position.numpy(), np.asarray(jstate.position))


def test_classic_generate_matches_jax(setup):
    """The port's classic causal beam search against the JAX generator's on
    the same weights: same beams, scores within rtol 1e-5."""
    from reprover_tpu.generation.causal_generator import (
        CausalTacticGeneratorModel as JaxCausal,
    )

    jparams, _, model, texts, classic = setup
    theirs = JaxCausal(jparams, JCFG, IdsTokenizer(), max_inp_seq_len=PMAX,
                       max_oup_seq_len=TDEC, template="%s", bucket_multiple=4)
    for text in texts[:2]:
        _assert_same(classic[text], theirs.generate([text], num_samples=K)[0])


def test_training_half_raises(setup, monkeypatch):
    """The training half is ported (its parity is tests/test_torch_causal_training.py):
    the fused forward and the loss run on the CPU, and a CUDA request where
    there is no card raises instead of falling back to the CPU."""
    from reprover_tpu_torch.benchmarks import causal_finetune_step as cfs

    _, params, _, _, _ = setup
    ids, mask = (torch.from_numpy(x) for x in _batch(2))
    flash = tcl.CausalLMConfig(**{**CFG.__dict__, "flash_attention": True})
    assert torch.isfinite(tcl.causal_lm_loss(params, flash, ids, mask, ids)).item()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cfs.main(["--device", "cuda", "--batch", "1", "--seq", "128", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        cfs.setup("jax", True, "cuda", 1, 1, 128, False, 0, 1e-4)


def _collect(engine, model):
    out = {}
    for _ in range(64):
        if not engine.has_active():
            break
        engine.run_chunk()
        for slot in engine.finished_slots():
            out[slot] = model.decode_candidates(*engine.finalize(slot))
    return out


def _admit_wave(engine, model, slots, texts):
    b = 1
    while b < len(slots):
        b *= 2
    ids, mask = model.tokenize_for_engine(texts + ["1"] * (b - len(texts)))
    engine.admit_batch_tokens(slots + [-1] * (b - len(slots)), ids, mask)


@pytest.mark.parametrize("reorder_mode", ["einsum", "gather"])
def test_causal_engine_matches_classic(setup, reorder_mode):
    """Aligned admissions, then a staggered admission and slot reuse."""
    _, _, model, texts, classic = setup
    engine = model.make_stepwise_engine(num_slots=2, num_beams=K, chunk_size=3,
                                        reorder_mode=reorder_mode)
    _admit_wave(engine, model, [0, 1], texts[:2])
    results = _collect(engine, model)
    _assert_same(results[0], classic[texts[0]])
    _assert_same(results[1], classic[texts[1]])
    engine = model.make_stepwise_engine(num_slots=2, num_beams=K, chunk_size=2,
                                        reorder_mode=reorder_mode)
    _admit_wave(engine, model, [0], [texts[0]])
    engine.run_chunk()  # slot 0 is mid-decode when slot 1 joins
    _admit_wave(engine, model, [1], [texts[1]])
    first = _collect(engine, model)
    _assert_same(first[0], classic[texts[0]])
    _assert_same(first[1], classic[texts[1]])
    _admit_wave(engine, model, [0], [texts[2]])
    _assert_same(_collect(engine, model)[0], classic[texts[2]])


def test_bucketed_causal_engine_exact_parity(setup):
    _, _, model, texts, classic = setup
    engine = model.make_stepwise_engine(num_slots=2, num_beams=K, chunk_size=2,
                                        step_buckets=(4, TDEC + 1), reorder_mode="gather")
    _admit_wave(engine, model, [0], [texts[0]])
    engine.run_chunk()
    _admit_wave(engine, model, [1], [texts[1]])
    results = _collect(engine, model)
    _assert_same(results[0], classic[texts[0]])
    _assert_same(results[1], classic[texts[1]])


def test_streaming_service_serves_causal_model(setup):
    """The model-agnostic streaming service serves the decoder-only
    generator: oversubscribed concurrent requests all match classic."""
    from reprover_tpu_torch.prover.service import StreamingInferenceService

    _, _, model, texts, classic = setup
    svc = StreamingInferenceService(model, num_slots=2, num_beams=K, chunk_size=2,
                                    pipeline_depth=3, reorder_mode="gather")
    svc.start()
    try:
        clients = [svc.client() for _ in range(8)]

        async def one(c, text, delay):
            await asyncio.sleep(delay)
            return await c.agenerate(text, "a.lean", "t", Pos(1, 1), K)

        async def go():
            return await asyncio.gather(*(one(clients[4 * w + i], texts[i], 0.02 * (4 * w + i))
                                          for w in range(2) for i in range(4)))

        results = asyncio.run(go())
    finally:
        svc.stop()
    for w in range(2):
        for i in range(4):
            _assert_same(results[4 * w + i], classic[texts[i]])
    snap = svc.stats_snapshot()
    assert snap["admissions"] == 8 and snap["requests"] == 8


def test_hf_causal_checkpoint_loads_and_routes(setup, tmp_path):
    """An HF LLaMA-layout state dict (``pytorch_model.bin``) loads into the
    port's tree, ``is_causal_lm_checkpoint`` tells it from T5, and the
    generator loader picks the causal wrapper."""
    from reprover_tpu_torch.models.hf_import_causal import (
        causal_config_from_hf,
        is_causal_lm_checkpoint,
        load_hf_causal_lm,
    )

    _, params, _, _, _ = setup
    hf_cfg = {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 64,
              "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "intermediate_size": 64}
    sd = {"model.embed_tokens.weight": params["embedding"], "model.norm.weight":
          params["final_norm"], "lm_head.weight": params["lm_head"].t().contiguous()}
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
             "down": "mlp.down_proj"}
    for i in range(2):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = params["layers"]["input_norm"][i]
        sd[f"{p}.post_attention_layernorm.weight"] = params["layers"]["post_norm"][i]
        for key, name in names.items():
            sd[f"{p}.{name}.weight"] = params["layers"][key][i].t().contiguous()
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf_cfg, f)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    assert is_causal_lm_checkpoint(str(tmp_path))
    assert causal_config_from_hf(hf_cfg).num_kv_heads == 2
    loaded, cfg = load_hf_causal_lm(str(tmp_path))
    assert cfg == CFG
    for key in ("q", "k", "down", "input_norm"):
        assert torch.equal(loaded["layers"][key], params["layers"][key]), key
    assert torch.equal(loaded["lm_head"], params["lm_head"])


def test_bpe_round_trip_native_equals_python(tmp_path):
    """The trainable tactic tokenizer: the C++ core (built under build/) and
    the Python fallback train the same vocabulary and encode the same ids;
    decode(encode(text)) == text; ids past the vocabulary decode to
    nothing."""
    from reprover_tpu_torch.generation.bpe_tokenizer import TacticBpeTokenizer
    from reprover_tpu_torch.native.bpe import BpeTokenizer, native_available

    corpus = ["theorem foo (n : ℕ) : n + 0 = n := by simp", "⊢ ∀ x, x ≤ x\n  exact le_refl",
              "rw [Nat.add_comm]\tsimp at h"] * 3
    assert native_available(), "g++ could not build the native BPE core"
    native = TacticBpeTokenizer(BpeTokenizer())
    python = TacticBpeTokenizer(BpeTokenizer(force_python=True))
    for tok in (native, python):
        tok.train(corpus, vocab_size=300)
    # The same vocabulary (the two number base characters in another order)
    # and the same token strings for every text.
    assert sorted(native._bpe.vocab) == sorted(python._bpe.vocab)
    for text in corpus[:3] + ["simp [h]  at *"]:
        ids = native.encode_ids(text)
        assert native._bpe.encode(text) == python._bpe.encode(text)
        assert native.decode(ids) == text == python.decode(python.encode_ids(text))
    assert native.decode([7, 10 ** 6, -5]) == native.decode([7])
    path = str(tmp_path / "bpe.json")
    native.save(path)
    again = TacticBpeTokenizer.load(path)
    assert again.encode_ids(corpus[0]) == native.encode_ids(corpus[0])
    lib = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                       "native", "libbpe.so")
    assert os.path.exists(lib)
