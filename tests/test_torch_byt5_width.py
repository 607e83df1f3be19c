"""PyTorch port at full byt5-small width (d_model 1472, 6 x 64 heads, d_ff
3584, vocabulary 384), cut to one encoder and one decoder layer: the
incremental ``decode_step`` logits and a short beam search through
``TacticGeneratorModel.generate`` against the JAX package on the same
weights, fp32 on the CPU. Tolerance: logits within 1e-4 of max|ref| per
step; beam texts equal and scores within 1e-4 (relative)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.generation.generator import TacticGeneratorModel as JaxGenerator
from reprover_tpu.models import t5 as jt5
from reprover_tpu_torch.generation import TacticGeneratorModel
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

JCFG = jt5.T5Config(num_encoder_layers=1, num_decoder_layers=1)  # byt5-small widths
TCFG = tt5.T5Config(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(tt5.T5Config)
                       if f.name != "compute_dtype"})


@pytest.fixture(scope="module")
def weights():
    jp = jt5.fuse_mlp_params(jt5.init_params(jax.random.PRNGKey(11), JCFG))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_widths_are_byt5_small():
    small = tt5.byt5_small()
    assert (TCFG.d_model, TCFG.d_ff, TCFG.num_heads, TCFG.d_kv, TCFG.vocab_size) == (
        small.d_model, small.d_ff, small.num_heads, small.d_kv, small.vocab_size)


def test_decode_steps_match_jax(weights):
    jp, tp = weights
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 259, (2, 48)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 30:] = 0
    ids[mask == 0] = 0
    enc_j = jt5.encode(jp, JCFG, jnp.asarray(ids), jnp.asarray(mask))
    enc_t = tt5.encode(tp, TCFG, torch.from_numpy(ids), torch.from_numpy(mask))
    sj = jt5.init_decode_state(jp, JCFG, enc_j, jnp.asarray(mask), 8)
    st = tt5.init_decode_state(tp, TCFG, enc_t, torch.from_numpy(mask), 8)
    tokens = rng.integers(3, 259, (6, 2)).astype(np.int32)
    tokens[0] = JCFG.decoder_start_token_id
    for step in range(6):
        lj, sj = jt5.decode_step(jp, JCFG, sj, jnp.asarray(tokens[step]))
        lt, st = tt5.decode_step(tp, TCFG, st, torch.from_numpy(tokens[step]).long())
        want = np.asarray(lj)
        np.testing.assert_allclose(lt.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_beam_search_matches_jax(weights):
    jp, tp = weights
    states = ["n : ℕ\n⊢ n + 0 = n", "a b : ℕ\n⊢ a * b = b * a"]
    want = JaxGenerator(jp, JCFG, max_inp_seq_len=64, max_oup_seq_len=10).generate(states, 4)
    got = TacticGeneratorModel(tp, TCFG, max_inp_seq_len=64, max_oup_seq_len=10).generate(states, 4)
    assert [[t for t, _ in row] for row in got] == [[t for t, _ in row] for row in want]
    np.testing.assert_allclose([s for row in got for _, s in row],
                               [s for row in want for _, s in row], rtol=1e-4, atol=0)
