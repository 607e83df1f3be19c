"""PyTorch port, grouped (diverse) beam search against the JAX package's
``beam_search(..., num_beam_groups, diversity_penalty)`` on the CPU, fp32:
through a seeded logits table indexed by (position, last token) whose
values are rounded to 0.1 (so candidates tie), and through the tiny T5's
``decode_step`` in both packages on the same weights. Sequences and lengths
equal, scores within 1e-5. Also: an indivisible group count raises, a group
that finishes steps before the others stays frozen, and one group is the
classic search."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.models import t5 as jt5
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import params_from_jax
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

# The packages re-export the function under the module's name.
jbs = importlib.import_module("reprover_tpu.generation.beam_search")
tbs = importlib.import_module("reprover_tpu_torch.generation.beam_search")

EOS, PAD, START = 1, 0, 0
B, V = 2, 24
TOL = 1e-5
# (num_beams, num_beam_groups, diversity_penalty, max_length, length_penalty):
# the JAX package's diverse cases (tests/test_beam_search.py), then one beam
# a group and groups without a penalty.
CASES = [(4, 2, 1.0, 10, 0.0), (8, 4, 1.0, 16, 0.0), (4, 4, 0.5, 12, 1.0), (8, 2, 2.0, 16, 0.0),
         (8, 8, 1.0, 12, 0.0), (8, 4, 0.0, 12, 0.0)]
TINY = dict(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
            num_decoder_layers=2)


def _table(T, seed):
    """Logits ``[T, V, V]`` by (position, last token), rounded to 0.1."""
    rng = np.random.default_rng(seed)
    table = np.round(rng.normal(scale=2.0, size=(T, V, V)), 1).astype(np.float32)
    table[:, :, EOS] += 1.5  # finished hypotheses early and often
    return table


def _jax_table_search(table, K, T, lp, groups=None):
    tab = jnp.asarray(table)

    def step_fn(cache, tok):
        return tab[cache["step"], tok], {"step": cache["step"] + 1}

    kw = {} if groups is None else dict(num_beam_groups=groups[0], diversity_penalty=groups[1])
    res = jbs.beam_search(step_fn, lambda c, p: c, {"step": jnp.int32(0)}, B, K, T, EOS, PAD,
                          START, length_penalty=lp, **kw)
    return np.asarray(res.sequences), np.asarray(res.scores), np.asarray(res.lengths)


def _torch_table_search(table, K, T, lp, groups=None, seen=None, row_bias=None):
    """The port's search over ``table``; ``seen`` collects each step's fed
    tokens, ``row_bias`` ``[B*K, V]`` is added to each fixed beam row."""
    tab = torch.from_numpy(table)

    def step_fn(cache, tok):
        if seen is not None:
            seen.append(tok.clone())
        logits = tab[cache["step"], tok]
        return (logits if row_bias is None else logits + row_bias), {"step": cache["step"] + 1}

    kw = {} if groups is None else dict(num_beam_groups=groups[0], diversity_penalty=groups[1])
    res = tbs.beam_search(step_fn, lambda c, p: c, {"step": 0}, B, K, T, EOS, PAD, START,
                          length_penalty=lp, **kw)
    return res.sequences.numpy(), res.scores.numpy(), res.lengths.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("K, G, penalty, T, lp", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_table_search_matches_jax(K, G, penalty, T, lp, seed):
    table = _table(T, seed)
    _assert_same(_torch_table_search(table, K, T, lp, (G, penalty)),
                 _jax_table_search(table, K, T, lp, (G, penalty)))


@pytest.fixture(scope="module")
def t5_weights():
    jcfg = jt5.T5Config(**TINY)
    tcfg = tt5.T5Config(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tt5.T5Config)
                           if f.name != "compute_dtype"})
    jp = jt5.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _sources():
    rng = np.random.default_rng(9)
    ids = rng.integers(3, 259, (B, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 25:] = 0
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("K, G, penalty, T, lp", CASES)
def test_t5_decode_search_matches_jax(t5_weights, K, G, penalty, T, lp):
    """The tiny T5's incremental decoder as ``step_fn`` in both packages."""
    jcfg, tcfg, jp, tp = t5_weights
    ids, mask = _sources()
    enc = jnp.repeat(jt5.encode(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask)), K, axis=0)
    jcache = jt5.init_decode_state(jp, jcfg, enc, jnp.repeat(jnp.asarray(mask), K, axis=0), T)

    def jax_reorder(cache, parent):
        return dataclasses.replace(cache, self_k=jnp.take(cache.self_k, parent, axis=1),
                                   self_v=jnp.take(cache.self_v, parent, axis=1))

    want = jbs.beam_search(lambda c, t: jt5.decode_step(jp, jcfg, c, t), jax_reorder, jcache, B,
                           K, T, jcfg.eos_token_id, jcfg.pad_token_id,
                           jcfg.decoder_start_token_id, length_penalty=lp, num_beam_groups=G,
                           diversity_penalty=penalty)
    tmask = torch.from_numpy(mask)
    with torch.inference_mode():
        tcache = tt5.init_decode_state(tp, tcfg, tt5.encode(tp, tcfg, torch.from_numpy(ids), tmask),
                                       tmask, T, num_beams=K)
        got = tbs.beam_search(lambda c, t: tt5.decode_step(tp, tcfg, c, t),
                              tt5.reorder_decode_state, tcache, B, K, T, tcfg.eos_token_id,
                              tcfg.pad_token_id, tcfg.decoder_start_token_id, length_penalty=lp,
                              num_beam_groups=G, diversity_penalty=penalty)
    _assert_same([x.numpy() for x in (got.sequences, got.scores, got.lengths)],
                 [np.asarray(x) for x in (want.sequences, want.scores, want.lengths)])


def test_indivisible_groups_raise():
    with pytest.raises(ValueError, match="divisible by num_beam_groups"):
        tbs.beam_search(lambda c, t: (torch.zeros(t.shape[0], V), c), lambda c, p: c, None, 1, 4,
                        5, EOS, PAD, START, num_beam_groups=3)


def test_early_group_stays_frozen_and_matches_jax():
    """Group 0's beam rows see a large EOS logit, the others a small one: it
    finishes steps before them, its fed tokens stop changing from then on
    while the other groups' go on, and the result equals the JAX package's
    on the same logits."""
    K, G, T = 6, 3, 12
    table = _table(T, 4)
    bias = np.zeros((B * K, V), np.float32)
    rows = np.arange(B * K) % K < K // G
    bias[rows, EOS] = 8.0
    bias[~rows, EOS] = -8.0
    biased = table[:, :, None, :] + bias[None, None]  # [T, V, B*K, V]: a row's own logits
    seen: list = []
    got = _torch_table_search(table, K, T, 0.0, (G, 1.0), seen=seen,
                              row_bias=torch.from_numpy(bias))

    jtab = jnp.asarray(biased)

    def step_fn(cache, tok):
        return jtab[cache["step"], tok, jnp.arange(B * K)], {"step": cache["step"] + 1}

    res = jbs.beam_search(step_fn, lambda c, p: c, {"step": jnp.int32(0)}, B, K, T, EOS, PAD,
                          START, num_beam_groups=G, diversity_penalty=1.0)
    _assert_same(got, [np.asarray(x) for x in (res.sequences, res.scores, res.lengths)])

    fed = torch.stack(seen).view(len(seen), B, G, K // G)
    first = fed[:, :, 0]  # group 0's rows
    frozen_from = next(s for s in range(1, len(seen)) if torch.equal(first[s:], first[s:s + 1]
                                                                      .expand_as(first[s:])))
    assert frozen_from <= 3 < len(seen) - 2, (frozen_from, len(seen))
    later = fed[frozen_from:, :, 1:]
    assert not torch.equal(later[-1], later[0]), "the other groups stopped with group 0"
    assert got[2].min() <= frozen_from + 2 < got[2].max()


@pytest.mark.parametrize("K, T, lp", [(4, 10, 0.0), (8, 16, 1.0)])
def test_one_group_is_the_classic_search(K, T, lp):
    """``num_beam_groups=1`` (any penalty) is the call without group
    arguments, bit for bit, and both equal the JAX package's classic call."""
    table = _table(T, 7)
    classic = _torch_table_search(table, K, T, lp)
    for penalty in (0.0, 1.0):
        one = _torch_table_search(table, K, T, lp, (1, penalty))
        for a, b in zip(one, classic):
            np.testing.assert_array_equal(a, b)
    _assert_same(classic, _jax_table_search(table, K, T, lp))
