"""PyTorch port, search ops: beam search against the JAX package on a
scripted logits table, and the top-k ops with exact ties (lowest index
first, as ``lax.top_k``)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reprover_tpu.ops import topk as jtopk
from reprover_tpu_torch.ops import topk as ttopk

# The packages re-export the function under the module's name.
jbs = importlib.import_module("reprover_tpu.generation.beam_search")
tbs = importlib.import_module("reprover_tpu_torch.generation.beam_search")

EOS, PAD, START = 1, 0, 0
R = 97  # hashed history states of the scripted model


def _table(T, V, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(scale=2.0, size=(T, R, V)).astype(np.float32)
    table[:, :, EOS] += 1.5  # finished hypotheses early and often
    return table


def _jax_search(table, B, K, T, lp):
    tab = jnp.asarray(table)

    def step_fn(cache, tok):
        h = (cache["h"] * 31 + tok) % R
        return tab[cache["step"], h], {"step": cache["step"] + 1, "h": h}

    def reorder_fn(cache, parent):
        return {"step": cache["step"], "h": cache["h"][parent]}

    cache = {"step": jnp.int32(0), "h": jnp.repeat(jnp.arange(B, dtype=jnp.int32), K)}
    res = jbs.beam_search(step_fn, reorder_fn, cache, B, K, T, EOS, PAD, START,
                          length_penalty=lp)
    return np.asarray(res.sequences), np.asarray(res.scores), np.asarray(res.lengths)


def _torch_search(table, B, K, T, lp):
    tab = torch.from_numpy(table)

    def step_fn(cache, tok):
        h = (cache["h"] * 31 + tok) % R
        return tab[cache["step"], h], {"step": cache["step"] + 1, "h": h}

    def reorder_fn(cache, parent):
        return {"step": cache["step"], "h": cache["h"][parent]}

    cache = {"step": 0, "h": torch.arange(B).repeat_interleave(K)}
    res = tbs.beam_search(step_fn, reorder_fn, cache, B, K, T, EOS, PAD, START,
                          length_penalty=lp)
    return res.sequences.numpy(), res.scores.numpy(), res.lengths.numpy()


@pytest.mark.parametrize(
    "B, K, T, V, lp, seed",
    [
        (2, 4, 10, 20, 0.0, 0),
        (3, 3, 12, 20, 1.0, 1),
        (1, 8, 16, 24, 0.5, 2),
        (2, 4, 9, 6, 0.0, 3),  # 2K > V: per-beam top-min(2K, V)
    ],
)
def test_beam_search_matches_jax(B, K, T, V, lp, seed):
    table = _table(T, V, seed)
    js, jsc, jl = _jax_search(table, B, K, T, lp)
    ts, tsc, tl = _torch_search(table, B, K, T, lp)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tsc, jsc, atol=1e-5, rtol=1e-5)


def _tied(shape, seed, levels=4):
    """Values on a coarse grid: many exact ties."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, levels, size=shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("k2", [4, 8, 20])
def test_topk_candidates_ties(k2):
    cand = _tied((3, 4, 7), seed=k2)
    js, jp, jt = (np.asarray(x) for x in jbs.topk_candidates(jnp.asarray(cand), k2))
    ts, tp, tt = (x.numpy() for x in tbs.topk_candidates(torch.from_numpy(cand), k2))
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tt, jt)


def test_masked_topk_ties():
    scores = _tied((4, 50), seed=11)
    mask = np.random.default_rng(12).random((4, 50)) > 0.3
    mask[3, 5:] = False  # fewer accessible than k: trailing -inf
    jv, ji = jtopk.masked_topk(jnp.asarray(scores), jnp.asarray(mask), 10)
    tv, ti = ttopk.masked_topk(torch.from_numpy(scores), torch.from_numpy(mask), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.isneginf(tv.numpy()[3, 5:]).all()


def test_cosine_topk_duplicate_embeddings():
    """Duplicated premise rows give bitwise-equal similarities (grid-valued
    components make every dot product exact): the lower index ranks first."""
    rng = np.random.default_rng(13)
    base = (rng.integers(-2, 3, size=(12, 16)) * 0.25).astype(np.float32)
    premises = np.concatenate([base, base[::-1], base[:5]])  # 29 rows, many duplicates
    ctx = (rng.integers(-2, 3, size=(3, 16)) * 0.25).astype(np.float32)
    mask = np.ones((3, len(premises)), bool)
    mask[1, ::3] = False
    jv, ji = jtopk.cosine_topk(jnp.asarray(ctx), jnp.asarray(premises), jnp.asarray(mask), 12)
    tv, ti = ttopk.cosine_topk(torch.from_numpy(ctx), torch.from_numpy(premises),
                               torch.from_numpy(mask), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
