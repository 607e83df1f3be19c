"""PyTorch port, tensor-parallel serving on the CPU: the mirror of
``tests/test_engine_tp.py``. Four spawned gloo ranks (one rendezvous file
under ``tmp_path``, torch capped at one thread each) run the T5 and causal
(GQA) streaming engines sharded over the mesh's ``model`` axis at ``(data,
model)`` = (1, 2), (2, 2) and (1, 4): the grid's first rank drives the host
API and the others follow its calls. Every case is held against the port's
one-process classic beam search on the same weights (token-exact, scores
within 1e-5 in fp32) and, for two meshes, against the JAX package's own
tensor-parallel engine on eight virtual devices with the same numpy
weights: wave and staggered admission with slot reuse, length buckets, the
scan, einsum and gather reorders, int8 and int4 weights, the streaming
service end to end, and every rank's finished beams identical. Without
ranks: indivisible heads raise, and a shard of a LLaMA-7B weight routes as
the whole weight does on one card.

The spawned ranks import this module, so JAX is imported inside the tests
only."""

import asyncio
import os
import re

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from reprover_tpu_torch.data import Pos
from reprover_tpu_torch.generation.causal_generator import CausalTacticGeneratorModel
from reprover_tpu_torch.generation.engine import StepwiseBeamEngine
from reprover_tpu_torch.generation.generator import TacticGeneratorModel
from reprover_tpu_torch.models import causal_lm as tcl
from reprover_tpu_torch.models import t5 as tt5
from reprover_tpu_torch.models.bridge import causal_params_from_jax, params_from_jax
from reprover_tpu_torch.models.quantize import (
    Quant4Weight,
    quantize_causal_params,
    quantize_t5_params,
)
from reprover_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

# num_heads, d_ff and the vocabulary divide 4; 8 KV heads give 2 a rank at
# model 4 (GQA groups of 2 stay whole on a rank).
T5 = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_heads=8, num_encoder_layers=2,
          num_decoder_layers=2)
CAUSAL = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=16, num_kv_heads=8, d_ff=64)
K, SMAX, PMAX, TDEC = 4, 32, 16, 10
RANKS = 4
RTOL = 1e-5  # scores, fp32

# (family, data, model, scenario, engine options): each runs on the 4 ranks.
CASES = [
    ("t5", 1, 2, "wave", {}),
    ("t5", 2, 2, "wave", {}),
    ("t5", 1, 4, "wave", {}),
    ("causal", 1, 2, "wave", {}),
    ("causal", 2, 2, "wave", {}),
    ("causal", 1, 4, "wave", {}),
    ("t5", 1, 4, "staggered", {}),
    ("causal", 2, 2, "staggered", {}),
    ("t5", 1, 2, "buckets", dict(step_buckets=(4, TDEC))),
    ("t5", 1, 2, "wave", dict(reorder_mode="scan")),
    ("causal", 1, 2, "wave", dict(reorder_mode="scan")),
    ("t5", 2, 2, "wave", dict(reorder_mode="gather")),
    ("causal", 1, 4, "wave", dict(reorder_mode="gather")),
    ("t5", 1, 4, "wave", dict(quantize="int8")),
    ("causal", 1, 2, "wave", dict(quantize="int8")),
    ("t5", 1, 2, "wave", dict(quantize="int4")),
    ("causal", 1, 4, "wave", dict(quantize="int4", reorder_mode="gather")),
    ("t5", 1, 4, "fault", {}),
    ("t5", 1, 2, "service", {}),
]


def _key(case):
    family, data, model, scenario, opts = case
    return f"{family}-{data}x{model}-{scenario}-" + ",".join(f"{k}={v}" for k, v in
                                                             sorted(opts.items()))


class IdsTokenizer:
    """Space-separated ints <-> token ids."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [int(t) for t in text.split()]}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _texts(family):
    if family == "t5":  # digits: byte ids 51..60 lie inside the vocabulary
        rng = np.random.default_rng(3)
        return ["".join(chr(48 + rng.integers(0, 10)) for _ in range(n)) for n in (9, 14, 6)]
    rng = np.random.default_rng(11)
    return [" ".join(str(int(t)) for t in rng.integers(3, 64, n)) for n in (5, 9, 3)]


def _model(family, params_np, quantize=False):
    """The port's generator on the numpy weights (the T5 MLP fused, as the
    serving loaders store it); ``quantize`` quantizes them first (the
    classic reference of a quantized engine)."""
    bits = {"int8": 8, "int4": 4}.get(quantize)
    if family == "t5":
        params = tt5.fuse_mlp_params(params_from_jax(params_np))
        if bits:
            params = quantize_t5_params(params, bits=bits)
        return TacticGeneratorModel(params, tt5.T5Config(**T5), max_inp_seq_len=SMAX,
                                    max_oup_seq_len=TDEC, bucket_multiple=SMAX)
    params = causal_params_from_jax(params_np)
    if bits:
        params = quantize_causal_params(params, bits=bits)
    return CausalTacticGeneratorModel(params, tcl.CausalLMConfig(**CAUSAL), IdsTokenizer(),
                                      max_inp_seq_len=PMAX, max_oup_seq_len=TDEC,
                                      template="%s", bucket_multiple=4)


def _admit(engine, model, family, slots, texts):
    if family == "t5":
        ids, mask = model.tokenize_for_engine(texts)
        engine.admit_batch_tokens(slots, ids, mask)
        return
    b = 1
    while b < len(slots):
        b *= 2
    ids, mask = model.tokenize_for_engine(texts + ["1"] * (b - len(texts)))
    engine.admit_batch_tokens(slots + [-1] * (b - len(slots)), ids, mask)


def _collect(engine, model):
    out = {}
    for _ in range(64):
        if not engine.has_active():
            break
        engine.run_chunk()
        for slot in engine.finished_slots():
            out[slot] = model.decode_candidates(*engine.finalize(slot))
    return out


def _inject_fault(engine, mesh, raised):
    """Rank 2 fails its first admission after the encoder, its collectives
    done (as an out-of-memory error there would); every rank records what
    its admission raised."""
    if mesh.coord("model") == 2:
        install = engine._install

        def failing(*args):
            engine._install = install
            raise RuntimeError("injected fault")

        engine._install = failing
    admit = engine.admit_batch_tokens

    def recording(*args, **kwargs):
        try:
            return admit(*args, **kwargs)
        except RuntimeError as ex:
            raised.append(str(ex))
            raise

    engine.admit_batch_tokens = recording


def _lead(engine, model, family, scenario, texts):
    """The first rank's host calls -> {label: [(text, score)]}."""
    if scenario == "fault":  # the failed wave raises, a reset, then the wave
        try:
            _admit(engine, model, family, [0, 1], texts[:2])
        except RuntimeError:
            engine.reset()
        scenario = "wave"
    if scenario == "wave":
        _admit(engine, model, family, [0, 1], texts[:2])
        got = _collect(engine, model)
        return {texts[0]: got[0], texts[1]: got[1]}
    _admit(engine, model, family, [0], [texts[0]])
    engine.run_chunk()  # slot 0 is mid-decode when slot 1 joins
    _admit(engine, model, family, [1], [texts[1]])
    got = _collect(engine, model)
    out = {texts[0]: got[0], texts[1]: got[1]}
    if scenario == "staggered":
        assert set(engine.free_slots()) == {0, 1}
        _admit(engine, model, family, [0], [texts[2]])
        out[texts[2]] = _collect(engine, model)[0]
    return out


def _serve(model, mesh, texts):
    """``serve_tensor_parallel`` end to end: the leader serves two requests
    through the streaming service; the others follow until it stops ->
    (the leader's responses, every rank's engine)."""
    from reprover_tpu_torch.prover.service import serve_tensor_parallel

    svc = serve_tensor_parallel(model, mesh, num_slots=2, num_beams=K, chunk_size=3)
    if not mesh.is_leader:
        return None, svc.engine
    svc.start()
    try:
        client = svc.client()
        return {t: asyncio.run(client.agenerate(t, "f.lean", "t", Pos(1, 1), K))
                for t in texts[:2]}, svc.engine
    finally:
        svc.stop()


def _beams(engine):
    st = engine.state
    return {f: getattr(st, f).clone() for f in ("fin_tokens", "fin_scores", "tokens",
                                                "beam_scores", "n", "done")}


def _worker(rank, init_file, work):
    cap_cpu_threads()
    init_distributed("cpu", init_method=f"file://{init_file}", rank=rank, world_size=RANKS)
    weights = torch.load(os.path.join(work, "weights.pt"), weights_only=False)
    out, meshes = {}, {}
    for data, model_size in sorted({(c[1], c[2]) for c in CASES}):
        try:  # every rank forms every mesh's groups, once
            meshes[(data, model_size)] = make_mesh(data=data, model=model_size)
        except ValueError:  # this rank is outside a smaller grid
            pass
    for case in CASES:
        family, data, model_size, scenario, opts = case
        mesh = meshes.get((data, model_size))
        if mesh is None:
            continue
        model = _model(family, weights[family])
        texts = _texts(family)
        if scenario == "service":
            results, engine = _serve(model, mesh, texts)
            out[_key(case)] = dict(results=results, beams=_beams(engine))
            continue
        engine = model.make_stepwise_engine(num_slots=2, num_beams=K,
                                            chunk_size=3 if scenario in ("wave", "fault")
                                            else 2, mesh=mesh, **opts)
        results, raised = None, []
        if scenario == "fault":
            _inject_fault(engine, mesh, raised)
        if mesh.is_leader:
            try:
                results = _lead(engine, model, family, scenario, texts)
            finally:
                engine.release_followers()
        else:
            engine.follow()
        cache = engine.state.self_k if family == "t5" else engine.state.dec_k
        lm_head = engine.params["lm_head"]
        out[_key(case)] = dict(
            results=results, cache_heads=cache.shape[3], raised=raised,
            lm_head=(type(lm_head).__name__, tuple(lm_head.shape)), beams=_beams(engine))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


def _jax_weights():
    import jax

    from reprover_tpu.models import causal_lm as jcl
    from reprover_tpu.models import t5 as jt5

    return {"t5": jax.tree.map(np.asarray, jt5.init_params(jax.random.PRNGKey(5),
                                                           jt5.T5Config(**T5))),
            "causal": jax.tree.map(np.asarray, jcl.init_params(jax.random.PRNGKey(7),
                                                               jcl.CausalLMConfig(**CAUSAL)))}


def _jax_tp(family, weights, data, model_size):
    """The JAX package's tensor-parallel engine (``make_mesh(data,
    model)``) on a wave of the first two texts."""
    import jax
    import jax.numpy as jnp

    from reprover_tpu.parallel import make_mesh as jax_make_mesh

    texts = _texts(family)
    params = jax.tree.map(jnp.asarray, weights[family])
    if family == "t5":
        from reprover_tpu.generation.generator import TacticGeneratorModel as JaxT5
        from reprover_tpu.models.t5 import T5Config as JaxT5Config

        model = JaxT5(params, JaxT5Config(**T5), max_inp_seq_len=SMAX, max_oup_seq_len=TDEC,
                      bucket_multiple=SMAX)
    else:
        from reprover_tpu.generation.causal_generator import CausalTacticGeneratorModel as JaxC
        from reprover_tpu.models.causal_lm import CausalLMConfig as JaxCConfig

        model = JaxC(params, JaxCConfig(**CAUSAL), IdsTokenizer(), max_inp_seq_len=PMAX,
                     max_oup_seq_len=TDEC, template="%s", bucket_multiple=4)
    mesh = jax_make_mesh(data=data, model=model_size, devices=jax.devices()[:data * model_size])
    engine = model.make_stepwise_engine(num_slots=2, num_beams=K, chunk_size=3, mesh=mesh)
    _admit(engine, model, family, [0, 1], texts[:2])
    got = _collect(engine, model)
    return {texts[0]: got[0], texts[1]: got[1]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the ranks once and, while they run, take the references ->
    (each rank's outputs, {(family, quantize): {text: classic beams}},
    {(family, data, model): JAX tensor-parallel beams})."""
    work = str(tmp_path_factory.mktemp("tp_engine"))
    weights = _jax_weights()
    torch.save(weights, os.path.join(work, "weights.pt"))
    spawned = mp.spawn(_worker, args=(os.path.join(work, "rendezvous"), work), nprocs=RANKS,
                       join=False)
    classic = {}
    for family in ("t5", "causal"):
        for quantize in (False, "int8", "int4"):
            model = _model(family, weights[family], quantize)
            kwargs = dict(max_length=TDEC) if family == "t5" else {}
            classic[(family, quantize)] = {t: model.generate([t], num_samples=K, **kwargs)[0]
                                           for t in _texts(family)}
    jax_tp = {("t5", 1, 4): _jax_tp("t5", weights, 1, 4),
              ("causal", 2, 2): _jax_tp("causal", weights, 2, 2)}
    while not spawned.join():
        pass
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(RANKS)]
    return outs, classic, jax_tp


def _assert_same(got, want, what):
    assert [t for t, _ in got] == [t for t, _ in want], (what, got, want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=RTOL, atol=RTOL,
                               err_msg=what)


@pytest.mark.parametrize("case", [c for c in CASES if c[3] != "service"], ids=_key)
def test_tp_engine_matches_classic(ranks, case):
    """The leader's beams equal the one-process classic path's on the same
    (quantized) weights; the caches hold the local heads; a quantized
    ``lm_head`` stays quantized and split over the vocabulary."""
    outs, classic, _ = ranks
    family, data, model_size, scenario, opts = case
    key = _key(case)
    got = outs[0][key]
    want = classic[(family, opts.get("quantize", False))]
    assert got["results"] is not None and len(got["results"]) == (3 if scenario == "staggered"
                                                                  else 2)
    for text, beams in got["results"].items():
        _assert_same(beams, want[text], f"{key} {text!r}")
    heads = T5["num_heads"] if family == "t5" else CAUSAL["num_kv_heads"]
    assert got["cache_heads"] == heads // model_size
    kind, shape = got["lm_head"]
    assert kind == {"int8": "QuantWeight", "int4": "Quant4Weight"}.get(opts.get("quantize"),
                                                                      "Tensor")
    assert shape[-1] == 64 // model_size


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_tp_ranks_finish_identical_beams(ranks, case):
    """Every rank of the grid ends with the same beam bookkeeping, bit for
    bit: finished and running tokens and scores, lengths and flags (the
    followers' engines as ``serve_tensor_parallel`` hands them back)."""
    outs, _, _ = ranks
    key = _key(case)
    grid = [o[key] for o in outs if key in o]
    assert len(grid) == case[1] * case[2]
    for other in grid[1:]:
        for field, t in grid[0]["beams"].items():
            assert torch.equal(t, other["beams"][field]), (key, field)


@pytest.mark.parametrize("family, data, model_size", [("t5", 1, 4), ("causal", 2, 2)])
def test_tp_engine_matches_jax_tp_engine(ranks, family, data, model_size):
    """The port's tensor-parallel engine against the JAX package's, on the
    same numpy weights and mesh shape."""
    outs, _, jax_tp = ranks
    got = outs[0][_key((family, data, model_size, "wave", {}))]["results"]
    for text, beams in jax_tp[(family, data, model_size)].items():
        _assert_same(got[text], beams, f"{family} {text!r}")


def test_tp_failed_call_raises_on_every_rank(ranks):
    """A replicated call that fails on one follower only (rank 2's
    admission, after the encoder's collectives) raises on every rank: that
    rank re-raises its own error, the others name it; nothing hangs, and
    after the leader's reset the engine serves the wave as one process."""
    outs, _, _ = ranks
    key = _key(("t5", 1, 4, "fault", {}))
    for rank, out in enumerate(outs):
        want = "injected fault" if rank == 2 else r"admit_batch_tokens raised on rank\(s\) \[2\]"
        assert len(out[key]["raised"]) == 1, (rank, out[key]["raised"])
        assert re.search(want, out[key]["raised"][0]), (rank, out[key]["raised"])


def test_tp_streaming_service_end_to_end(ranks):
    """``serve_tensor_parallel``: the leader's StreamingInferenceService
    serves two requests over a (1, 2) mesh while the other rank follows;
    the responses are the classic beams (deduplicated by text, as the
    service does)."""
    outs, classic, _ = ranks
    key = _key(("t5", 1, 2, "service", {}))
    assert outs[1][key]["results"] is None and key not in outs[2]
    for text, got in outs[0][key]["results"].items():
        want = {}
        for t, score in classic[("t5", False)][text]:
            want.setdefault(t, score)
        got = dict(got)
        assert set(got) == set(want)
        for t in got:
            np.testing.assert_allclose(got[t], want[t], rtol=RTOL, atol=RTOL)


def test_tp_rejects_indivisible_heads():
    """A ``model`` degree that does not divide the heads raises ValueError
    before anything is sharded (byt5-small's 6 heads never split over 4);
    a mesh built without process groups raises on its first collective
    need, the control group."""
    params = tt5.init_params(tt5.T5Config(**T5), torch.Generator().manual_seed(0))
    six = tt5.T5Config(**{**T5, "num_heads": 6, "d_ff": 64})
    with pytest.raises(ValueError, match="must divide num_heads=6"):
        StepwiseBeamEngine(params, six, num_slots=1, num_beams=K, max_src_len=SMAX,
                           max_decode_len=TDEC, mesh=Mesh(1, 4, (0, 0)))
    causal = tcl.init_params(tcl.CausalLMConfig(**CAUSAL), torch.Generator().manual_seed(0))
    from reprover_tpu_torch.generation.causal_engine import CausalStepwiseEngine

    with pytest.raises(ValueError, match="num_kv_heads=8"):
        CausalStepwiseEngine(causal, tcl.CausalLMConfig(**CAUSAL), num_slots=1, num_beams=K,
                             max_src_len=PMAX, max_decode_len=TDEC, mesh=Mesh(1, 16, (0, 0)))
    with pytest.raises(RuntimeError, match="no process group"):
        StepwiseBeamEngine(params, tt5.T5Config(**T5), num_slots=1, num_beams=K,
                           max_src_len=SMAX, max_decode_len=TDEC, mesh=Mesh(1, 4, (0, 0)))


# (name, K, N, column-parallel): the LLaMA-7B products.
LLAMA7B = [("q", 4096, 4096, 1), ("k", 4096, 4096, 1), ("v", 4096, 4096, 1),
           ("o", 4096, 4096, 0), ("gate", 4096, 11008, 1), ("up", 4096, 11008, 1),
           ("down", 11008, 4096, 0), ("lm_head", 4096, 32000, 1)]


@pytest.mark.parametrize("bits", [8, 4])
def test_shard_routes_as_the_whole_weight(bits):
    """At LLaMA-7B shapes, each rank's shard of every product at TP 2 and 4
    routes as the whole weight does on one card (decode M 32: every product
    to kernel 11/12; admission M 2044: all but ``down``), keeps its int4
    groups whole, and would take a tensor-core body (``quant_plan``)."""
    from reprover_tpu_torch.models.quantize import QuantWeight, _group_for, routing_report
    from reprover_tpu_torch.ops.quant_matmul import quant_plan
    from reprover_tpu_torch.parallel.sharding import causal_param_partition_specs, shard_pytree

    def weight(k, n, layers):  # routing reads shapes only: bytes left unset
        lead = (layers,) if layers else ()
        if bits == 8:
            return QuantWeight(q=torch.empty(lead + (k, n), dtype=torch.int8),
                               scale=torch.ones(lead + (1, n)))
        g = _group_for(k, 128)
        return Quant4Weight(q=torch.empty(lead + (k // 2, n), dtype=torch.uint8),
                            scale=torch.ones(lead + (k // g, n)), group=g)

    whole = {"layers": {name: weight(k, n, 1) for name, k, n, _ in LLAMA7B[:-1]},
             "lm_head": weight(4096, 32000, 0)}
    specs = causal_param_partition_specs({"embedding": None, "final_norm": None, **whole},
                                         model_parallel=True)
    specs = {"layers": {n: specs["layers"][n] for n in whole["layers"]},
             "lm_head": specs["lm_head"]}
    cuda = torch.device("cuda")
    for rows in (32, 2044):
        want = routing_report(whole, rows, torch.bfloat16, cuda)
        kernel = "quant_matmul" if bits == 8 else "quant4_matmul"
        # One card routes every product at decode; at admission the 2044 x
        # 11008 activation of down passes the 32 MiB limit.
        assert {p for p, route in want.items() if route != kernel} == (
            set() if rows == 32 else {"layers/down"})
        for tp in (2, 4):
            for r in range(tp):
                shard = shard_pytree(whole, specs, Mesh(1, tp, (0, r)))
                assert routing_report(shard, rows, torch.bfloat16, cuda) == want, (rows, tp, r)
                for name, k, n, column in LLAMA7B:
                    w = shard[name] if name == "lm_head" else shard["layers"][name][0]
                    k_local, n_local = (k, n // tp) if column else (k // tp, n)
                    assert w.q.shape[-1] == n_local and w.logical_shape == (k, n)
                    group = getattr(w, "group", 2)
                    if isinstance(w, Quant4Weight):
                        assert k_local % w.group == 0
                        assert tuple(w.scale.shape) == (k_local // w.group, n_local)
                    plan = quant_plan(bits, rows, n_local, k_local, group, 132)
                    assert plan.body == "tma", (name, tp, plan)
