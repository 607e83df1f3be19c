"""PyTorch port: the stepwise continuous-batching engine and the streaming
inference service (``generation/engine.py``, ``prover/service.py``), the
mirror of ``tests/test_engine.py``.

The engine must reproduce the port's classic one-shot beam search: the same
texts, scores within rtol 1e-5 (fp32; the engine sums attention over the
lazily appended column in another order), through aligned and staggered
admissions, slot reuse, wave admission, length buckets and the service. One
case holds the port's engine to the JAX package's engine on the same
weights (carried over by the bridge) in fp32, with the same tolerance."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import jax

from reprover_tpu_torch.data import Pos
from reprover_tpu_torch.generation.engine import StepwiseBeamEngine
from reprover_tpu_torch.generation.generator import TacticGeneratorModel
from reprover_tpu_torch.models.t5 import T5Config, encode, init_params
from reprover_tpu_torch.prover.service import GenerateRequest, StreamingInferenceService
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

CFG = T5Config(
    vocab_size=64,  # small vocab -> beams collide and EOS fires often
    d_model=32,
    d_kv=8,
    d_ff=64,
    num_heads=4,
    num_encoder_layers=2,
    num_decoder_layers=2,
)
SMAX = 32
TDEC = 12
K = 4


@pytest.fixture(scope="module")
def setup():
    params = init_params(CFG, torch.Generator().manual_seed(5))
    model = TacticGeneratorModel(params, CFG, max_inp_seq_len=SMAX, max_oup_seq_len=TDEC,
                                 bucket_multiple=SMAX)
    rng = np.random.default_rng(3)
    # Digits: their byte ids (51..60) lie inside the small vocabulary.
    texts = ["".join(chr(48 + rng.integers(0, 10)) for _ in range(n)) for n in (9, 14, 6, 11)]
    classic = {t: model.generate([t], num_samples=K, max_length=TDEC)[0] for t in texts}
    return params, model, texts, classic


def _admit_text(engine, model, slot, text):
    batch = model.tokenizer([text], max_length=SMAX, bucket_multiple=SMAX)
    ids = torch.from_numpy(batch.input_ids).long()
    mask = torch.from_numpy(batch.attention_mask)
    enc = encode(engine.params, engine.cfg, ids, mask)
    pad = SMAX - enc.shape[1]
    if pad:
        enc = torch.nn.functional.pad(enc, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    engine.admit(slot, enc, mask)


def _decode(model, seqs, scores):
    return [(model.tokenizer.decode(seqs[k], skip_special_tokens=True), float(scores[k]))
            for k in range(K)]


def _collect(engine, model):
    """Run chunks until every active slot finishes -> {slot: [(text, score)]}."""
    out = {}
    for _ in range(64):
        if not engine.has_active():
            break
        engine.run_chunk()
        for slot in engine.finished_slots():
            seqs, scores, _ = engine.finalize(slot)
            out[slot] = _decode(model, seqs, scores)
    return out


def _assert_same(got, want):
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5, atol=1e-6)


def _engine(params, **kw):
    return StepwiseBeamEngine(params, CFG, num_beams=K, max_src_len=SMAX, max_decode_len=TDEC,
                              **kw)


@pytest.mark.parametrize("reorder_mode", ["einsum", "gather", "scan"])
def test_aligned_admissions_match_classic(setup, reorder_mode):
    params, model, texts, classic = setup
    engine = _engine(params, num_slots=2, chunk_size=3, reorder_mode=reorder_mode)
    _admit_text(engine, model, 0, texts[0])
    _admit_text(engine, model, 1, texts[1])
    results = _collect(engine, model)
    _assert_same(results[0], classic[texts[0]])
    _assert_same(results[1], classic[texts[1]])


def test_staggered_admissions_match_classic(setup):
    """A request admitted mid-decode of another must not perturb either."""
    params, model, texts, classic = setup
    engine = _engine(params, num_slots=2, chunk_size=2)
    _admit_text(engine, model, 0, texts[0])
    engine.run_chunk()  # slot 0 is now 2 tokens deep
    _admit_text(engine, model, 1, texts[1])
    results = _collect(engine, model)
    _assert_same(results[0], classic[texts[0]])
    _assert_same(results[1], classic[texts[1]])


def test_slot_reuse_after_finalize(setup):
    params, model, texts, classic = setup
    engine = _engine(params, num_slots=1, chunk_size=4)
    _admit_text(engine, model, 0, texts[2])
    _assert_same(_collect(engine, model)[0], classic[texts[2]])
    assert engine.free_slots() == [0]
    _admit_text(engine, model, 0, texts[3])
    _assert_same(_collect(engine, model)[0], classic[texts[3]])


def test_admit_batch_tokens_wave(setup):
    """Wave admission with a padding row (slot -1): a no-op for the padding,
    classic-exact for the rest, including a wave admitted mid-decode."""
    params, model, texts, classic = setup
    engine = _engine(params, num_slots=4, chunk_size=3)

    def wave(slots, wave_texts):
        batch = model.tokenizer(wave_texts + [""] * (4 - len(wave_texts)), max_length=SMAX,
                                pad_to=SMAX)
        engine.admit_batch_tokens(slots + [-1] * (4 - len(slots)), batch.input_ids,
                                  batch.attention_mask)

    wave([2, 0], [texts[0], texts[1]])
    engine.run_chunk()  # slots 0/2 are mid-decode when slot 1 joins
    wave([1], [texts[2]])
    results = _collect(engine, model)
    _assert_same(results[2], classic[texts[0]])
    _assert_same(results[0], classic[texts[1]])
    _assert_same(results[1], classic[texts[2]])
    assert 3 not in results  # the padding row never occupied slot 3


def test_dispatch_run_status_and_release(setup):
    """The flat status: run-until-event stops on the finish event, flags the
    finished slot and carries a finalize payload equal to the classic
    result; a release mask in the next dispatch clears the slot."""
    params, model, texts, classic = setup
    engine = _engine(params, num_slots=2, chunk_size=3)
    _admit_text(engine, model, 0, texts[0])
    f = -1
    for _ in range(64):
        status = engine.dispatch_run(4)
        active, done, n, steps, f, payload = engine.unpack_status(status)
        assert steps <= 4
        if f >= 0:
            break
    assert f == 0 and (done[0] or n[0] >= TDEC)
    seqs, scores, _ = engine.finalize_prefetched(0, payload)
    _assert_same(_decode(model, seqs, scores), classic[texts[0]])

    active, done, n = engine.host_status()
    assert active[0]  # still finished on the device until the release rides along
    release = np.zeros(2, bool)
    release[0] = True
    engine.unpack_status(engine.dispatch_run(1, release))
    active, done, n = engine.host_status()
    assert not active[0] and not done[0]


def test_bucketed_engine_exact_parity(setup):
    """Length-bucketed stepping (the caches cut to the bucket covering the
    deepest working slot) across bucket boundaries, in each reorder mode,
    then slot reuse re-entering the smallest bucket."""
    params, model, texts, classic = setup
    for mode in ("einsum", "gather"):
        engine = _engine(params, num_slots=2, chunk_size=2, step_buckets=(4, 8, TDEC),
                         reorder_mode=mode)
        _admit_text(engine, model, 0, texts[0])
        engine.run_chunk()  # slot 0 crosses into a deeper bucket than slot 1
        _admit_text(engine, model, 1, texts[1])
        results = _collect(engine, model)
        _assert_same(results[0], classic[texts[0]])
        _assert_same(results[1], classic[texts[1]])
        _admit_text(engine, model, 0, texts[2])
        _assert_same(_collect(engine, model)[0], classic[texts[2]])


def test_engine_matches_jax_engine(setup):
    """The port's engine against the JAX package's on the same fp32 weights:
    the same finalized sequences, lengths and scores (rtol 1e-5)."""
    import jax.numpy as jnp

    from reprover_tpu.generation.engine import StepwiseBeamEngine as JaxEngine
    from reprover_tpu.models.t5 import T5Config as JaxConfig
    from reprover_tpu.models.t5 import init_params as jax_init
    from reprover_tpu.tokenizer import ByT5Tokenizer as JaxTokenizer
    from reprover_tpu_torch.models.bridge import params_from_jax

    _, _, texts, _ = setup
    jcfg = JaxConfig(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_heads=4,
                     num_encoder_layers=2, num_decoder_layers=2)
    jparams = jax_init(jax.random.PRNGKey(11), jcfg)
    ours = _engine(params_from_jax(jax.tree.map(np.asarray, jparams)), num_slots=2, chunk_size=3,
                   reorder_mode="gather")
    theirs = JaxEngine(jparams, jcfg, num_slots=2, num_beams=K, max_src_len=SMAX,
                       max_decode_len=TDEC, chunk_size=3)
    batch = JaxTokenizer()(texts[:2], max_length=SMAX, pad_to=SMAX)
    ours.admit_batch_tokens([0, 1], batch.input_ids, batch.attention_mask)
    theirs.admit_batch_tokens([0, 1], jnp.asarray(batch.input_ids),
                              jnp.asarray(batch.attention_mask))
    got, want = {}, {}
    for engine, out in ((ours, got), (theirs, want)):
        for _ in range(64):
            if not engine.has_active():
                break
            engine.run_chunk()
            for slot in engine.finished_slots():
                out[slot] = engine.finalize(slot)
    assert sorted(got) == sorted(want) == [0, 1]
    for slot in (0, 1):
        (gs, gsc, gl), (ws, wsc, wl) = got[slot], want[slot]
        np.testing.assert_array_equal(np.asarray(gs), np.asarray(ws))
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(wl))
        np.testing.assert_allclose(gsc, np.asarray(wsc), rtol=1e-5, atol=1e-6)


def test_simultaneous_finish_fallback(setup):
    """Two slots decoding the same input finish on the same step: one finish
    rides the status payload, the other comes back through the prefetch
    fallback; both classic-exact. Both requests are queued before the serve
    thread starts, so they are admitted in one wave."""
    params, model, texts, classic = setup
    svc = StreamingInferenceService(model, num_slots=2, num_beams=K, chunk_size=3)
    clients = [svc.client() for _ in range(2)]
    for c in clients:
        c.request_q.put(GenerateRequest(c.client_id, 0, texts[0], "a.lean", "t", (1, 1), K))
    svc.start()
    try:
        r0, r1 = (c.response_q.get(timeout=120) for c in clients)
    finally:
        svc.stop()
    assert r0.error is None and r1.error is None
    _assert_same(r0.candidates, classic[texts[0]])
    _assert_same(r1.candidates, classic[texts[0]])


def test_streaming_service_crash_containment(setup):
    """An engine fault mid-serve fails the outstanding request with an error
    and the service keeps serving after the reset."""
    params, model, texts, classic = setup
    svc = StreamingInferenceService(model, num_slots=2, num_beams=K, chunk_size=3)
    svc.start()
    try:
        client = svc.client()

        async def one(text):
            return await client.agenerate(text, "a.lean", "t", Pos(1, 1), K)

        deadline = time.monotonic() + 60
        while svc._engine is None and time.monotonic() < deadline:
            time.sleep(0.05)  # the serve thread builds the engine lazily
        real = svc._engine.dispatch_run
        calls = {"n": 0}

        def boom(max_steps, release=None):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected engine fault")
            return real(max_steps, release)

        svc._engine.dispatch_run = boom
        with pytest.raises(RuntimeError, match="injected engine fault"):
            asyncio.run(one(texts[0]))
        r = asyncio.run(one(texts[1]))
    finally:
        svc.stop()
    _assert_same(r, classic[texts[1]])


def test_streaming_service_matches_classic(setup):
    """Streaming candidates == classic generate, including a mismatched-width
    request served through the fallback path."""
    params, model, texts, classic = setup
    svc = StreamingInferenceService(model, num_slots=2, num_beams=K, chunk_size=3)
    svc.start()
    try:
        clients = [svc.client() for _ in range(3)]

        async def one(c, text, width):
            return await c.agenerate(text, "a.lean", "t", Pos(1, 1), width)

        async def go():
            return await asyncio.gather(one(clients[0], texts[0], K), one(clients[1], texts[1], K),
                                        one(clients[2], texts[2], 2))  # width 2 -> fallback

        r0, r1, r2 = asyncio.run(go())
    finally:
        svc.stop()
    _assert_same(r0, classic[texts[0]])
    _assert_same(r1, classic[texts[1]])
    _assert_same(r2, model.generate([texts[2]], num_samples=2, max_length=TDEC)[0])
    snap = svc.stats_snapshot()
    assert snap["admissions"] == 2 and snap["fallbacks"] == 1


def test_streaming_fallback_does_not_stall_engine(setup):
    """A non-engine-width request must not block the serve loop: while its
    classic decode waits for the engine-width requests to complete, those
    keep admitting and finishing."""
    params, model, texts, classic = setup
    svc = StreamingInferenceService(model, num_slots=2, num_beams=K, chunk_size=3)
    real_generate = model.generate
    engine_done = threading.Event()

    def slow_generate(states, num_samples, **kw):
        if num_samples != K:  # the fallback width only
            assert engine_done.wait(timeout=120), "engine-width requests stalled"
        return real_generate(states, num_samples, **kw)

    model.generate = slow_generate
    svc.start()
    try:
        clients = [svc.client() for _ in range(3)]

        async def one(c, text, width):
            return await c.agenerate(text, "a.lean", "t", Pos(1, 1), width)

        async def go():
            fb = asyncio.ensure_future(one(clients[0], texts[2], 2))
            await asyncio.sleep(0.3)  # the fallback is on its side thread now
            r0, r1 = await asyncio.gather(one(clients[1], texts[0], K),
                                          one(clients[2], texts[1], K))
            engine_done.set()
            return r0, r1, await fb

        r0, r1, rfb = asyncio.run(go())
    finally:
        engine_done.set()
        model.generate = real_generate
        svc.stop()
    _assert_same(r0, classic[texts[0]])
    _assert_same(r1, classic[texts[1]])
    _assert_same(rfb, model.generate([texts[2]], num_samples=2, max_length=TDEC)[0])
    assert svc.stats_snapshot()["fallbacks"] == 1


def test_streaming_service_oversubscribed(setup):
    """More concurrent requests than slots: the backlog, slot reuse and the
    stale-status admission barrier still give classic-exact results."""
    params, model, texts, classic = setup
    svc = StreamingInferenceService(model, num_slots=2, num_beams=K, chunk_size=2,
                                    pipeline_depth=3)
    svc.start()
    try:
        clients = [svc.client() for _ in range(12)]

        async def one(c, text, delay):
            await asyncio.sleep(delay)
            return await c.agenerate(text, "a.lean", "t", Pos(1, 1), K)

        async def go():
            return await asyncio.gather(*(one(clients[4 * w + i], texts[i], 0.02 * (4 * w + i))
                                          for w in range(3) for i in range(4)))

        results = asyncio.run(go())
    finally:
        svc.stop()
    for w in range(3):
        for i in range(4):
            _assert_same(results[4 * w + i], classic[texts[i]])
    snap = svc.stats_snapshot()
    assert snap["admissions"] == 12 and snap["requests"] == 12


def test_evaluate_cli_builds_streaming_service(setup):
    """``--streaming`` and its flags (the JAX CLI's names and defaults) build
    the streaming service; without it the coalescing one."""
    from reprover_tpu_torch.prover.evaluate import build_parser, build_service
    from reprover_tpu_torch.prover.service import InferenceService

    params, model, texts, classic = setup
    args = build_parser().parse_args(["--data-path", "d", "--streaming", "--num-slots", "3",
                                      "--num-sampled-tactics", str(K)])
    assert (args.chunk_size, args.chunk_burst, args.pipeline_depth) == (8, 4, 4)
    svc = build_service(args, model)
    assert isinstance(svc, StreamingInferenceService)
    assert (svc.num_slots, svc.num_beams, svc.chunk_size) == (3, K, 8)
    plain = build_service(build_parser().parse_args(["--data-path", "d"]), model)
    assert type(plain) is InferenceService
