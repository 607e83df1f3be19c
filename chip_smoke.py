"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compiles the port's CUDA kernels from ``reprover_tpu_torch/csrc``;
3. kernel vs plain: ``encoder_flash_attention`` against
   ``encoder_attention_reference`` on the card at byt5-small attention
   shapes (H=6, d=64), ragged masks, a masked key >= 100 above its row's
   valid scores, and a length that is not a multiple of 64; fp32 within
   1e-4, bf16 within 2e-2 * max(1, max|ref|); times from CUDA events;
4. the slice: a synthetic LeanDojo-format benchmark (12,900 premises),
   the port's retriever and generator at full byt5-small width (bf16,
   seeded random weights), ``reindex_corpus``, then the reused
   ``evaluate`` with two prover worker processes served by the reused
   ``InferenceService``; the kernel's launch count over this phase must be
   positive;
5. numeric sanity: 16 premises embedded on the card in bf16 through the
   kernel and in fp32 through the plain version agree to a per-row cosine
   >= 0.99.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a card the script exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (batch, length) of the main path's encoder calls at byt5-small width:
# generator sources at 2048, mid-length states, short premises.
KERNEL_SHAPES = [(8, 2048), (32, 1024), (4, 384)]
RAGGED_SHAPE = (3, 1000)  # length not a multiple of the 64-key tile
NUM_HEADS, HEAD_DIM = 6, 64
FP32_TOL = 1e-4
BF16_REL_TOL = 2e-2

SLICE = dict(
    num_files=300,
    premises_per_file=43,
    num_theorems_made=200,
    num_theorems=4,
    num_workers=2,
    num_sampled_tactics=64,
    max_inp_seq_len=2048,
    max_oup_seq_len=512,
    max_expansions=2,
    seed=0,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


def phase_build() -> None:
    from reprover_tpu_torch.ops.native import BuildInfo, load_library

    load_library()
    log(f"[build] {'built' if BuildInfo.built else 'reused'} {BuildInfo.path} "
        f"in {BuildInfo.seconds:.2f}s")
    for line in BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_case(b: int, l: int, dtype, gen, device):
    """Random q/k/v [b, l, 6*64], ragged mask, and in row 0 a masked key
    whose score in head 0 lies >= 100 above query 0's best valid score."""
    import torch

    shape = (b, l, NUM_HEADS * HEAD_DIM)
    q, k, v = (torch.randn(shape, generator=gen, device=device) for _ in range(3))
    lengths = torch.randint(l // 2, l + 1, (b,), generator=gen, device=device)
    lengths[0] = l
    mask = (torch.arange(l, device=device)[None, :] < lengths[:, None]).to(torch.int32)
    j = l - 3
    mask[0, j] = 0
    qh = q[0, 0, :HEAD_DIM]
    valid_best = (k[0, :, :HEAD_DIM] @ qh)[mask[0].bool()].max()
    k[0, j, :HEAD_DIM] = qh * ((valid_best + 120.0) / (qh @ qh))
    rel = torch.randn((32, NUM_HEADS), generator=gen, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask, rel


def phase_kernel(device) -> list:
    import torch

    from reprover_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for b, l in KERNEL_SHAPES + [RAGGED_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, rel = _attention_case(b, l, dtype, gen, device)
            args = (q, k, v, mask, rel)
            out = tfa.encoder_flash_attention(*args, num_heads=NUM_HEADS)
            ref = tfa.encoder_attention_reference(*args, num_heads=NUM_HEADS)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = FP32_TOL if dtype == torch.float32 else (
                BF16_REL_TOL * max(1.0, ref.float().abs().max().item()))
            finite = bool(torch.isfinite(out).all())
            iters = 20 if b * l <= 32 * 1024 else 10
            ms = _time_ms(lambda: tfa.encoder_flash_attention(*args, num_heads=NUM_HEADS), iters)
            plain_ms = _time_ms(
                lambda: tfa.encoder_attention_reference(*args, num_heads=NUM_HEADS), iters)
            row = dict(B=b, L=l, dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                       tol=tol, ms=ms, plain_ms=plain_ms, ok=finite and err <= tol)
            log(f"[kernel] {json.dumps(row)}")
            rows.append(row)
            del q, k, v, out, ref
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with the plain version: {bad}")
    return rows


def _full_width_models(device):
    import torch

    from reprover_tpu_torch.models.t5 import (
        byt5_small, fuse_mlp_params, init_params, place_params,
    )

    cfg = byt5_small(compute_dtype=torch.bfloat16)
    gen_params = init_params(cfg, torch.Generator().manual_seed(SLICE["seed"]))
    ret_full = init_params(cfg, torch.Generator().manual_seed(SLICE["seed"] + 1))
    ret_params = {"shared_embedding": ret_full["shared_embedding"], "encoder": ret_full["encoder"]}
    del ret_full
    return (cfg, place_params(fuse_mlp_params(gen_params), cfg, device),
            place_params(fuse_mlp_params(ret_params), cfg, device))


def phase_slice(device, work: str, cfg, gen_params, ret_params) -> dict:
    import torch

    from reprover_tpu.prover.environment import environment_from_dataset
    from reprover_tpu.prover.evaluate import evaluate
    from reprover_tpu.prover.service import InferenceService
    from reprover_tpu.prover.tactic_generator import FixedTacticGenerator
    from reprover_tpu_torch.generation import TacticGeneratorModel
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.retrieval import PremiseRetriever

    bench = os.path.join(work, "bench")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synthetic_benchmark.py"),
         "--out", bench, "--num-files", str(SLICE["num_files"]),
         "--premises-per-file", str(SLICE["premises_per_file"]),
         "--num-theorems", str(SLICE["num_theorems_made"])],
        check=True, cwd=REPO, capture_output=True, timeout=300,
    )
    data_path = os.path.join(bench, "random")
    with open(os.path.join(data_path, "val.json")) as f:
        environment = environment_from_dataset(json.load(f))

    retriever = PremiseRetriever(ret_params, cfg, max_seq_len=SLICE["max_inp_seq_len"])
    retriever.load_corpus(os.path.join(bench, "corpus.jsonl"))
    generator = TacticGeneratorModel(
        gen_params, cfg, SLICE["max_inp_seq_len"], SLICE["max_oup_seq_len"])
    n_premises = len(retriever.corpus)

    tfa.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    retriever.reindex_corpus(batch_size=32)
    emb = retriever.corpus_embeddings
    _sync(device)
    reindex_s = time.perf_counter() - t0
    norms = emb.norm(dim=1)
    if emb.shape != (n_premises, cfg.d_model) or not bool(
            torch.isfinite(emb).all()) or (norms - 1).abs().max().item() > 1e-3:
        raise AssertionError("corpus embeddings are not finite unit vectors of the right shape")
    reindex_launches = tfa.KERNEL_LAUNCHES
    log(f"[slice] reindex {n_premises} premises in {reindex_s:.3f}s "
        f"({n_premises / reindex_s:.1f} premises/s), {reindex_launches} kernel launches")

    service = InferenceService(generator, retriever=retriever, max_batch=8)
    service.start()
    t0 = time.perf_counter()
    try:
        pass_1, results = evaluate(
            data_path, environment, FixedTacticGenerator("unused"),
            split="val", num_theorems=SLICE["num_theorems"],
            num_sampled_tactics=SLICE["num_sampled_tactics"], timeout=600,
            max_expansions=SLICE["max_expansions"], num_workers=SLICE["num_workers"],
            make_client=service.client, return_results=True,
        )
    finally:
        service.stop()
    eval_s = time.perf_counter() - t0
    launches = tfa.KERNEL_LAUNCHES
    stats = service.stats_snapshot()
    requests = int(stats["requests"])
    per_request = stats["device_time"] / max(requests, 1)
    log(f"[slice] evaluate {SLICE['num_theorems']} theorems with {SLICE['num_workers']} workers "
        f"in {eval_s:.3f}s: {requests} requests in {int(stats['batches'])} batches, "
        f"{per_request:.3f} s/request (service time per request), Pass@1 {pass_1}")
    log(f"[slice] KERNEL_LAUNCHES {launches} ({launches - reindex_launches} while serving)")
    if len(results) != SLICE["num_theorems"] or any(r is None for r in results):
        raise AssertionError(f"searches failed or were discarded: {results}")
    if requests < 1 or any(r.num_searched_nodes < 1 for r in results):
        raise AssertionError(f"no requests were served: {stats}")
    if launches - reindex_launches < 1 or reindex_launches < 1:
        raise AssertionError("the main path did not launch the encoder-attention kernel")
    with open(os.path.join(data_path, "val.json")) as f:
        first = json.load(f)[0]
    phase_breakdown(device, generator, retriever, first)
    return dict(launches=launches, reindex_s=reindex_s, premises=n_premises,
                premises_per_s=n_premises / reindex_s, requests=requests,
                s_per_request=per_request, pass_1=pass_1, eval_s=eval_s)


def phase_breakdown(device, generator, retriever, thm: dict) -> dict:
    """One served request (retrieve 100 premises, pack, encode, beam-search
    64 x 512), timed by part on the host clock after a synchronize, and the
    device's busy share from a profiled repeat (device time of the profiled
    run over the wall time of the unprofiled one)."""
    import torch

    from reprover_tpu.data import Context, Pos, format_augmented_state, remove_marks
    from reprover_tpu_torch.generation.beam_search import beam_search
    from reprover_tpu_torch.models.t5 import (
        decode_step, encode, init_decode_state, reorder_decode_state,
    )

    cfg, params = generator.cfg, generator.params
    beams, max_len = SLICE["num_sampled_tactics"], SLICE["max_oup_seq_len"]
    state = thm["traced_tactics"][0]["state_before"]
    ctx = Context(thm["file_path"], thm["full_name"], Pos.of(thm["start"]), state)

    def request() -> dict:
        _sync(device)
        t0 = time.perf_counter()
        premises, _ = retriever.retrieve_batch([ctx], 100)
        aug = remove_marks(format_augmented_state(state, premises[0], generator.max_inp_seq_len))
        batch = generator.tokenizer([aug], max_length=generator.max_inp_seq_len,
                                    bucket_multiple=generator.bucket_multiple)
        ids = torch.from_numpy(batch.input_ids).to(device, torch.long)
        mask = torch.from_numpy(batch.attention_mask).to(device)
        t1 = time.perf_counter()
        steps = [0]

        def step(cache, tokens):
            steps[0] += 1
            return decode_step(params, cfg, cache, tokens)

        with torch.inference_mode():
            enc = encode(params, cfg, ids, mask)
            cache = init_decode_state(params, cfg, enc, mask, max_len, num_beams=beams)
            _sync(device)
            t2 = time.perf_counter()
            res = beam_search(step, reorder_decode_state, cache, 1, beams, max_len,
                              cfg.eos_token_id, cfg.pad_token_id, cfg.decoder_start_token_id,
                              generator.length_penalty, device)
            res.scores.cpu()
        t3 = time.perf_counter()
        return dict(source_len=int(ids.shape[1]), retrieve_ms=1e3 * (t1 - t0),
                    encode_ms=1e3 * (t2 - t1), decode_ms=1e3 * (t3 - t2), steps=steps[0],
                    ms_per_step=1e3 * (t3 - t2) / max(steps[0], 1), total_ms=1e3 * (t3 - t0))

    request()  # warm-up
    row = request()
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            request()
        by_name: dict = {}
        count = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
                count += 1
        device_ms = sum(by_name.values()) / 1e3
        row["device_ms"] = device_ms
        row["device_ops_per_step"] = count / max(row["steps"], 1)
        row["device_busy_share"] = device_ms / row["total_ms"] if device_ms else None
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        row["top_kernels_ms"] = {name[:60]: us / 1e3 for name, us in top}
    except Exception as ex:  # the breakdown is a report; a profiler failure is not a slice failure
        row["profiler"] = f"not measured: {ex!r}"
    log(f"[breakdown] {json.dumps(row)}")
    return row


def phase_sanity(device, cfg, ret_params) -> float:
    import dataclasses

    import torch

    from reprover_tpu.tokenizer import ByT5Tokenizer
    from reprover_tpu_torch.models.t5 import encode, place_params
    from reprover_tpu_torch.ops.flash_attention import encoder_attention_reference
    from reprover_tpu_torch.ops.pooling import masked_mean_normalize

    texts = [f"theorem sanity_{i} (x y : Nat) : x + {i} * y = {i} * y + x := by omega" * (1 + i % 3)
             for i in range(16)]
    batch = ByT5Tokenizer()(texts, max_length=2048, bucket_multiple=128)
    ids = torch.from_numpy(batch.input_ids).to(device, torch.long)
    mask = torch.from_numpy(batch.attention_mask).to(device)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    params32 = place_params(ret_params, cfg32, device)
    with torch.inference_mode():
        e16 = masked_mean_normalize(encode(ret_params, cfg, ids, mask), mask)
        e32 = masked_mean_normalize(
            encode(params32, cfg32, ids, mask, attention_fn=encoder_attention_reference), mask)
    cos = (e16 * e32).sum(dim=1)
    worst = cos.min().item()
    log(f"[sanity] bf16 kernel vs fp32 plain, 16 premises at full width: min cosine {worst:.6f}")
    if not worst >= 0.99:
        raise AssertionError(f"per-row cosine {worst} < 0.99")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    info = phase_device()
    phase_build()
    rows = phase_kernel(device)
    cfg, gen_params, ret_params = _full_width_models(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        sl = phase_slice(device, work, cfg, gen_params, ret_params)
    phase_sanity(device, cfg, ret_params)

    main_shape = next(r for r in rows if (r["B"], r["L"]) == KERNEL_SHAPES[0]
                      and r["dtype"] == "bfloat16")
    bf16_err = max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16")
    print(json.dumps({"kernels": [{
        "name": "encoder_attn",
        "route": "cuda",
        "source": "reprover_tpu_torch/csrc/encoder_attn.cu",
        "replaces": "reprover_tpu/ops/flash_attention.py:176",
        "launches": sl["launches"],
        "max_abs_err": bf16_err,
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
