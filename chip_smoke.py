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

6. kernel backward vs plain: the encoder attention's autograd (forward
   kernel + the dQ and dK/dV kernels) against autograd of
   ``encoder_attention_reference``, H=6, d=64, at the training shapes (the
   data module's batches at ``max_seq_len`` 1024, printed, and contexts at
   the 1024 cap), ragged masks, an empty row, a masked key >= 100 above its
   row and a length that is not a multiple of 64; fp32 within 1e-4 (d_rel
   1e-3) and bf16 within 2e-2 of max(1, max|ref|); times from CUDA events;
7. training: ``reprover_tpu_torch.retrieval.main.main(["fit", ...])`` at full
   byt5-small encoder width (bf16 over fp32 masters, seeded random init,
   InfoNCE, batch 8, 3 negatives with 1 in-file, ``max_seq_len`` 1024, remat
   on) for 20 steps, one validation that re-indexes the corpus, and a
   checkpoint; every logged loss finite, both backward kernels launched,
   ``metrics.jsonl`` with Recall@10_val, MRR and emb_eff_rank, and
   ``validate --ckpt_dir`` restoring the saved parameters bit for bit;
8. train step: on one fixed batch without warmup, 20 steps whose loss must
   fall, timed by part (forward, backward, optimizer) with CUDA events,
   peak memory, and the attention kernels' share of a profiled step; then
   the same timing at the 1024 cap.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a card the script exits 2 and
prints no result.

Rehearse the training phases on the CPU at tiny width (a few seconds)::

    import chip_smoke, torch
    bench = chip_smoke.make_bench("/tmp/smoke")
    chip_smoke.phase_train(torch.device("cpu"), "/tmp/smoke", bench, tiny=True)
    chip_smoke.phase_train_steps(torch.device("cpu"), bench, tiny=True)
"""

from __future__ import annotations

import json
import math
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
DREL_FP32_TOL = 1e-3  # d_rel sums L^2 terms with atomics, in any order

# Retriever training at the reference data settings.
TRAIN = dict(batch_size=8, num_negatives=3, num_in_file_negatives=1, max_seq_len=1024,
             eval_batch_size=64, steps=20, log_interval=5, lr=1e-4, seed=3407)
CONTEXT_CAP_SHAPE = (TRAIN["batch_size"], TRAIN["max_seq_len"])  # contexts at the length cap

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


def _fit_argv(device, work: str, bench: str, tiny: bool) -> list:
    """``retrieval.main`` flags of the training phases: the reference data
    settings, InfoNCE, remat on, seeded random init (or the tiny model)."""
    return [
        "--device", device.type,
        "--model.tiny" if tiny else "--model.random_init", "true",
        "--model.loss", "infonce",
        "--model.remat", "true",
        "--data.data_path", os.path.join(bench, "random"),
        "--data.corpus_path", os.path.join(bench, "corpus.jsonl"),
        "--data.batch_size", str(TRAIN["batch_size"]),
        "--data.num_negatives", str(TRAIN["num_negatives"]),
        "--data.num_in_file_negatives", str(TRAIN["num_in_file_negatives"]),
        "--data.max_seq_len", str(TRAIN["max_seq_len"]),
        "--data.eval_batch_size", str(TRAIN["eval_batch_size"]),
        "--seed", str(TRAIN["seed"]),
        "--log_dir", os.path.join(work, "logs"),
    ]


def data_shapes(bench: str) -> list:
    """(batch, length) of the encoder calls of the first training batches at
    ``max_seq_len`` 1024: contexts and premises, or their stack when the two
    lengths agree (the losses then encode once)."""
    from reprover_tpu.retrieval.datamodule import RetrievalDataModule

    dm = RetrievalDataModule(
        os.path.join(bench, "random"), os.path.join(bench, "corpus.jsonl"),
        TRAIN["num_negatives"], TRAIN["num_in_file_negatives"], TRAIN["batch_size"],
        TRAIN["eval_batch_size"], TRAIN["max_seq_len"], seed=TRAIN["seed"])
    dm.setup("fit")
    shapes = set()
    for i, batch in enumerate(dm.train_dataloader()):
        (bc, lc), (bp, lp) = batch["context_ids"].shape, batch["premise_ids"].shape
        shapes |= {(bc + bp, lc)} if lc == lp else {(bc, lc), (bp, lp)}
        if i >= 20:
            break
    log(f"[kernel_bwd] data module batches at max_seq_len {TRAIN['max_seq_len']}: "
        f"contexts [{bc}, {lc}], premises [{bp}, {lp}]; encoder calls {sorted(shapes)}")
    return sorted(shapes)


def phase_kernel_backward(device, shapes: list) -> list:
    """Autograd through the kernels vs autograd of the plain version at
    ``shapes`` plus the 1024 context cap and the ragged case, fp32 and bf16;
    times of the whole backward and of each backward kernel alone."""
    import torch

    from reprover_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for b, l in [CONTEXT_CAP_SHAPE] + list(shapes) + [RAGGED_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, rel = _attention_case(b, l, dtype, gen, device)
            mask[-1] = 0  # a row with no valid key: zero gradients
            dout = torch.randn(q.shape, generator=gen, device=device).to(dtype)

            def grads(fn):
                leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rel)]
                out = fn(leaves[0], leaves[1], leaves[2], mask, leaves[3], num_heads=NUM_HEADS)
                return out, leaves, torch.autograd.grad(out, leaves, dout, retain_graph=True)

            out_k, leaves_k, got = grads(tfa.encoder_flash_attention)
            out_p, leaves_p, want = grads(tfa.encoder_attention_reference)
            torch.cuda.synchronize()
            errs, ok = {}, True
            for name, g, w in zip(("dq", "dk", "dv", "d_rel"), got, want):
                tol = BF16_REL_TOL if dtype == torch.bfloat16 else (
                    DREL_FP32_TOL if name == "d_rel" else FP32_TOL)
                tol *= max(1.0, w.float().abs().max().item())
                errs[name] = (g.float() - w.float()).abs().max().item()
                ok &= bool(torch.isfinite(g).all()) and errs[name] <= tol
            ok &= all(g[-1].abs().max().item() == 0.0 for g in got[:3])
            iters = 10 if b * l <= 32 * 1024 else 5
            ms = _time_ms(lambda: torch.autograd.grad(out_k, leaves_k, dout, retain_graph=True),
                          iters)
            plain_ms = _time_ms(
                lambda: torch.autograd.grad(out_p, leaves_p, dout, retain_graph=True), iters)
            # Each backward kernel alone, on the forward's LSE.
            mask32, rel32, table = tfa._kernel_operands(mask, rel, 32, 128)
            out, lse = tfa._forward_cuda(q, k, v, mask32, rel32, table, NUM_HEADS, 128, True)
            delta = tfa.row_delta(dout, out, NUM_HEADS)
            bins = torch.zeros((NUM_HEADS, 257), device=device)
            bufs = (torch.empty_like(q), torch.empty_like(q))
            common = (q, k, v, dout, mask32, rel32, table, lse, delta)
            dq_ms = _time_ms(lambda: tfa._backward_cuda(
                "encoder_attn_bwd_dq", *common, bufs[0], bins, NUM_HEADS, 128), iters)
            dkv_ms = _time_ms(lambda: tfa._backward_cuda(
                "encoder_attn_bwd_dkv", *common, *bufs, NUM_HEADS, 128), iters)
            row = dict(B=b, L=l, dtype=str(dtype).replace("torch.", ""), errs=errs, ok=ok,
                       bwd_ms=ms, plain_bwd_ms=plain_ms, dq_ms=dq_ms, dkv_ms=dkv_ms)
            log(f"[kernel_bwd] {json.dumps(row)}")
            rows.append(row)
            del out_k, out_p, leaves_k, leaves_p, got, want
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"backward kernels disagree with the plain version: {bad}")
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


def make_bench(work: str) -> str:
    """The synthetic LeanDojo-format benchmark (12,900 premises) under
    ``work``; returns its directory."""
    bench = os.path.join(work, "bench")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synthetic_benchmark.py"),
         "--out", bench, "--num-files", str(SLICE["num_files"]),
         "--premises-per-file", str(SLICE["premises_per_file"]),
         "--num-theorems", str(SLICE["num_theorems_made"])],
        check=True, cwd=REPO, capture_output=True, timeout=300,
    )
    return bench


def phase_slice(device, bench: str, cfg, gen_params, ret_params) -> dict:
    import torch

    from reprover_tpu.prover.environment import environment_from_dataset
    from reprover_tpu.prover.evaluate import evaluate
    from reprover_tpu.prover.service import InferenceService
    from reprover_tpu.prover.tactic_generator import FixedTacticGenerator
    from reprover_tpu_torch.generation import TacticGeneratorModel
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.retrieval import PremiseRetriever

    data_path = os.path.join(bench, "random")
    with open(os.path.join(data_path, "val.json")) as f:
        environment = environment_from_dataset(json.load(f))

    retriever = PremiseRetriever(ret_params, cfg, max_seq_len=SLICE["max_inp_seq_len"])
    retriever.load_corpus(os.path.join(bench, "corpus.jsonl"))
    generator = TacticGeneratorModel(
        gen_params, cfg, SLICE["max_inp_seq_len"], SLICE["max_oup_seq_len"])
    n_premises = len(retriever.corpus)

    tfa.reset_launch_counts()
    t0 = time.perf_counter()
    retriever.reindex_corpus(batch_size=32)
    emb = retriever.corpus_embeddings
    _sync(device)
    reindex_s = time.perf_counter() - t0
    norms = emb.norm(dim=1)
    if emb.shape != (n_premises, cfg.d_model) or not bool(
            torch.isfinite(emb).all()) or (norms - 1).abs().max().item() > 1e-3:
        raise AssertionError("corpus embeddings are not finite unit vectors of the right shape")
    reindex_launches = tfa.KERNEL_LAUNCHES["encoder_attn"]
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
    launches = tfa.KERNEL_LAUNCHES["encoder_attn"]
    stats = service.stats_snapshot()
    requests = int(stats["requests"])
    per_request = stats["device_time"] / max(requests, 1)
    log(f"[slice] evaluate {SLICE['num_theorems']} theorems with {SLICE['num_workers']} workers "
        f"in {eval_s:.3f}s: {requests} requests in {int(stats['batches'])} batches, "
        f"{per_request:.3f} s/request (service time per request), Pass@1 {pass_1}")
    log(f"[slice] encoder_attn launches {launches} ({launches - reindex_launches} while serving)")
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


def phase_train(device, work: str, bench: str, tiny: bool = False) -> dict:
    """Retriever training through the CLI entry point: 20 steps, one
    validation (re-indexing the corpus) and a checkpoint, then ``validate
    --ckpt_dir`` restoring the checkpoint."""
    import torch

    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.retrieval.main import main as retrieval_main

    ckpt = os.path.join(work, "ckpts")
    argv = _fit_argv(device, work, bench, tiny) + [
        "--trainer.max_steps", str(TRAIN["steps"]),
        "--trainer.val_interval", str(TRAIN["steps"]),
        "--trainer.log_interval", str(TRAIN["log_interval"]),
        "--trainer.patience", "99",
        "--trainer.ckpt_dir", ckpt,
    ]
    tfa.reset_launch_counts()
    t0 = time.perf_counter()
    state = retrieval_main(["fit"] + argv)
    _sync(device)
    fit_s = time.perf_counter() - t0
    launches = dict(tfa.KERNEL_LAUNCHES)
    with open(os.path.join(work, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    sps = [r["steps_per_sec"] for r in recs if "steps_per_sec" in r]
    val = [r for r in recs if "Recall@10_val" in r]
    log(f"[train] fit {state.step} steps in {fit_s:.3f}s (validation and checkpoint included); "
        f"losses {losses}; steps/s per {TRAIN['log_interval']}-step window {sps}; "
        f"kernel launches {launches}")
    if val:
        keys = ("Recall@1_val", "Recall@10_val", "MRR", "emb_eff_rank", "cos_offdiag_std")
        log(f"[train] validation {json.dumps({k: val[-1].get(k) for k in keys})}")
    if state.step != TRAIN["steps"] or len(losses) != TRAIN["steps"] // TRAIN["log_interval"]:
        raise AssertionError(f"fit ran {state.step} steps and logged {len(losses)} losses")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not val or not {"MRR", "emb_eff_rank"} <= set(val[-1]):
        raise AssertionError("metrics.jsonl lacks Recall@10_val, MRR or emb_eff_rank")
    if device.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"training did not launch every attention kernel: {launches}")

    saved = torch.load(os.path.join(ckpt, str(TRAIN["steps"]), "state.pt"),
                       map_location="cpu", weights_only=True)["params"]
    _, retriever = retrieval_main(["validate"] + argv + ["--ckpt_dir", ckpt])
    mismatched = [name for name, t in _flat(retriever.params).items()
                  if not torch.equal(t.detach().cpu(), _flat(saved)[name])]
    if mismatched:
        raise AssertionError(f"validate --ckpt_dir restored different parameters: {mismatched}")
    log(f"[train] validate --ckpt_dir restored {len(_flat(saved))} parameter tensors bit-equal")
    return dict(launches=launches, losses=losses, steps_per_sec=sps, fit_s=fit_s,
                validation=val[-1])


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _long_batch(batch: dict, gen) -> dict:
    """The batch's layout at the 1024 cap: contexts [8, 1024] and premises
    [32, 1024] of random bytes with ragged lengths, same labels."""
    import numpy as np

    rng = np.random.default_rng(gen)
    out = dict(batch)
    length = TRAIN["max_seq_len"]
    for side in ("context", "premise"):
        rows = batch[f"{side}_ids"].shape[0]
        lens = rng.integers(length // 4, length + 1, rows)
        mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
        out[f"{side}_ids"] = rng.integers(3, 259, (rows, length)).astype(np.int32) * mask
        out[f"{side}_mask"] = mask
    return out


def phase_train_steps(device, bench: str, tiny: bool = False) -> dict:
    """One fixed batch, no warmup: 20 steps whose loss must fall, each timed
    by part; peak memory; the attention kernels' share of a profiled step.
    Then the same timing on the batch's layout at the 1024 cap."""
    import torch

    from reprover_tpu_torch.retrieval.main import LINKS, RetrievalConfig, _build
    from reprover_tpu_torch.training.tasks import (
        init_train_state, numeric_batch, retrieval_infonce_loss,
    )
    from reprover_tpu_torch.utils.config import parse_config

    _, cfg = parse_config(RetrievalConfig, _fit_argv(device, "unused", bench, tiny), links=LINKS)
    dm, retriever, model_cfg = _build(cfg)
    dm.setup("fit")
    state = init_train_state(retriever.params, TRAIN["lr"], warmup_steps=0)
    host_batch = next(iter(dm.train_dataloader()))
    cuda = device.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms_between(a, b) -> float:
        return a.elapsed_time(b) if cuda else 1e3 * (b - a)

    def timed_steps(batch: dict, n: int) -> list:
        """Per step: (loss tensor, forward ms, backward ms, optimizer ms)."""
        out = []
        for _ in range(n):
            m0 = mark()
            state.optimizer.zero_grad()
            loss = retrieval_infonce_loss(state.params, model_cfg, batch)
            m1 = mark()
            loss.backward()
            m2 = mark()
            state.optimizer.step()
            m3 = mark()
            _sync(device)
            out.append((loss.detach(), ms_between(m0, m1), ms_between(m1, m2), ms_between(m2, m3)))
        return out

    def profiled_share(batch: dict) -> dict:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                timed_steps(batch, 1)
            by_name: dict = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        except Exception as ex:  # the share is a report; a profiler failure is not a phase failure
            return {"profiler": f"not measured: {ex!r}"}
        total = sum(by_name.values())
        attn = {n: us for n, us in by_name.items() if "encoder_attn" in n}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        return dict(device_ms=total / 1e3, attention_ms=sum(attn.values()) / 1e3,
                    attention_share=sum(attn.values()) / total if total else None,
                    attention_kernels_ms={n[:70]: us / 1e3 for n, us in attn.items()},
                    top_kernels_ms={n[:70]: us / 1e3 for n, us in top})

    results = {}
    for name, hb in (("data", host_batch), ("cap", _long_batch(host_batch, TRAIN["seed"]))):
        batch = numeric_batch(hb, device)
        shapes = {k: list(v.shape) for k, v in batch.items() if k.endswith("_ids")}
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        steps = timed_steps(batch, TRAIN["steps"] if name == "data" else 5)
        losses = [float(s[0]) for s in steps]
        warm = steps[2:]
        row = dict(batch=name, shapes=shapes, first_loss=losses[0], last_loss=losses[-1],
                   forward_ms=sum(s[1] for s in warm) / len(warm),
                   backward_ms=sum(s[2] for s in warm) / len(warm),
                   optimizer_ms=sum(s[3] for s in warm) / len(warm))
        row["step_ms"] = row["forward_ms"] + row["backward_ms"] + row["optimizer_ms"]
        row["steps_per_sec"] = 1e3 / row["step_ms"]
        if cuda:
            row["max_memory_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
            row.update(profiled_share(batch))
        log(f"[train_step] {json.dumps(row)}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite loss on the fixed batch: {losses}")
        if name == "data":
            log(f"[train_step] repeated batch, lr {TRAIN['lr']} without warmup: loss "
                f"{losses[0]:.6f} -> {losses[-1]:.6f} over {len(losses)} steps")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"the loss on one fixed batch did not fall: {losses}")
        results[name] = row
    return results


def _kernel_entry(name: str, source: str, replaces: str, launches: int, err: float,
                  row: dict, ms_key: str, plain_key: str) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": row[ms_key],
            "plain_ms": row[plain_key]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda")
    info = phase_device()
    phase_build()
    rows = phase_kernel(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        bench = make_bench(work)
        bwd_rows = phase_kernel_backward(device, data_shapes(bench))
        cfg, gen_params, ret_params = _full_width_models(device)
        sl = phase_slice(device, bench, cfg, gen_params, ret_params)
        phase_sanity(device, cfg, ret_params)
        del gen_params, ret_params
        torch.cuda.empty_cache()
        tr = phase_train(device, work, bench)
        phase_train_steps(device, bench)
    log(f"[smoke] wall time {time.perf_counter() - t_start:.1f}s")

    fwd_row = next(r for r in rows if (r["B"], r["L"]) == KERNEL_SHAPES[0]
                   and r["dtype"] == "bfloat16")
    bwd_row = next(r for r in bwd_rows if (r["B"], r["L"]) == CONTEXT_CAP_SHAPE
                   and r["dtype"] == "bfloat16")
    bf16_bwd = [r["errs"] for r in bwd_rows if r["dtype"] == "bfloat16"]
    launches = tr["launches"]
    src = "reprover_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        _kernel_entry("encoder_attn", src + "encoder_attn.cu",
                      "reprover_tpu/ops/flash_attention.py:176",
                      sl["launches"] + launches["encoder_attn"],
                      max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
                      fwd_row, "ms", "plain_ms"),
        _kernel_entry("encoder_attn_bwd_dq", src + "encoder_attn_bwd.cu",
                      "reprover_tpu/ops/flash_attention.py:607",
                      launches["encoder_attn_bwd_dq"],
                      max(max(e["dq"], e["d_rel"]) for e in bf16_bwd),
                      bwd_row, "dq_ms", "plain_bwd_ms"),
        _kernel_entry("encoder_attn_bwd_dkv", src + "encoder_attn_bwd.cu",
                      "reprover_tpu/ops/flash_attention.py:715",
                      launches["encoder_attn_bwd_dkv"],
                      max(max(e["dk"], e["dv"]) for e in bf16_bwd),
                      bwd_row, "dkv_ms", "plain_bwd_ms"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
