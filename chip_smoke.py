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
   the same timing at the 1024 cap;
9. decoder kernels vs plain: ``causal_flash_attention`` and
   ``cross_flash_attention``, forward and autograd backward, against their
   plain versions at the generator's shapes (causal [8, 512] and a ragged
   [3, 200]; cross T=512 against S=2304 at B=8 and a ragged [3, 200] x
   [3, 1000]), ragged encoder masks, a masked key >= 100 above its row's
   valid scores; fp32 within 1e-4 (d_rel 1e-3), bf16 within 2e-2 of
   max(1, max|ref|); times from CUDA events, beside one
   ``scaled_dot_product_attention`` call (and its autograd) on the same
   inputs as the library's yardstick;
10. generator training: ``retrieval.main predict`` from the retriever
    checkpoint of phase 7 writes ``predictions.pickle``, then
    ``reprover_tpu_torch.generation.main.main(["fit", ...])`` at full
    byt5-small width (bf16 over fp32 masters, seeded random init, remat
    full, batch 8, states augmented with the retrieved premises up to 2300
    bytes, tactics up to 512) runs 20 steps, one validation (one batch,
    greedy) and a checkpoint; every logged loss finite, all nine attention
    kernels launched, ``validate --ckpt_dir`` restoring the parameters bit
    for bit;
11. generator train step: one fixed random batch at the reference cap
    ([8, 2304] sources, [8, 512] targets, ragged), 20 steps without warmup
    whose loss must fall, timed by part with CUDA events, peak memory, and
    each attention kernel's share of a profiled step.

The line before the last is ``{"kernels": [...]}`` (the nine kernels, with
their launches on the three main paths: serving, retriever training,
generator training, and their times, bounds and library times at the
generator-training shapes); the last line is ``{"ok": true, "device":
{...}}``. Without a card the script exits 2 and prints no result.

Rehearse the training phases on the CPU at tiny width (a minute)::

    import chip_smoke, torch
    work = "smoke"  # any scratch directory
    bench = chip_smoke.make_bench(work)
    chip_smoke.phase_train(torch.device("cpu"), work, bench, tiny=True)
    chip_smoke.phase_train_steps(torch.device("cpu"), bench, tiny=True)
    chip_smoke.phase_generator_train(torch.device("cpu"), work, bench, tiny=True)
    chip_smoke.phase_generator_steps(torch.device("cpu"), tiny=True)
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (batch, length) of the main paths' encoder calls at byt5-small width:
# generator-training sources at 2304, served sources at 2048, mid-length
# states, short premises.
KERNEL_SHAPES = [(8, 2304), (8, 2048), (32, 1024), (4, 384)]
GEN_SHAPE = (8, 2304)  # generator training: 2300-byte sources padded to 2304
RAGGED_SHAPE = (3, 1000)  # length not a multiple of the 64-key tile
NUM_HEADS, HEAD_DIM = 6, 64
FP32_TOL = 1e-4
BF16_REL_TOL = 2e-2
DREL_FP32_TOL = 1e-3  # d_rel sums L^2 terms with atomics, in any order

# Retriever training at the reference data settings.
TRAIN = dict(batch_size=8, num_negatives=3, num_in_file_negatives=1, max_seq_len=1024,
             eval_batch_size=64, steps=20, log_interval=5, lr=1e-4, seed=3407)
CONTEXT_CAP_SHAPE = (TRAIN["batch_size"], TRAIN["max_seq_len"])  # contexts at the length cap

# Generator training at the reference data settings
# (confs/generation_lean4_random.yaml), cut to 20 steps and one val batch.
GEN = dict(batch_size=8, eval_batch_size=64, max_inp_seq_len=2300, max_oup_seq_len=512,
           steps=20, log_interval=5, lr=1e-4, seed=3407)
# (B, T) causal and (B, T, S) cross shapes: the generator's decoder at the
# 512 cap over 2304-byte sources, and ragged cases.
CAUSAL_SHAPES = [(8, 512), (3, 200)]
CROSS_SHAPES = [(8, 512, 2304), (3, 200, 1000)]

# The card's published peaks (H100 SXM): the bound of a kernel is the larger
# of its operations over the bf16 tensor-core rate and its bytes over the
# memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

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


def _attention_case(b: int, lq: int, lk: int, dtype, gen, device, causal: bool = False):
    """Random q [b, lq, 6*64] and k/v [b, lk, 6*64], a ragged key mask (all
    ones for causal self-attention), and in row 0 a key masked for query 0
    (by the mask, or by causality) whose score in head 0 lies >= 100 above
    query 0's best valid score."""
    import torch

    inner = NUM_HEADS * HEAD_DIM
    q = torch.randn((b, lq, inner), generator=gen, device=device)
    k, v = (torch.randn((b, lk, inner), generator=gen, device=device) for _ in range(2))
    lengths = torch.randint(lk // 2, lk + 1, (b,), generator=gen, device=device)
    lengths[0] = lk
    mask = (torch.arange(lk, device=device)[None, :] < lengths[:, None]).to(torch.int32)
    j = lk - 3
    if causal:
        mask[:] = 1
        valid0 = torch.zeros(lk, dtype=torch.bool, device=device)
        valid0[0] = True  # query 0 sees key 0 only; key j > 0 is its future
    else:
        mask[0, j] = 0
        valid0 = mask[0].bool()
    qh = q[0, 0, :HEAD_DIM]
    valid_best = (k[0, :, :HEAD_DIM] @ qh)[valid0].max()
    k[0, j, :HEAD_DIM] = qh * ((valid_best + 120.0) / (qh @ qh))
    rel = torch.randn((32, NUM_HEADS), generator=gen, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype), mask, rel


def _attention_fns(tfa, mode):
    """(kernel path, plain version) of one attention, both as
    ``fn(q, k, v, mask, rel_bias)``."""
    h = NUM_HEADS
    if mode == tfa.ENCODER:
        return (lambda q, k, v, m, r: tfa.encoder_flash_attention(q, k, v, m, r, num_heads=h),
                lambda q, k, v, m, r: tfa.encoder_attention_reference(q, k, v, m, r, num_heads=h))
    if mode == tfa.CAUSAL:
        return (lambda q, k, v, m, r: tfa.causal_flash_attention(q, k, v, r, num_heads=h),
                lambda q, k, v, m, r: tfa.causal_attention_reference(q, k, v, r, num_heads=h))
    return (lambda q, k, v, m, r: tfa.cross_flash_attention(q, k, v, m, num_heads=h),
            lambda q, k, v, m, r: tfa.cross_attention_reference(q, k, v, m, num_heads=h))


def _valid_pairs(tfa, mode, mask, lq: int) -> int:
    """(query, key) pairs of one head that the attention keeps, summed over
    the batch: the work this run's data needs."""
    if mode == tfa.CAUSAL:
        return mask.shape[0] * lq * (lq + 1) // 2
    return lq * int(mask.sum().item())


def _bound(part: str, b: int, lq: int, lk: int, pairs: int, itemsize: int):
    """(least ms, "operations" or "bytes") of one kernel on the card: the
    larger of its FMA work (per kept pair and head: 4d forward, 6d dQ, 8d
    dK/dV operations) over the bf16 peak and of its bytes (each input read
    once, each output written once) over the memory rate."""
    inner = NUM_HEADS * HEAD_DIM
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[part] * HEAD_DIM * NUM_HEADS * pairs
    stats = 8 * b * NUM_HEADS * lq  # LSE and delta, fp32
    nbytes = {
        "fwd": itemsize * inner * 2 * (b * lq + b * lk) + 4 * b * lk,
        "dq": itemsize * inner * (3 * b * lq + 2 * b * lk) + 4 * b * lk + stats,
        "dkv": itemsize * inner * (2 * b * lq + 4 * b * lk) + 4 * b * lk + stats,
    }[part]
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _library(tfa, mode, q, k, v, mask, rel):
    """Inputs of one ``scaled_dot_product_attention`` call computing the same
    function: [B, H, L, d] views (leaves that require grad) and one float
    mask, the bias plus -inf at the pairs the attention drops. Timed as the
    library's yardstick only; the port never calls it."""
    import torch

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def heads(x):
        b, l, inner = x.shape
        return x.view(b, l, NUM_HEADS, inner // NUM_HEADS).transpose(1, 2)

    valid = tfa._valid(mode, mask, q)
    attn = torch.zeros(valid.shape, device=q.device).masked_fill(~valid, float("-inf"))
    if mode != tfa.CROSS:
        attn = attn + tfa._bucket_bias(rel, q.shape[1], mode == tfa.ENCODER, 32, 128)
    return leaves, [heads(t) for t in leaves], attn.to(q.dtype)


def _forward_row(tfa, mode, b, lq, lk, dtype, gen, device) -> dict:
    """The kernel's forward against its plain version (error, times) beside
    the library call and the bound."""
    import torch
    import torch.nn.functional as F

    q, k, v, mask, rel = _attention_case(b, lq, lk, dtype, gen, device, mode == tfa.CAUSAL)
    args = (q, k, v, mask, rel)
    kernel, plain = _attention_fns(tfa, mode)
    out, ref = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = FP32_TOL if dtype == torch.float32 else (
        BF16_REL_TOL * max(1.0, ref.float().abs().max().item()))
    finite = bool(torch.isfinite(out).all())
    iters = 20 if b * max(lq, lk) <= 32 * 1024 else 10
    _, qkv, attn = _library(tfa, mode, *args)
    with torch.no_grad():
        row = dict(kernel=tfa.KERNEL_NAMES[mode], B=b, Lq=lq, Lk=lk,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err, tol=tol,
                   ms=_time_ms(lambda: kernel(*args), iters),
                   plain_ms=_time_ms(lambda: plain(*args), iters),
                   library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                       *qkv, attn_mask=attn, scale=1.0), iters),
                   ok=finite and err <= tol)
    row["bound_ms"], row["bound_by"] = _bound(
        "fwd", b, lq, lk, _valid_pairs(tfa, mode, mask, lq), q.element_size())
    return row


def _backward_row(tfa, mode, b, lq, lk, dtype, gen, device, empty_row: bool) -> dict:
    """Autograd through the kernels against autograd of the plain version
    (errors), the whole backward, each backward kernel alone on the forward's
    LSE, the plain backward and the library call's autograd, and the two
    kernels' bounds. ``empty_row``: the last batch row has no valid key and
    must get zero gradients."""
    import torch
    import torch.nn.functional as F

    q, k, v, mask, rel = _attention_case(b, lq, lk, dtype, gen, device, mode == tfa.CAUSAL)
    if empty_row:
        mask[-1] = 0
    dout = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    kernel, plain = _attention_fns(tfa, mode)
    names = ("dq", "dk", "dv") if mode == tfa.CROSS else ("dq", "dk", "dv", "d_rel")

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rel)][: len(names)]
        full = leaves + [rel] * (4 - len(leaves))
        out = fn(full[0], full[1], full[2], mask, full[3])
        return out, leaves, torch.autograd.grad(out, leaves, dout, retain_graph=True)

    out_k, leaves_k, got = grads(kernel)
    out_p, leaves_p, want = grads(plain)
    torch.cuda.synchronize()
    errs, ok = {}, True
    for name, g, w in zip(names, got, want):
        tol = BF16_REL_TOL if dtype == torch.bfloat16 else (
            DREL_FP32_TOL if name == "d_rel" else FP32_TOL)
        tol *= max(1.0, w.float().abs().max().item())
        errs[name] = (g.float() - w.float()).abs().max().item()
        ok &= bool(torch.isfinite(g).all()) and errs[name] <= tol
    if empty_row:
        ok &= all(g[-1].abs().max().item() == 0.0 for g in got[:3])
    iters = 10 if b * max(lq, lk) <= 32 * 1024 else 5
    ms = _time_ms(lambda: torch.autograd.grad(out_k, leaves_k, dout, retain_graph=True), iters)
    plain_ms = _time_ms(lambda: torch.autograd.grad(out_p, leaves_p, dout, retain_graph=True),
                        iters)
    lib_leaves, qkv, attn = _library(tfa, mode, q, k, v, mask, rel)
    out_l = F.scaled_dot_product_attention(*qkv, attn_mask=attn, scale=1.0)
    dout_l = dout.view(b, lq, NUM_HEADS, HEAD_DIM).transpose(1, 2)
    library_ms = _time_ms(
        lambda: torch.autograd.grad(out_l, lib_leaves, dout_l, retain_graph=True), iters)
    # Each backward kernel alone, on the forward's LSE.
    md = 0 if mode == tfa.CROSS else 128
    kmask = mask if mode != tfa.CAUSAL else torch.ones_like(mask)
    mask32, rel32, table = tfa._kernel_operands(mode, kmask, rel, 32, 128)
    out, lse = tfa._forward_cuda(mode, q, k, v, mask32, rel32, table, NUM_HEADS, 128, True)
    delta = tfa.row_delta(dout, out, NUM_HEADS)
    bins = None if mode == tfa.CROSS else torch.zeros((NUM_HEADS, 2 * md + 1), device=device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (q, k, v, dout, mask32, rel32, table, lse, delta)
    dq_ms = _time_ms(lambda: tfa._backward_cuda(mode, "dq", *common, dq, bins, NUM_HEADS, 128),
                     iters)
    dkv_ms = _time_ms(lambda: tfa._backward_cuda(mode, "dkv", *common, dk, dv, NUM_HEADS, 128),
                      iters)
    pairs = _valid_pairs(tfa, mode, mask, lq)
    row = dict(kernel=tfa.KERNEL_NAMES[mode], B=b, Lq=lq, Lk=lk,
               dtype=str(dtype).replace("torch.", ""), errs=errs, ok=ok, bwd_ms=ms,
               plain_bwd_ms=plain_ms, library_bwd_ms=library_ms, dq_ms=dq_ms, dkv_ms=dkv_ms)
    row["dq_bound_ms"], row["dq_bound_by"] = _bound("dq", b, lq, lk, pairs, q.element_size())
    row["dkv_bound_ms"], row["dkv_bound_by"] = _bound("dkv", b, lq, lk, pairs, q.element_size())
    return row


def _check_rows(rows: list, what: str) -> None:
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{what} disagree with the plain version: {bad}")


def phase_kernel(device) -> list:
    """The encoder forward kernel against its plain version at
    ``KERNEL_SHAPES`` and the ragged case, fp32 and bf16."""
    import torch

    from reprover_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for b, l in KERNEL_SHAPES + [RAGGED_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            row = _forward_row(tfa, tfa.ENCODER, b, l, l, dtype, gen, device)
            log(f"[kernel] {json.dumps(row)}")
            rows.append(row)
    torch.cuda.empty_cache()
    _check_rows(rows, "the encoder kernel does")
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
    from reprover_tpu_torch.retrieval.datamodule import RetrievalDataModule

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
    """Autograd through the encoder kernels vs autograd of the plain version
    at the generator's [8, 2304], ``shapes``, the 1024 context cap and the
    ragged case, fp32 and bf16; times of the whole backward and of each
    backward kernel alone."""
    import torch

    from reprover_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(1)
    rows = []
    for b, l in [GEN_SHAPE, CONTEXT_CAP_SHAPE] + list(shapes) + [RAGGED_SHAPE]:
        for dtype in (torch.float32, torch.bfloat16):
            row = _backward_row(tfa, tfa.ENCODER, b, l, l, dtype, gen, device, empty_row=True)
            log(f"[kernel_bwd] {json.dumps(row)}")
            rows.append(row)
            torch.cuda.empty_cache()
    _check_rows(rows, "the encoder backward kernels")
    return rows


def phase_decoder_kernels(device) -> tuple:
    """The causal and cross kernels against their plain versions, forward and
    autograd backward, at ``CAUSAL_SHAPES`` and ``CROSS_SHAPES``, fp32 and
    bf16 -> (forward rows, backward rows)."""
    import torch

    from reprover_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(2)
    cases = [(tfa.CAUSAL, b, t, t) for b, t in CAUSAL_SHAPES] + [
        (tfa.CROSS, b, t, s) for b, t, s in CROSS_SHAPES]
    fwd, bwd = [], []
    for mode, b, lq, lk in cases:
        for dtype in (torch.float32, torch.bfloat16):
            row = _forward_row(tfa, mode, b, lq, lk, dtype, gen, device)
            log(f"[decoder_kernel] {json.dumps(row)}")
            fwd.append(row)
            # A ragged cross case also holds a source with no valid key.
            empty = mode == tfa.CROSS and b < 8
            row = _backward_row(tfa, mode, b, lq, lk, dtype, gen, device, empty_row=empty)
            log(f"[decoder_kernel_bwd] {json.dumps(row)}")
            bwd.append(row)
            torch.cuda.empty_cache()
    _check_rows(fwd, "the causal or cross forward kernels")
    _check_rows(bwd, "the causal or cross backward kernels")
    return fwd, bwd


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

    from reprover_tpu_torch.generation import TacticGeneratorModel
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.prover.environment import environment_from_dataset
    from reprover_tpu_torch.prover.evaluate import evaluate
    from reprover_tpu_torch.prover.service import InferenceService
    from reprover_tpu_torch.prover.tactic_generator import FixedTacticGenerator
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

    from reprover_tpu_torch.data import Context, Pos, format_augmented_state, remove_marks
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

    from reprover_tpu_torch.models.t5 import encode, place_params
    from reprover_tpu_torch.ops.flash_attention import encoder_attention_reference
    from reprover_tpu_torch.ops.pooling import masked_mean_normalize
    from reprover_tpu_torch.tokenizer import ByT5Tokenizer

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
    encoder = {k: n for k, n in launches.items() if k.startswith("encoder_attn")}
    if device.type == "cuda" and min(encoder.values()) < 1:
        raise AssertionError(f"training did not launch every encoder attention kernel: "
                             f"{launches}")

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


def _mark(cuda: bool):
    """A point in time: a recorded CUDA event on the card, else the host clock."""
    import torch

    if not cuda:
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _ms_between(a, b, cuda: bool) -> float:
    return a.elapsed_time(b) if cuda else 1e3 * (b - a)


def _timed_steps(state, loss_fn, model_cfg, batch: dict, n: int, device) -> list:
    """``n`` train steps on one batch; per step: (loss tensor, forward ms,
    backward ms, optimizer ms)."""
    cuda = device.type == "cuda"
    out = []
    for _ in range(n):
        m0 = _mark(cuda)
        state.optimizer.zero_grad()
        loss = loss_fn(state.params, model_cfg, batch)
        m1 = _mark(cuda)
        loss.backward()
        m2 = _mark(cuda)
        state.optimizer.step()
        m3 = _mark(cuda)
        _sync(device)
        out.append((loss.detach(), _ms_between(m0, m1, cuda), _ms_between(m1, m2, cuda),
                    _ms_between(m2, m3, cuda)))
    return out


_ATTN_KERNEL = re.compile(r"attn_(fwd|bwd_dq|bwd_dkv)_kernel<[^,>]+,\s*(\d)>")


def _attention_kernel_key(name: str):
    """The ``KERNEL_LAUNCHES`` key of a profiled CUDA kernel name, or None."""
    m = _ATTN_KERNEL.search(name)
    if m is None:
        return None
    base = ("encoder_attn", "causal_attn", "cross_attn")[int(m.group(2))]
    return base if m.group(1) == "fwd" else f"{base}_{m.group(1)}"


def _profiled_share(state, loss_fn, model_cfg, batch: dict, device) -> dict:
    """Device time of one profiled train step by kernel, and each attention
    kernel's share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _timed_steps(state, loss_fn, model_cfg, batch, 1, device)
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    except Exception as ex:  # the share is a report; a profiler failure is not a phase failure
        return {"profiler": f"not measured: {ex!r}"}
    total = sum(by_name.values())
    attn: dict = {}
    for name, us in by_name.items():
        key = _attention_kernel_key(name)
        if key is not None:
            attn[key] = attn.get(key, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(device_ms=total / 1e3, attention_ms=sum(attn.values()) / 1e3,
                attention_share=sum(attn.values()) / total if total else None,
                attention_kernels_ms={n: us / 1e3 for n, us in sorted(attn.items())},
                attention_kernels_share={n: us / total for n, us in sorted(attn.items())}
                if total else None,
                top_kernels_ms={n[:70]: us / 1e3 for n, us in top})


def _step_report(tag: str, state, loss_fn, model_cfg, tensors: dict, steps: int, device,
                 **labels) -> dict:
    """Time ``steps`` steps on one batch (means over steps 3..), peak memory
    and a profiled step's attention share; logs and returns the row, which
    starts with ``labels``."""
    import torch

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    timed = _timed_steps(state, loss_fn, model_cfg, tensors, steps, device)
    losses = [float(s[0]) for s in timed]
    warm = timed[2:]
    row = dict(**labels, shapes={k: list(v.shape) for k, v in tensors.items()
                                 if k.endswith("_ids")},
               first_loss=losses[0], last_loss=losses[-1], losses=losses,
               forward_ms=sum(s[1] for s in warm) / len(warm),
               backward_ms=sum(s[2] for s in warm) / len(warm),
               optimizer_ms=sum(s[3] for s in warm) / len(warm))
    row["step_ms"] = row["forward_ms"] + row["backward_ms"] + row["optimizer_ms"]
    row["steps_per_sec"] = 1e3 / row["step_ms"]
    if cuda:
        row["max_memory_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        row.update(_profiled_share(state, loss_fn, model_cfg, tensors, device))
    log(f"[{tag}] {json.dumps(row)}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss on the fixed batch: {losses}")
    return row


def phase_train_steps(device, bench: str, tiny: bool = False) -> dict:
    """One fixed batch, no warmup: 20 steps whose loss must fall, each timed
    by part; peak memory; the attention kernels' share of a profiled step.
    Then the same timing on the batch's layout at the 1024 cap."""
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
    results = {}
    for name, hb in (("data", host_batch), ("cap", _long_batch(host_batch, TRAIN["seed"]))):
        row = _step_report("train_step", state, retrieval_infonce_loss, model_cfg,
                           numeric_batch(hb, device), TRAIN["steps"] if name == "data" else 5,
                           device, batch=name)
        losses = row["losses"]
        if name == "data":
            log(f"[train_step] repeated batch, lr {TRAIN['lr']} without warmup: loss "
                f"{losses[0]:.6f} -> {losses[-1]:.6f} over {len(losses)} steps")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"the loss on one fixed batch did not fall: {losses}")
        results[name] = row
    return results


def _gen_argv(device, work: str, bench: str, preds: str, tiny: bool) -> list:
    """``generation.main`` flags of the generator phase: the reference data
    settings, remat on, seeded random init (or the tiny model), greedy
    validation on one batch."""
    return [
        "--device", device.type,
        "--model.tiny" if tiny else "--model.random_init", "true",
        "--model.remat", "true",
        "--model.num_beams", "1",
        "--data.data_path", os.path.join(bench, "random"),
        "--data.corpus_path", os.path.join(bench, "corpus.jsonl"),
        "--data.preds_path", preds,
        "--data.batch_size", str(GEN["batch_size"]),
        "--data.eval_batch_size", str(GEN["eval_batch_size"]),
        "--data.max_inp_seq_len", str(GEN["max_inp_seq_len"]),
        "--data.max_oup_seq_len", str(GEN["max_oup_seq_len"]),
        "--limit_val_batches", "1",
        "--seed", str(GEN["seed"]),
        "--log_dir", os.path.join(work, "glogs"),
    ]


def phase_generator_train(device, work: str, bench: str, tiny: bool = False) -> dict:
    """Retriever predictions from phase 7's checkpoint, then generator
    training through the CLI entry point: 20 steps, one validation and a
    checkpoint, then ``validate --ckpt_dir`` restoring the checkpoint."""
    import torch

    from reprover_tpu_torch.generation.datamodule import GeneratorDataModule
    from reprover_tpu_torch.generation.main import main as generation_main
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.retrieval.main import main as retrieval_main

    t0 = time.perf_counter()
    # 40 premises per tactic: the synthetic corpus's first files see only 43
    # accessible premises (the reference retrieves 100 from Mathlib).
    records = retrieval_main(["predict"] + _fit_argv(device, work, bench, tiny) + [
        "--ckpt_dir", os.path.join(work, "ckpts"), "--preds_out", "predictions.pickle",
        "--model.num_retrieved", "40"])
    preds = os.path.join(work, "logs", "predictions.pickle")
    log(f"[gen_train] retrieval.main predict: {len(records)} records in "
        f"{time.perf_counter() - t0:.3f}s -> {preds}")

    dm = GeneratorDataModule(os.path.join(bench, "random"), GEN["batch_size"],
                             GEN["eval_batch_size"], GEN["max_inp_seq_len"],
                             GEN["max_oup_seq_len"], 0.5, preds_path=preds, seed=GEN["seed"])
    dm.setup("fit")
    shapes = sorted({(tuple(b["state_ids"].shape), tuple(b["tactic_ids"].shape))
                     for _, b in zip(range(GEN["steps"]), dm.train_dataloader())})
    log(f"[gen_train] train batches (state_ids, tactic_ids) shapes: {shapes}")

    ckpt = os.path.join(work, "gckpts")
    argv = _gen_argv(device, work, bench, preds, tiny) + [
        "--trainer.max_steps", str(GEN["steps"]),
        "--trainer.val_interval", str(GEN["steps"]),
        "--trainer.log_interval", str(GEN["log_interval"]),
        "--trainer.monitor", "loss_val",
        "--trainer.monitor_mode", "min",
        "--trainer.patience", "99",
        "--trainer.ckpt_dir", ckpt,
    ]
    tfa.reset_launch_counts()
    t0 = time.perf_counter()
    state = generation_main(["fit"] + argv)
    _sync(device)
    fit_s = time.perf_counter() - t0
    launches = dict(tfa.KERNEL_LAUNCHES)
    with open(os.path.join(work, "glogs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    sps = [r["steps_per_sec"] for r in recs if "steps_per_sec" in r]
    val = [r for r in recs if "loss_val" in r]
    log(f"[gen_train] fit {state.step} steps in {fit_s:.3f}s (validation and checkpoint "
        f"included); losses {losses}; steps/s per {GEN['log_interval']}-step window {sps}; "
        f"kernel launches {launches}")
    if val:
        log(f"[gen_train] validation {json.dumps(val[-1])}")
    if state.step != GEN["steps"] or len(losses) != GEN["steps"] // GEN["log_interval"]:
        raise AssertionError(f"fit ran {state.step} steps and logged {len(losses)} losses")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not val or "top1_acc_val" not in val[-1] or not math.isfinite(val[-1]["loss_val"]):
        raise AssertionError("metrics.jsonl lacks a finite loss_val and top1_acc_val")
    if device.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"generator training did not launch every attention kernel: "
                             f"{launches}")

    saved = torch.load(os.path.join(ckpt, str(GEN["steps"]), "state.pt"),
                       map_location="cpu", weights_only=True)["params"]
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _, model = generation_main(["validate"] + argv + ["--ckpt_dir", ckpt])
    mismatched = [name for name, t in _flat(model.params).items()
                  if not torch.equal(t.detach().cpu(), _flat(saved)[name])]
    if mismatched:
        raise AssertionError(f"validate --ckpt_dir restored different parameters: {mismatched}")
    log(f"[gen_train] validate --ckpt_dir restored {len(_flat(saved))} parameter tensors "
        f"bit-equal")
    return dict(launches=launches, losses=losses, steps_per_sec=sps, fit_s=fit_s,
                validation=val[-1], shapes=shapes)


def phase_generator_steps(device, tiny: bool = False) -> dict:
    """One fixed random batch at the reference cap ([8, 2304] sources, [8,
    512] targets, ragged, -100 past each target), no warmup: 20 steps whose
    loss must fall, timed by part, peak memory and each attention kernel's
    share of a profiled step."""
    import numpy as np
    import torch

    from reprover_tpu_torch.models.t5 import (
        T5Config, byt5_small, default_dtype, fuse_mlp_params, init_params, place_master_params,
    )
    from reprover_tpu_torch.training.tasks import generation_loss, init_train_state

    dtype = default_dtype(device)
    if tiny:
        cfg = T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                       num_decoder_layers=1, compute_dtype=dtype, remat=True)
    else:
        cfg = byt5_small(compute_dtype=dtype, remat=True)
    params = init_params(cfg, torch.Generator().manual_seed(GEN["seed"]))
    state = init_train_state(place_master_params(fuse_mlp_params(params), device), GEN["lr"],
                             warmup_steps=0)
    del params
    rng = np.random.default_rng(GEN["seed"])
    b, src, tgt = GEN["batch_size"], GEN_SHAPE[1], GEN["max_oup_seq_len"]
    src_len = rng.integers(src // 2, GEN["max_inp_seq_len"] + 1, b)
    tgt_len = rng.integers(tgt // 8, tgt + 1, b)
    src_mask = (np.arange(src)[None, :] < src_len[:, None]).astype(np.int64)
    tactic = rng.integers(3, 259, (b, tgt))
    tactic[np.arange(tgt)[None, :] >= tgt_len[:, None]] = -100
    batch = {"state_ids": torch.from_numpy(rng.integers(3, 259, (b, src)) * src_mask),
             "state_mask": torch.from_numpy(src_mask), "tactic_ids": torch.from_numpy(tactic)}
    batch = {k: v.to(device) for k, v in batch.items()}
    row = _step_report("gen_step", state, generation_loss, cfg, batch, GEN["steps"], device)
    losses = row["losses"]
    log(f"[gen_step] repeated batch, lr {GEN['lr']} without warmup: loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f} over {len(losses)} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss on one fixed batch did not fall: {losses}")
    return row


# The TPU kernel each of the nine replaces (file:line of its pallas_call or
# kernel function in the JAX package).
REPLACES = {
    "encoder_attn": "reprover_tpu/ops/flash_attention.py:176",
    "encoder_attn_bwd_dq": "reprover_tpu/ops/flash_attention.py:607",
    "encoder_attn_bwd_dkv": "reprover_tpu/ops/flash_attention.py:715",
    "causal_attn": "reprover_tpu/ops/flash_attention.py:1553",
    "causal_attn_bwd_dq": "reprover_tpu/ops/flash_attention.py:1343",
    "causal_attn_bwd_dkv": "reprover_tpu/ops/flash_attention.py:1384",
    "cross_attn": "reprover_tpu/ops/flash_attention.py:1624",
    "cross_attn_bwd_dq": "reprover_tpu/ops/flash_attention.py:1721",
    "cross_attn_bwd_dkv": "reprover_tpu/ops/flash_attention.py:1757",
}


def kernel_entries(fwd_rows: list, bwd_rows: list, launches: dict) -> list:
    """The ``{"kernels": [...]}`` entries: per kernel its launches on the main
    paths, its largest bf16 error over every checked shape, and its times,
    bound and library time at the generator-training shapes (encoder [8,
    2304], causal [8, 512], cross [8, 512] x [8, 2304]), bf16."""
    main_shape = {"encoder_attn": (8, 2304, 2304), "causal_attn": (8, 512, 512),
                  "cross_attn": (8, 512, 2304)}
    entries = []
    for name, replaces in REPLACES.items():
        base, part = (name, "fwd") if "_bwd_" not in name else name.split("_bwd_")
        rows = bwd_rows if part != "fwd" else fwd_rows
        mine = [r for r in rows if r["kernel"] == base and r["dtype"] == "bfloat16"]
        at = next(r for r in mine if (r["B"], r["Lq"], r["Lk"]) == main_shape[base])
        if part == "fwd":
            err = max(r["max_abs_err"] for r in mine)
            times = (at["ms"], at["plain_ms"], at["bound_ms"], at["bound_by"], at["library_ms"])
        else:
            keys = ("dq", "d_rel") if part == "dq" else ("dk", "dv")
            err = max(r["errs"][k] for r in mine for k in keys if k in r["errs"])
            times = (at[f"{part}_ms"], at["plain_bwd_ms"], at[f"{part}_bound_ms"],
                     at[f"{part}_bound_by"], at["library_bwd_ms"])
        source = "encoder_attn.cu" if part == "fwd" else "encoder_attn_bwd.cu"
        entries.append({"name": name, "route": "cuda",
                        "source": f"reprover_tpu_torch/csrc/{source}", "replaces": replaces,
                        "launches": launches[name], "max_abs_err": err, "ms": times[0],
                        "plain_ms": times[1], "bound_ms": times[2], "bound_by": times[3],
                        "library_ms": times[4]})
    return entries


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
    dec_fwd, dec_bwd = phase_decoder_kernels(device)
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
        torch.cuda.empty_cache()
        gt = phase_generator_train(device, work, bench)
        torch.cuda.empty_cache()
        phase_generator_steps(device)
    log(f"[smoke] wall time {time.perf_counter() - t_start:.1f}s")

    # Launches on the three main paths: serving, retriever and generator training.
    launches = {name: tr["launches"][name] + gt["launches"][name] for name in REPLACES}
    launches["encoder_attn"] += sl["launches"]
    print(json.dumps({"kernels": kernel_entries(rows + dec_fwd, bwd_rows + dec_bwd, launches)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
