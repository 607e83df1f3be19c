"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compiles the port's CUDA kernels from ``reprover_tpu_torch/csrc``
   (each attention forward, dQ and dK/dV instantiation's and each
   quantized-product body's registers, stack and spills from ``-Xptxas
   -v`` on ``[build]`` lines; a bf16 backward instantiation or a decode or
   admission body that spills fails), then reads the library's machine
   code (``cuobjdump -sass``, ``[sass]``): every bf16 forward, dQ and
   dK/dV instantiation and every decode and admission body of kernels
   11/12 must hold HGMMA (tensor-core) instructions with fewer waits than
   HGMMAs (not serialized) and every fp32 attention one none;
3. kernel vs plain: ``encoder_flash_attention`` against
   ``encoder_attention_reference`` on the card at byt5-small attention
   shapes (H=6, d=64), ragged masks, a masked key >= 100 above its row's
   valid scores, and a length that is not a multiple of 64; fp32 within
   1e-4, bf16 within 2e-2 * max(1, max|ref|) and each (row, head) within
   2e-2 of its own max|ref| (``row_error``); times from CUDA events;
3b. fused elementwise kernels vs plain (``[fused]``): ``add_rms_norm``
   (with and without the residual) at [64, L, 1472] for L in 1, 33, 257,
   1024 and the engine's [1024, 1, 1472] decode rows, and ``gated_gelu`` on
   the halves of the fused ``wi`` product ([64 x 257, 7168], [64 x 1024,
   7168], [1024, 7168]), on separate ``wi_0`` / ``wi_1`` products and at a
   TP 2 shard's width 1792: ``h_new`` bit-equal to the bf16 add, every row
   within one bf16 rounding of the float32 (GELU: float64) reference
   (``fused_row_excess``), one launch a call; then both at [64, 1024]
   beside their bytes bound and the plain chains
   (``kernel_timing.time_fused``);
4. the slice: a synthetic LeanDojo-format benchmark (12,900 premises),
   the port's retriever and generator at full byt5-small width (bf16,
   seeded random weights), ``reindex_corpus``, then the reused
   ``evaluate`` with two prover worker processes served by the reused
   ``InferenceService``; the kernel's launch count over this phase must be
   positive;
4b. diverse beam search (``[diverse]``): ``beam_search`` with
   ``num_beam_groups``/``diversity_penalty`` on a seeded fp32 logits table
   (position x last token, values rounded to 0.1 so candidates tie) at B 2,
   V 384, (K, G, penalty) (64, 4, 1.0), (64, 16, 0.5), (8, 8, 2.0), on the
   card against the CPU: tokens and lengths equal, scores within 1e-5
   (absolute and relative); then
   the phase-4 generator over the first val theorem's packed source at 64
   beams, decode cut to 128: the classic call, one group bit-equal to it,
   4 groups at penalty 1.0 with finite descending scores; ms per step,
   distinct sequences and kernel 1's launches;
5. numeric sanity: 16 premises embedded on the card in bf16 through the
   kernel and in fp32 through the plain version agree to a per-row cosine
   >= 0.99.

6. kernel backward vs plain: the encoder attention's autograd (forward
   kernel + the dQ and dK/dV kernels) against autograd of
   ``encoder_attention_reference``, H=6, d=64, at the training shapes (the
   data module's batches at ``max_seq_len`` 1024, printed, and contexts at
   the 1024 cap), ragged masks, an empty row, a masked key >= 100 above its
   row and a length that is not a multiple of 64; fp32 within 1e-4 (d_rel
   1e-3) and bf16 within 2e-2 of max(1, max|ref|), bf16 dq, dk, dv also
   row by row (``grad_row_error``: each (row, position, head) within 2e-2
   of its own max|ref| plus 2e-3 of max(1, max|ref|), against the
   backward's algorithm in plain torch, ``plain_grad_chain``); times from
   CUDA events;
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
   max(1, max|ref|) (the forward also row by row, ``row_error``, the
   gradients by ``grad_row_error``); times from CUDA events, beside one
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
    each attention kernel's share of a profiled step;
12. serving kernels vs plain: the beam-reorder kernel at the byt5-small
    and LLaMA-7B engine caches (``T_live`` T and T/4, and T/8 for
    byt5-small; a frozen slot, int64 indices), bit-equal to its plain
    version by default and with each of its branches forced, one kernel
    launched a call; the w8a16 and w4a16 kernels at every
    routed LLaMA-7B weight shape at decode (M = 32) and admission rows,
    bf16 within 2e-2 * max(1, max|ref|), every output row within 2e-2 of
    its own max|ref|, two launches bit-equal, each on a tensor-core body;
    times from CUDA events around host-paced calls (and the products'
    device time, queued behind a device sleep) beside the bound, the plain
    version and a library
    yardstick (``index_select`` + the column write; dequantize +
    ``torch.matmul``), PyTorch's ``_weight_int4pack_mm`` /
    ``_weight_int8pack_mm`` as readings, and the engine's einsum and scan
    reorders;
13. byt5-small streaming: the phase-4 benchmark and settings through
    ``StreamingInferenceService`` (the ``evaluate --streaming`` flags, the
    beam reorder by the kernel) to two prover workers, the engine's ms/step
    with a profiled chunk, and one state in fp32 through the engine and the
    classic ``generate``: the same tactics, scores within rtol 1e-4;
14. LLaMA-7B: seeded random weights at full ``CausalLMConfig`` width made
    on the card one layer at a time and quantized to int4, a BPE tokenizer
    trained on the synthetic corpus, the streaming service (4 slots x 8
    beams, prompts 512, decode 129) answering two client threads, timed and
    profiled engine chunks (kernel 12's device ms per step), where each
    weight routes, weight bytes and peak memory; then the same weights in
    int8 through one admission wave; every quantized product on a
    tensor-core body;
15. long-route kernels vs plain: kernels 2, 5, 6 and 7 (the KV-blocked
    long-context route past 4096, or with ``block_kv``) in the three modes,
    fp32 and bf16, at encoder [4, 8192], [2, 4608] and a ragged [3, 4141],
    causal [2, 4608] and [1, 4141], cross [4, 512] x [4, 8192] and [3, 200]
    x [3, 4141], and ``block_kv`` at [8, 2304]: ragged masks, a fully masked
    tail tile, an encoder row with no valid key, each kernel alone and the
    whole autograd backward against the plain versions (at encoder [2,
    4608] fp32 also against the full-row reference's per-pair bias and its
    autograd), fp32 within 1e-4
    (d_rel 1e-3), bf16 within 2e-2 of max(1, max|ref|), its output also
    row by row (``row_error``), its gradients by ``grad_row_error`` and its
    LSE within 1e-2; bf16 times beside the plain versions,
    ``scaled_dot_product_attention`` with a dense bias mask and the bounds;
16. long serving: the phase-4 models behind ``InferenceService`` at
    ``max_inp_seq_len`` 8192, 4 theorems x 2 expansions; every served
    source packs its 100 retrieved premises past 4096 bytes, at least two
    batches are served and kernel 2 must launch; s/request over all
    requests, the padded encoder shape of each batch and one source's
    encode ms;
17. long generator training: ``retrieval.main predict`` (100 premises)
    on a second synthetic benchmark whose premises have Mathlib-like
    lengths, then ``generation.main fit`` at ``--data.max_inp_seq_len 8192
    --data.batch_size 4`` (remat full, bf16 over fp32 masters) for 12
    steps, one validation batch and a checkpoint; every loss finite, the
    encoder and cross modes of kernels 2, 5, 6 and 7 launched;
18. long train step: one fixed random batch at [4, 8192] -> [4, 512],
    ragged, 20 steps whose loss must fall, timed by part, peak memory and
    each attention kernel's share of a profiled step;
19. scaled causal kernels vs plain: ``scaled_causal_flash_attention``'s
    kernels (1s forward, 3s dQ, 4s dK/dV; on the long route 2, 5, 6, 7 in
    this mode) against their plain versions: the forward, the LSE, each
    backward kernel alone and the whole autograd backward, at LLaMA-7B
    width [4, 2048] x 32 heads x 128, a ragged [3, 1000] with a
    left-padded row (whose query has no valid key: 0 and zero gradients),
    the JAX benchmark's [8, 2048] x 16 x 64, and the long route at [2, 4608] x
    4 x 128; fp32 within 1e-4, bf16 within 2e-2 of max(1, max|ref|), its
    output also row by row (``row_error``), its gradients by
    ``grad_row_error`` and its LSE within 1e-2; bf16 times beside the plain
    versions, ``scaled_dot_product_attention`` with the causal-and-key
    boolean mask (and, as readings, with ``is_causal=True`` alone, forward
    and autograd backward) and the bounds;
20. decoder-only fine-tuning at LLaMA-7B width cut to depth 4 of 32
    (seeded float32 masters made on the card, bf16 products,
    ``flash_attention`` on): ``CausalGeneratorDataModule`` batches of the
    phase-4 benchmark with phase 10's ``predictions.pickle`` (a BPE
    tokenizer trained on the corpus, up to 2048 tokens, padded to multiples
    of 128), 20 ``make_train_step`` steps over ``causal_lm_loss``, every
    loss finite and the three scaled causal kernels launched; then
    ``causal_validation_metrics`` on one validation batch (greedy);
21. fine-tuning step: ``benchmarks/causal_finetune_step.py``'s fixed ragged
    batch at [4, 2048] (LLaMA-7B width, depth 4) and at the JAX benchmark's
    geometry [8, 2048], plain attention and flash, 10 steps each whose loss
    must fall, first losses within 2e-2 relative; timed by part, peak
    memory, the attention kernels' share of a profiled flash step;
22. kernel 14: the ablation variants of kernel 1
    (``benchmarks/flash_kernel_bisect.py``) against their plain versions at
    [2, 512], ``full`` bit-equal to kernel 1, then the harness's default
    sweep at [64, 1024] x 6 x 64, 12 layers;
23. remat policies: the fixed steps of phases 11 and 18 ([8, 2304] ->
    [8, 512], [4, 8192] -> [4, 512]) and phase 8's retriever step at the
    cap [40, 1024], from one seeded byt5-small init, 6 steps under each of
    remat ``full``, ``lite`` and ``offload``, then 4 under ``full`` with
    Adam's moments in host memory (``offload_optimizer``): forward /
    backward / optimizer ms per step (CUDA events), peak GiB and each
    attention kernel's launches in the first step. Fails unless each
    forward kernel of the route (1, 1c, 8; 2 on the long route) launches
    once per layer per step under ``lite`` and ``offload`` and twice under
    ``full``, the backward kernels once per layer, the first-step losses
    are bit-equal across the policies, every gradient leaf after one step
    lies within 2e-2 of ``full``'s relative to max(1, max|ref|), the losses
    are finite and fall, and with ``offload_optimizer`` the parameters are
    bit-equal to the on-device optimizer's on the same gradients while the
    peak falls by at least half the moments' bytes;
24. pretraining: ``reprover_tpu_torch.training.pretrain.main(["fit",
    ...])`` on the phase-4 corpus at byt5-small width and its defaults
    ([8, 1024] -> [8, 256]), remat ``lite``, 20 steps, one validation,
    ``--export_dir``: every loss finite, ``loss_val``, ``emb_eff_rank`` and
    ``cos_offdiag_std`` logged, the nine full-row kernels launched, the
    export reloaded through the port's ``load_hf_t5`` with ``safetensors``
    unimportable, bit-equal; ``generation.main fit --model.model_name
    <export>`` for 2 steps on phase 10's data; then 5 pretraining steps
    with remat ``offload`` and ``offload_optimizer``; ms per step and peak
    GiB of each run;
25. the evaluation harnesses: ``retrieval.evaluate`` on phase 10's
    predictions (R@1, R@10, MRR per split, finite and in range); the val
    split predicted again at phase 7's 100 premises, its R@10 and MRR within
    0.5 points and 0.005 of phase 7's logged validation; the BM25 baseline
    (``retrieval.bm25 train-tokenizer``/``retrieve``, a pool of 4) scored
    beside it; ``scripts.convert_checkpoint retriever`` on phase 7's
    checkpoint reloaded by ``load_hf_t5``, parameters and a batch of
    embeddings through kernel 1 bit-equal; ``indexer.main`` on one card over
    it (batch 64, ``max_seq_len`` 1024) and the val queries through
    ``PremiseRetriever.load_hf`` over that artifact;
26. failure attribution of phase 4's failed theorems through the card's
    retrieval-augmented generator (64 samples): the bucket table, counts
    summing to the traced failures, kernel 1 launched, a second run's
    records identical;
27. the port's service load driver at byt5-small width, streaming, 16
    workers x 8 slots x 64 beams, input 512, output 128, 8 / 16 theorems, at
    environment latency 0 (3 expansions a search) and 2.0 s a tactic (1
    expansion, 8 beams): expansions/s, the service's stats, the device-busy
    share of a profiled window naming the encoder and reorder kernels, kernel 13
    launched, every search at its expansions;
28. data-parallel training, two ranks sharing the card over gloo (one
    spawn): ``dp_retriever`` (``retrieval.main fit`` at byt5-small width,
    batch 8 split over the ranks, 3 steps without warmup, one validation)
    and ``dp_generator`` (``generation.main fit`` on phase 10's
    predictions, the ranks' rows with unequal valid-token counts), each
    against the same fit on one rank in this process: the loss at every
    step (2e-2 of itself plus 2e-3 of max(1, |loss|)), the parameters'
    updates after the last step (summed absolute difference within 5% of
    the one-rank update's), the validation (R@10 within 5 points, one of
    the 23 validation contexts; ``loss_val`` as the loss), the checkpoint's
    moments in the one-card layout, each rank's moment bytes at most 0.55
    of the one-rank run's and every kernel of the task's path launched on
    every rank, with both runs' ms per step and the gradient reduction's
    ms; ``dp_dryrun``: ``benchmarks/multichip_dryrun.py``'s checks on the
    same two ranks, and which collectives gloo runs on CUDA tensors;
    ``dp_indexer``: each rank calls ``indexer.main`` in the two ranks'
    gloo group over phase 25's converted retriever and the corpus, held
    against phase 25's one-card index (``indexer.main`` in this process):
    one artifact, the one card's corpus, embeddings within 1e-6, the same
    top-10 of the val states; premises/s of both, the gather's ms (one
    all-reduce of the index's bytes, timed alone) and bytes, kernel 1's
    launches a rank.
29. tensor parallelism at TP 2, two ranks sharing the card over gloo (one
    spawn, ``phase_tensor_parallel``): kernels 11/12 at each rank's shard of
    every LLaMA-7B product (decode and admission rows) and kernel 13 at the
    sharded caches against their plain versions (``[tp_kernel]``);
    byt5-small served through ``serve_tensor_parallel`` (the leader's
    ``StreamingInferenceService``, the other rank following): 2 requests,
    64 beams, inputs <= 2048 bytes, decode cut to 64 tokens, both ranks'
    beams bit-equal, and one fp32 request whose encoder output and first
    log-probs are within 1e-4 of one rank's (the beams' equal share
    printed); LLaMA-7B width at depth 4 in int4 and int8, each rank routing
    as one card, every quantized product on a tensor-core body, half the
    split weights' bytes; ``make_train_step`` tensor-parallel at (1, 2)
    for the generator at [2, 1024] -> [2, 256] and the depth-4 LLaMA
    fine-tuning at [2, 1024], 3 steps each, losses within the bf16 limit
    of one rank's and the replicated leaves bit-equal across the ranks;
    the multichip dry run's tensor- and sequence-parallel checks; and on a
    ``seq`` axis of the same two ranks (``[sp]``) ``encode_sequence_parallel``
    at byt5-small width, 12 layers, [2, 16384] with row 1's second shard
    all padding: fp32 within 1e-4 of one card's ``encode`` (kernel 2's long
    route) overall and row by row and finite, bf16 with a per-row cosine
    >= 0.99 against one card's bf16 ``encode``, the bf16 ring's ms per
    encode, peak GiB and ring-shift ms on each rank.

The line before the last is ``{"kernels": [...]}`` (the 38 kernels, with
their launches on the main paths: serving, retriever training, generator
training, the remat policies' steps, pretraining and the fine-tuning from
its export, the evaluation harnesses, attribution and the load driver,
streaming byt5-small, LLaMA-7B int4 and int8, long serving,
long generator training and decoder-only fine-tuning (the causal and scaled
causal long-route kernels run in phases 15 and 19 only: no path's sequence
passes 4096), kernel 14's in its sweep; and their times, bounds and
library times at the generator-training shapes, the LLaMA-7B decode shapes
for the serving kernels (kernels 11/12 also at the admission rows,
``admission_*``), [4, 8192] for the long route, [4, 2048] x 32 x 128 for
the scaled causal kernels, [64, 1024] for kernel 14 and [64, 1024] rows
of byt5-small's widths for the fused elementwise kernels, whose launches
are every phase's but phase 3b's); the last
line is ``{"ok": true, "device": {...}}``. Without a card the script exits
2 and prints no result.

The phases run in a child process; this process waits for it, and when it
ends, however it ends (or this one is told to stop), kills every process
that the run left behind (prover workers, ranks) and names them on
standard error. The exit code is the child's.

Rehearse the training phases on the CPU at tiny width (a minute)::

    import chip_smoke, torch
    work = "smoke"  # any scratch directory
    bench = chip_smoke.make_bench(work)
    chip_smoke.phase_train(torch.device("cpu"), work, bench, tiny=True)
    chip_smoke.phase_train_steps(torch.device("cpu"), bench, tiny=True)
    chip_smoke.phase_generator_train(torch.device("cpu"), work, bench, tiny=True)
    chip_smoke.phase_generator_steps(torch.device("cpu"), tiny=True)
    long_bench = chip_smoke.make_bench(work, long=True)
    chip_smoke.phase_generator_train(torch.device("cpu"), work, long_bench, tiny=True,
                                     gen=chip_smoke.LONG_GEN)

the remat phase (~6 min; its long step is left out at the tiny width) and
the pretraining phase (~1 min; it needs ``phase_train``'s checkpoint and the
``retrieval.main predict`` that ``phase_generator_train`` runs)::

    chip_smoke.phase_remat(torch.device("cpu"), tiny=True)
    chip_smoke.phase_pretrain(torch.device("cpu"), work, bench, tiny=True)

and the streaming phases (a minute): shrink ``SLICE`` (e.g. 4 beams, 256
input bytes, 12 output bytes, 2 theorems) and ``STREAM``, build a tiny
``T5Config`` generator and retriever on the CPU, then
``phase_streaming(cpu, bench, cfg, gen_params, ret_params)`` and
``phase_llama(cpu, bench, tiny=True)``. Run it from a script with an
``if __name__ == "__main__"`` guard: the prover workers are spawned.
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import statistics
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
# The fused elementwise kernels (phase 3b): the norm's [B, L, d_model] at
# the re-index batch and the engine's decode rows (16 slots x 64 beams);
# the gated GELU's (rows, d_ff, halves of one wi product) at those rows,
# on separate products and at a TP 2 shard's width; times at FUSED_MAIN.
FUSED_NORM_SHAPES = [(64, 1, 1472), (64, 33, 1472), (64, 257, 1472), (64, 1024, 1472),
                     (1024, 1, 1472)]
FUSED_GELU_CASES = [(64 * 257, 3584, True), (64 * 1024, 3584, True), (1024, 3584, True),
                    (64 * 257, 3584, False), (64 * 257, 1792, True), (64 * 33, 1792, False)]
FUSED_MAIN = (64, 1024)
FUSED_EPS = 1e-6
NUM_HEADS, HEAD_DIM = 6, 64
FP32_TOL = 1e-4
BF16_REL_TOL = 2e-2
DREL_FP32_TOL = 1e-3  # d_rel sums L^2 terms with atomics, in any order
BF16_LSE_TOL = 1e-2  # absolute: the LSE is an fp32 sum of fp32 scores

# Retriever training at the reference data settings.
TRAIN = dict(batch_size=8, num_negatives=3, num_in_file_negatives=1, max_seq_len=1024,
             eval_batch_size=64, steps=20, log_interval=5, lr=1e-4, seed=3407)
CONTEXT_CAP_SHAPE = (TRAIN["batch_size"], TRAIN["max_seq_len"])  # contexts at the length cap

# Generator training at the reference data settings
# (confs/generation_lean4_random.yaml), cut to 20 steps and one val batch.
GEN = dict(batch_size=8, eval_batch_size=64, max_inp_seq_len=2300, max_oup_seq_len=512,
           steps=20, log_interval=5, lr=1e-4, seed=3407, num_retrieved=40, shape=GEN_SHAPE,
           fixed_steps=20, tag="gen")
# (B, T) causal and (B, T, S) cross shapes: the generator's decoder at the
# 512 cap over 2304-byte sources, and ragged cases.
CAUSAL_SHAPES = [(8, 512), (3, 200)]
CROSS_SHAPES = [(8, 512, 2304), (3, 200, 1000)]

# The long route (kernels 2, 5, 6, 7): (mode, B, Lq, Lk, block_kv) checked
# against the plain versions. Encoder [4, 8192] and cross [4, 512] x [4,
# 8192] are the long train step's calls (their bf16 times are the kernels
# line's); [2, 4608] and causal are past the 4096 switch; 4141 is not a
# multiple of the 64-wide tile; block_kv takes the route at [8, 2304].
# At LONG_PAIR_CHECK (B, L) the fp32 encoder case is also held to the
# full-row reference, whose bias is per pair and not per 64-tile.
LONG_CASES = [("encoder", 4, 8192, 8192, 0), ("encoder", 2, 4608, 4608, 0),
              ("encoder", 3, 4141, 4141, 0), ("causal", 2, 4608, 4608, 0),
              ("causal", 1, 4141, 4141, 0), ("cross", 4, 512, 8192, 0),
              ("cross", 3, 200, 4141, 0), ("encoder", 8, 2304, 2304, 512)]
LONG_PAIR_CHECK = (2, 4608)
LONG_MAIN = {"encoder_attn": (4, 8192, 8192), "causal_attn": (2, 4608, 4608),
             "cross_attn": (4, 512, 8192)}
# Long-context generator training: sources packed with 100 retrieved
# premises up to 8192 bytes, batch 4, targets up to 512, 12 steps, one
# validation batch of 8; the fixed step at [4, 8192] -> [4, 512] (the
# geometry of benchmarks/genstep_profile.py's 8k run). Long serving: the
# served sources packed up to 8192 bytes, 4 theorems (8 before phase 29
# was added), up to 2 expansions each (phase 4's depth), so several batches
# of different padded lengths are served.
LONG_GEN = dict(GEN, batch_size=4, eval_batch_size=8, max_inp_seq_len=8192, steps=12,
                log_interval=4, num_retrieved=100, shape=(4, 8192), tag="long_gen")
LONG_SERVE = dict(max_inp_seq_len=8192, num_theorems=4, max_expansions=2)
# The KERNEL_LAUNCHES names of the full-row kernels (every one runs in
# generator training at 2300 bytes) and of the long route's kernels that
# generator training at 8192 bytes runs (the causal mode's only at T > 4096).
ATTENTIONS = ("encoder_attn", "causal_attn", "cross_attn")
FULL_ROW_KERNELS = [a + p for a in ATTENTIONS for p in ("", "_bwd_dq", "_bwd_dkv")]
LONG_PARTS = ("_long", "_long_lse", "_long_bwd_dq", "_long_bwd_dkv")
LONG_GEN_KERNELS = [a + p for a in ("encoder_attn", "cross_attn") for p in LONG_PARTS]

# Instantiations of the attention forward per input type: 3 routes x (3
# modes at D 64 + the scaled causal mode at D 64 and 128), and kernel 14's
# 4 variants beside FULL; of each backward kernel (dQ, dK/dV): 2 routes x
# the same 5 (mode, D).
FWD_INSTANCES = 3 * 5 + 4
BWD_INSTANCES = 2 * 5
ATTN_PARTS = {"fwd": FWD_INSTANCES, "bwd_dq": BWD_INSTANCES, "bwd_dkv": BWD_INSTANCES}
# Instantiations of the quantized products' tensor-core bodies: decode at
# bits 8 and 4 x 32 and 64 rows, admission at bits 8 and 4 (the simple
# body's two keep nvcuda::wmma).
QUANT_TMA_INSTANCES = 2 * 2 + 2

# The card's published peaks (H100 SXM): the bound of a kernel is the larger
# of its operations over the bf16 tensor-core rate and its bytes over the
# memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

SLICE = dict(
    num_files=300,
    premises_per_file=43,
    num_theorems_made=200,
    num_theorems=2,  # 4 before phase 29 was added (the smoke's time)
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


# One kernel's lines in ``-Xptxas -v`` output.
_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(build_log: str) -> dict:
    """Registers, stack and spill bytes of every kernel in an ``nvcc -Xptxas
    -v`` log, by mangled name."""
    report: dict = {}
    name = None
    for line in build_log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        if name is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            report[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            report[name]["registers"] = int(m.group(1))
    return report


def _attn_instance(name: str, part: str):
    """("bf16" or "fp32", "mode/route/D/variant") of an instantiation of one
    attention kernel (``part`` "fwd", "bwd_dq" or "bwd_dkv"; variant 0 for
    the backward) from its name, or None for another kernel."""
    from reprover_tpu_torch.ops.flash_attention import kernel_instance

    inst = kernel_instance(name)
    if inst is None or inst[0] != part:
        return None
    return inst[1], "/".join(str(x) for x in inst[2:])


def _fwd_instance(name: str):
    """:func:`_attn_instance` of the forward."""
    return _attn_instance(name, "fwd")


def _quant_instance(name: str):
    """("bf16", "body/bits/rows") of an instantiation of the quantized-product
    kernels (body decode, admission or simple) from its name, or None."""
    from reprover_tpu_torch.ops.quant_matmul import kernel_instance

    inst = kernel_instance(name)
    return None if inst is None else ("bf16", "/".join(str(x) for x in inst))


def _instance(name: str, part: str):
    """:func:`_quant_instance` for part "quant", else :func:`_attn_instance`."""
    return _quant_instance(name) if part == "quant" else _attn_instance(name, part)


def _spills(props: dict) -> int:
    return props.get("spill_stores", 0) + props.get("spill_loads", 0)


def phase_build() -> None:
    """Builds the kernels; logs each attention instantiation's registers,
    stack and spills from ``-Xptxas -v`` (forward, dQ, dK/dV) and each
    quantized-product body's, and the assembler's warnings and
    serialization notes; raises if a bf16 backward instantiation or a
    tensor-core body of the quantized products spills."""
    from reprover_tpu_torch.ops.native import BuildInfo, load_library

    load_library()
    log(f"[build] {'built' if BuildInfo.built else 'reused'} {BuildInfo.path} "
        f"in {BuildInfo.seconds:.2f}s")
    parts = list(ATTN_PARTS) + ["quant"]
    by_part: dict = {part: {} for part in parts}
    for name, props in ptxas_report(BuildInfo.log).items():
        inst = next(((part, i) for part in parts
                     if (i := _instance(name, part)) is not None), None)
        if inst is not None:
            by_part[inst[0]][f"{inst[1][0]} {inst[1][1]}"] = props
        elif props:
            log(f"[build] {name} {json.dumps(props)}")
    for part, props in by_part.items():
        what = "quant kernels (T body/bits/rows)" if part == "quant" else \
            f"attn_{part}_kernel (T mode/route/D/variant)"
        log(f"[build] {what} {json.dumps(props)}")
    for line in BuildInfo.log.splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            log(f"[build] {line.strip()}")
    spilled = [f"{part} {key}" for part in ("bwd_dq", "bwd_dkv")
               for key, p in by_part[part].items() if key.startswith("bf16") and _spills(p)]
    spilled += [f"quant {key}" for key, p in by_part["quant"].items()
                 if "simple" not in key and _spills(p)]
    if spilled:
        raise AssertionError(f"bf16 backward or quantized-product instantiations spill "
                             f"registers: {spilled}")


def sass_mma_counts(sass: str, part: str = "fwd") -> dict:
    """``{(T, "mode/route/D/variant"): {"HGMMA": n, "HMMA": n, "DEPBAR": n}}``
    for every instantiation of one attention kernel (``part`` "fwd",
    "bwd_dq" or "bwd_dkv"; with ``part`` "quant", ``{("bf16",
    "body/bits/rows"): ...}`` of the quantized products) in ``cuobjdump
    -sass`` output: its tensor-core instructions and its waits on them (one
    per batch of products when they are pipelined, one per HGMMA when the
    assembler serialized them)."""
    counts: dict = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = _instance(line.split("Function :", 1)[1].strip(), part)
            if current is not None:
                counts[current] = {"HGMMA": 0, "HMMA": 0, "DEPBAR": 0}
        elif current is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[current][op] += 1
            if "WARPGROUP.DEPBAR" in line:
                counts[current]["DEPBAR"] += 1
    return counts


def phase_sass() -> dict:
    """Phase 2's second half: the built library's machine code
    (``cuobjdump -sass``) shows that every bf16 instantiation of the
    attention forward, dQ and dK/dV kernels and every decode and admission
    body of the quantized products runs its products on the tensor cores
    (HGMMA, Hopper's warpgroup MMA), unserialized (fewer waits than
    HGMMAs), every fp32 attention instantiation keeps the FMA body (no
    HGMMA, no HMMA), and both instantiations of the beam reorder hold the
    bulk copies (UBLKCP); raises otherwise, or if an instantiation is
    missing."""
    from reprover_tpu_torch.ops.native import BuildInfo, cuda_tool

    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", BuildInfo.path],
                          capture_output=True, text=True, check=True, timeout=600).stdout
    report, faults = {}, []
    for part, want in ATTN_PARTS.items():
        counts = sass_mma_counts(sass, part)
        by_type = {t: {k: c for (tt, k), c in counts.items() if tt == t}
                   for t in ("bf16", "fp32")}
        log(f"[sass] attn_{part}_kernel {json.dumps(by_type)}")
        # A bf16 body with as many waits as HGMMAs had its products
        # serialized by the assembler (ptxas C7515, C7520).
        bad = [f"{t} {k}" for (t, k), c in counts.items()
               if (t == "bf16" and not 0 < c["DEPBAR"] < c["HGMMA"])
               or (t == "fp32" and c["HGMMA"] + c["HMMA"])]
        if len(by_type["bf16"]) != want or len(by_type["fp32"]) != want or bad:
            faults.append(f"attn_{part}_kernel: {len(by_type['bf16'])} bf16 and "
                          f"{len(by_type['fp32'])} fp32 instantiations (want {want} each); "
                          f"wrong units or serialized products in {bad}")
        report[part] = by_type
    # The quantized products: every decode and admission body on HGMMA,
    # unserialized; the simple body keeps its wmma (HMMA) products.
    counts = sass_mma_counts(sass, "quant")
    by_body = {k: c for (_, k), c in counts.items()}
    log(f"[sass] quant kernels (body/bits/rows) {json.dumps(by_body)}")
    tma = {k: c for k, c in by_body.items() if not k.startswith("simple")}
    bad = [k for k, c in tma.items() if not 0 < c["DEPBAR"] < c["HGMMA"]]
    if len(tma) != QUANT_TMA_INSTANCES or bad:
        faults.append(f"quant kernels: {len(tma)} tensor-core instantiations (want "
                      f"{QUANT_TMA_INSTANCES}); no HGMMA or serialized products in {bad}")
    report["quant"] = by_body
    # Kernel 13: both index instantiations carry the bulk-copy branch:
    # cp.async.bulk loads (UBLKCP.S.G, global to shared) and stores
    # (UBLKCP.G.S) in the machine code.
    bulk = sass_bulk_copies(sass)
    log(f"[sass] reorder_append_kernel bulk copies {json.dumps(bulk)}")
    if len(bulk) != 2 or not all(c.get("UBLKCP.S.G") and c.get("UBLKCP.G.S")
                                 for c in bulk.values()):
        faults.append(f"reorder_append_kernel: {len(bulk)} instantiations (want 2), bulk-copy "
                      f"opcodes {bulk}")
    report["beam_reorder"] = bulk
    if faults:
        raise AssertionError(f"machine code: {faults}")
    return report


def sass_bulk_copies(sass: str) -> dict:
    """``{instantiation: {opcode: count}}`` of the bulk-copy instructions
    (``UBLKCP``: ``cp.async.bulk``, both directions) in each
    ``reorder_append_kernel`` of ``cuobjdump -sass`` output."""
    counts: dict = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = name if "reorder_append_kernel" in name else None
            if current is not None:
                counts[current] = {}
        elif current is not None:
            for op in re.findall(r"\bUBLKCP[.\w]*", line):
                counts[current][op] = counts[current].get(op, 0) + 1
    return counts


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


def _bound(part: str, b: int, lq: int, lk: int, pairs: int, itemsize: int,
           heads: int = NUM_HEADS, head_dim: int = HEAD_DIM):
    """(least ms, "operations" or "bytes") of one kernel on the card: the
    larger of its FMA work (per kept pair and head: 4d forward, 2d for the
    LSE sweep, 6d dQ, 8d dK/dV operations) over the bf16 peak and of its
    bytes (each input read once, each output written once) over the memory
    rate."""
    inner = heads * head_dim
    flops = {"fwd": 4, "lse": 2, "dq": 6, "dkv": 8}[part] * head_dim * heads * pairs
    stats = 8 * b * heads * lq  # LSE and delta, fp32
    nbytes = {
        "fwd": itemsize * inner * 2 * (b * lq + b * lk) + 4 * b * lk,
        "lse": itemsize * inner * (b * lq + b * lk) + 4 * b * lk + stats // 2,
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
    the library call and the bound; bf16 also row by row
    (:func:`row_error`)."""
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
    row_err = row_error(out, ref, NUM_HEADS)
    rows_ok = dtype == torch.float32 or row_err <= BF16_REL_TOL
    iters = 20 if b * max(lq, lk) <= 32 * 1024 else 10
    _, qkv, attn = _library(tfa, mode, *args)
    with torch.no_grad():
        row = dict(kernel=tfa.KERNEL_NAMES[mode], B=b, Lq=lq, Lk=lk,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err, tol=tol,
                   row_err=row_err, ms=_time_ms(lambda: kernel(*args), iters),
                   plain_ms=_time_ms(lambda: plain(*args), iters),
                   library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                       *qkv, attn_mask=attn, scale=1.0), iters),
                   ok=finite and err <= tol and rows_ok)
    row["bound_ms"], row["bound_by"] = _bound(
        "fwd", b, lq, lk, _valid_pairs(tfa, mode, mask, lq), q.element_size())
    return row


def _backward_row(tfa, mode, b, lq, lk, dtype, gen, device, empty_row: bool) -> dict:
    """Autograd through the kernels against autograd of the plain version
    (errors; bf16 dq, dk, dv also row by row against the plain chain,
    :func:`grad_row_error`, :func:`plain_grad_chain`), the
    whole backward, each backward kernel alone on the forward's LSE, the
    plain backward and the library call's autograd, and the two kernels'
    bounds. ``empty_row``: the last batch row has no valid key and must get
    zero gradients."""
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
    grad_rows = {}
    if dtype == torch.bfloat16:
        # Each (batch row, position, head) of dq, dk, dv also to its own
        # size, against the backward's algorithm in plain torch.
        zero_q, zero_k = zero_grad_rows(tfa, mode, mask, q)
        chain = plain_grad_chain(tfa, mode, q, k, v, mask, None if mode == tfa.CROSS else rel,
                                 dout, out=out_k.detach())
        grad_rows = {name: grad_row_error(g, w, NUM_HEADS, zero_q if name == "dq" else zero_k)
                     for name, g, w in zip(("dq", "dk", "dv"), got, chain)}
        ok &= max(grad_rows.values()) <= BF16_REL_TOL
        del chain
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
               dtype=str(dtype).replace("torch.", ""), errs=errs, grad_row_err=grad_rows,
               ok=ok, bwd_ms=ms,
               plain_bwd_ms=plain_ms, library_bwd_ms=library_ms, dq_ms=dq_ms, dkv_ms=dkv_ms)
    row["dq_bound_ms"], row["dq_bound_by"] = _bound("dq", b, lq, lk, pairs, q.element_size())
    row["dkv_bound_ms"], row["dkv_bound_by"] = _bound("dkv", b, lq, lk, pairs, q.element_size())
    return row


def row_error(got, want, num_heads: int, floor: float = 0.0) -> float:
    """The largest, over the (batch row, position, head) rows of an
    attention output or gradient ``[B, L, H*d]``, of the row's largest
    error over the row's own max|ref| plus ``floor``; with no floor, inf if
    a row whose reference is all zero (no valid key) is not. The bf16 limit 2e-2 *
    max(1, max|ref|) follows the largest rows (a query that sees a few keys
    gets their v, |out| ~ 4), so it passes errors as large as a late,
    diffuse row itself (|out| ~ 0.05 at 2048 keys); held to 2e-2 here,
    every row answers for its own size."""
    import torch

    b, l, _ = want.shape
    diff = (got.float() - want.float()).abs().reshape(b, l, num_heads, -1).amax(-1)
    scale = want.float().abs().reshape(b, l, num_heads, -1).amax(-1)
    scale = scale + floor
    ratio = torch.where(scale > 0, diff / scale.clamp_min(1e-30),
                        torch.where(diff > 0, math.inf, 0.0))
    return ratio.max().item() if ratio.numel() else 0.0


# The floor of the per-row gradient limit, over max(1, max|ref|) of the
# whole tensor: a row within 2e-2 of (its own max|ref| + 0.1 max(1,
# max|ref|)), i.e. 2e-2 of itself plus 2e-3 of the tensor.
GRAD_ROW_FLOOR = 0.1


def grad_row_error(got, want, num_heads: int, zero=None) -> float:
    """:func:`row_error` of a bf16 gradient (dq, dk or dv ``[B, L, H*d]``),
    held to 2e-2 like an output row, with a floor of 2e-3 x max(1,
    max|ref|) of the whole tensor: dS sums to zero over a query's keys, so a
    dQ row can cancel to far below the terms whose bf16 rounding it carries.
    ``zero`` (bool, broadcastable to ``[B, L, H]``, :func:`zero_grad_rows`)
    marks the rows that must be exactly zero: a query with no valid key, a
    masked key. (A reference row can also cancel to exactly zero, e.g. a
    query that sees one key, where delta and dP are the same sum taken in
    two orders; such a row is held to the floor.)"""
    if not want.numel():
        return 0.0
    floor = GRAD_ROW_FLOOR * max(1.0, want.float().abs().max().item())
    worst = row_error(got, want, num_heads, floor)
    if zero is not None:
        b, l, _ = got.shape
        rows = got.float().abs().reshape(b, l, num_heads, -1).amax(-1)
        if bool((rows[zero.expand(b, l, num_heads)] > 0).any()):
            return math.inf
    return worst


def plain_grad_chain(tfa, mode: int, q, k, v, mask, rel, dout, num_heads: int = NUM_HEADS,
                     max_distance: int = 128, out=None):
    """``(dq, dk, dv)`` by the backward's own algorithm in plain torch, the
    reference of :func:`grad_row_error` for a gradient taken through the
    kernels' autograd: P from the plain LSE and delta = rowsum(dO * O) from
    ``out``, the forward's output that the backward is given (the forward
    kernel's, in the inputs' dtype; the plain forward's if None), then step
    by step, key tile by key tile (the long route's plain versions, O(L *
    64) a head). Autograd of the fp32 plain forward takes delta from the
    unrounded fp32 output instead, and the forward kernel rounds P to bf16
    before P V: either moves delta by a fraction of a bf16 step, which moves
    a dq row that cancels (dS sums to zero over its keys) by 2-5% of itself,
    in the plain chain as much as in the kernels."""
    geo = (num_heads, 32, max_distance)
    if out is None:
        out = tfa.long_attention_reference(mode, q, k, v, mask, rel, *geo)
    lse = tfa.long_lse_reference(mode, q, k, mask, rel, *geo)
    common = (mode, q, k, v, dout, mask, rel, lse, tfa.row_delta(dout, out, num_heads), *geo)
    dq, _ = tfa.long_backward_dq_reference(*common)
    dk, dv = tfa.long_backward_dkv_reference(*common)
    return dq, dk, dv


def zero_grad_rows(tfa, mode: int, mask, q):
    """(dq rows, dk and dv rows) of one attention's gradient that must be
    exactly zero, bool and broadcastable to ``[B, L, H]``: the queries with
    no valid key (an encoder row with none, a left-padded scaled causal
    query) and the masked keys."""
    import torch

    no_key = ~tfa._valid(mode, mask, q).any(-1)  # [B or 1, 1, Lq]
    masked = torch.zeros((1, 1, 1), dtype=torch.bool, device=q.device) if mode == tfa.CAUSAL \
        else (mask == 0)[:, :, None]
    return no_key.transpose(1, 2), masked


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


def fused_row_excess(out, ref):
    """Each row's largest distance from the reference over what one bf16
    rounding of it allows (at most 2^-8 of the value, with 1e-3 of that and
    1e-6 of the row's largest magnitude for float32's own reordering); at
    most 1 in every row for a kernel that rounds once."""
    ref = ref.reshape(-1, ref.shape[-1])
    err = (out.to(ref.dtype).reshape(ref.shape) - ref).abs()
    allowed = 2 ** -8 * (1 + 1e-3) * ref.abs() + 1e-6 * ref.abs().amax(-1, keepdim=True)
    return (err / allowed.clamp_min(1e-30)).amax(-1)


def phase_fused_kernels(device) -> dict:
    """Phase 3b: ``add_rms_norm`` and ``gated_gelu`` against their plain
    versions at ``FUSED_NORM_SHAPES`` and ``FUSED_GELU_CASES``, then their
    times at ``FUSED_MAIN`` beside the bytes bound and the plain chains."""
    import torch

    from reprover_tpu_torch.models import t5
    from reprover_tpu_torch.ops import fused_elementwise as fe
    from reprover_tpu_torch.ops import kernel_timing

    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape: int, scale: float = 1.0):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    def launched(name: str, fn):
        before = fe.KERNEL_LAUNCHES[name]
        out = fn()
        torch.cuda.synchronize()
        return out, fe.KERNEL_LAUNCHES[name] - before

    rows, faults = [], []
    for shape in FUSED_NORM_SHAPES:
        w = torch.rand(shape[-1], generator=gen, device=device) + 0.5
        for with_delta in (True, False):
            h = rand(*shape, scale=3.0)
            delta = rand(*shape) if with_delta else None
            (h_new, normed), n = launched("add_rms_norm",
                                          lambda: fe.add_rms_norm(h, delta, w, FUSED_EPS))
            want_h, ref_normed = fe.add_rms_norm_reference(h, delta, w, FUSED_EPS)
            x = want_h.float()
            ref = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + FUSED_EPS) * w
            excess = fused_row_excess(normed, ref)
            row = dict(kernel="add_rms_norm", shape=list(shape), delta=with_delta, launches=n,
                       h_new_equal=bool(torch.equal(h_new, want_h)),
                       max_row_excess=float(excess.max()),
                       max_abs_err=float((normed.float() - ref).abs().max()),
                       plain_max_abs_err=float((ref_normed.float() - ref).abs().max()))
            rows.append(row)
            if n != 1 or not row["h_new_equal"] or row["max_row_excess"] > 1:
                faults.append(row)
    for n_rows, width, halves in FUSED_GELU_CASES:
        if halves:
            gate, up = rand(n_rows, 2 * width, scale=2.0).chunk(2, dim=-1)
        else:
            gate, up = rand(n_rows, width, scale=2.0), rand(n_rows, width)
        out, n = launched("gated_gelu", lambda: fe.gated_gelu(gate, up))
        # float64: float32's tanh form cancels where tanh(y) nears -1.
        x = gate.double()
        ref = 0.5 * x * (1.0 + torch.tanh(fe.GELU_C * (x + 0.044715 * x * x * x))) * up.double()
        excess = fused_row_excess(out, ref)
        row = dict(kernel="gated_gelu", shape=[n_rows, width], wi_halves=halves, launches=n,
                   max_row_excess=float(excess.max()),
                   max_abs_err=float((out.double() - ref).abs().max()),
                   plain_max_abs_err=float(((t5.gelu_new(gate) * up).double() - ref).abs().max()))
        rows.append(row)
        if n != 1 or row["max_row_excess"] > 1:
            faults.append(row)
    for row in rows:
        log(f"[fused] {json.dumps(row)}")
    del gate, up, out
    torch.cuda.empty_cache()
    times = kernel_timing.time_fused(fe, t5, *FUSED_MAIN, iters=20, seed=0)
    for row in times:
        log(f"[fused] times {json.dumps(row)}")
    if faults:
        raise AssertionError(f"the fused elementwise kernels disagree with their references: "
                             f"{faults}")
    return dict(rows=rows, times=times)


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


def _long_fn(tfa, mode, block_kv: int):
    """The public call of one attention, ``fn(q, k, v, mask, rel_bias)``;
    past 4096 or with ``block_kv`` it takes the long route (kernels 2, 5, 6
    and 7 on CUDA tensors)."""
    h = NUM_HEADS
    if mode == tfa.ENCODER:
        return lambda q, k, v, m, r: tfa.encoder_flash_attention(q, k, v, m, r, num_heads=h,
                                                                 block_kv=block_kv)
    if mode == tfa.CAUSAL:
        return lambda q, k, v, m, r: tfa.causal_flash_attention(q, k, v, r, num_heads=h,
                                                                block_kv=block_kv)
    return lambda q, k, v, m, r: tfa.cross_flash_attention(q, k, v, m, num_heads=h,
                                                           block_kv=block_kv)


def _long_backward_plain(tfa, mode, q, k, v, mask, rel, out, dout):
    """The long route's gradient by the plain versions of kernels 5, 6 and
    7 -> (dq, dk, dv, d_rel or None)."""
    geo = (NUM_HEADS, 32, 128)
    lse = tfa.long_lse_reference(mode, q, k, mask, rel, *geo)
    common = (mode, q, k, v, dout, mask, rel, lse, tfa.row_delta(dout, out, NUM_HEADS), *geo)
    dq, bins = tfa.long_backward_dq_reference(*common)
    dk, dv = tfa.long_backward_dkv_reference(*common)
    if bins is None:
        return dq, dk, dv, None
    table = tfa.bucket_table(32, 128, q.device, mode == tfa.ENCODER)
    return dq, dk, dv, tfa.fold_rel_bins(bins, table, 32)


def _efficient_lse_ms(q, k, v, attn, iters: int):
    """A reading beside kernel 5 (the long route's LSE sweep): PyTorch's
    efficient attention with ``compute_log_sumexp=True`` and the dense
    bias, the one call that returns the biased LSE; it writes the output as
    well, so it is not the same function, and the kernels line keeps kernel
    5's ``library_ms`` null. A string where the call is refused."""
    import torch

    def heads(x):
        b, l, inner = x.shape
        return x.view(b, l, NUM_HEADS, inner // NUM_HEADS)

    # The call takes the bias as [B, H, Lq, Lk] with a unit last stride; the
    # SDPA mask of _library broadcasts over heads (cross) or is laid out
    # head-last by its broadcast add (self-attention).
    bias = attn.expand(q.shape[0], NUM_HEADS, q.shape[1], k.shape[1]).contiguous()
    args = (heads(q), heads(k), heads(v), bias, None, None, None, None, 0.0, 0)
    try:
        with torch.no_grad():
            return _time_ms(lambda: torch.ops.aten._efficient_attention_forward(
                *args, compute_log_sumexp=True, scale=1.0), iters)
    except Exception as ex:  # a reading, not a check
        return f"not measured: {type(ex).__name__}: {str(ex)[:160]}"


def _long_row(tfa, mode, b, lq, lk, block_kv, dtype, gen, device) -> dict:
    """Kernels 2, 5, 6 and 7 of one attention at one shape against their
    plain versions: kernel 2's output and kernel 5's LSE; kernel 6 (dq and
    the bias gradient) and kernel 7 (dk, dv) alone on the plain LSE and
    delta; and the whole autograd backward through the public function (the
    kernels' own LSE) against the plain versions' chain (and, at
    ``LONG_PAIR_CHECK``, kernel 2's output and that backward against the
    full-row reference's autograd). Ragged masks, a
    fully masked tail tile, an encoder row with no valid key (B >= 3) that
    must get 0 and zero gradients, and a masked key >= 100 above query 0's
    valid scores. bf16 is also held row by row (:func:`row_error`, and
    :func:`grad_row_error` for dq, dk, dv) and its LSE to 1e-2. A bf16 row
    is timed with CUDA events beside the plain
    versions, one ``scaled_dot_product_attention`` call with a dense bias
    mask (its autograd for the backward kernels; none computes the LSE
    alone) and the bounds."""
    import torch
    import torch.nn.functional as F

    causal = mode == tfa.CAUSAL
    q, k, v, mask, rel = _attention_case(b, lq, lk, dtype, gen, device, causal)
    empty = not causal and b >= 3
    if not causal:
        mask[min(1, b - 1), lk - 100:] = 0  # a fully masked tail tile
        if empty:
            mask[-1] = 0
    if mode == tfa.CROSS:
        rel = None
    dout = torch.randn(q.shape, generator=gen, device=device).to(dtype)
    fn = _long_fn(tfa, mode, block_kv)
    geo = (NUM_HEADS, 32, 128)
    bf16 = dtype == torch.bfloat16

    def tol(name, want):
        base = BF16_REL_TOL if bf16 else (DREL_FP32_TOL if name.startswith("d_rel") else FP32_TOL)
        return base * max(1.0, want.float().abs().max().item()) if bf16 or name != "out" else base

    errs, grad_rows, ok = {}, {}, True
    zero_q, zero_k = zero_grad_rows(tfa, mode, mask, q)

    def check(name, got, want, rows_want=None):
        nonlocal ok
        errs[name] = (got.float() - want.float()).abs().max().item()
        ok &= bool(torch.isfinite(got).all()) and errs[name] <= tol(name, want)
        part = name.split("_")[0]
        if bf16 and part in ("dq", "dk", "dv"):
            grad_rows[name] = grad_row_error(got, want if rows_want is None else rows_want,
                                             NUM_HEADS, zero_q if part == "dq" else zero_k)
            ok &= grad_rows[name] <= BF16_REL_TOL

    out = fn(q, k, v, mask, rel)
    ref = tfa.long_attention_reference(mode, q, k, v, mask, rel, *geo)
    check("out", out, ref)
    row_err = row_error(out, ref, NUM_HEADS)
    ok &= not bf16 or row_err <= BF16_REL_TOL
    mask32, rel32, table = tfa._kernel_operands(mode, mask, rel, 32, 128)
    kernel_args = (mode, q, k, v, mask32, rel32, table, NUM_HEADS, 128)
    lse = tfa._forward_cuda(*kernel_args, True, tfa.LONG_LSE)[1]
    lse_ref = tfa.long_lse_reference(mode, q, k, mask, rel, *geo)
    rows = torch.isfinite(lse_ref)
    ok &= bool(torch.equal(torch.isinf(lse), ~rows))
    check("lse", lse[rows], lse_ref[rows])
    ok &= not bf16 or errs["lse"] <= BF16_LSE_TOL

    delta = tfa.row_delta(dout, ref, NUM_HEADS)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    bins = None if rel is None else torch.zeros((NUM_HEADS, 257), device=device)
    common = (q, k, v, dout, mask32, rel32, table, lse_ref, delta)
    tfa._backward_cuda(mode, "dq", *common, dq, bins, NUM_HEADS, 128, tfa.LONG)
    tfa._backward_cuda(mode, "dkv", *common, dk, dv, NUM_HEADS, 128, tfa.LONG)
    plain_args = (mode, q, k, v, dout, mask, rel, lse_ref, delta, *geo)
    dq_ref, bins_ref = tfa.long_backward_dq_reference(*plain_args)
    dk_ref, dv_ref = tfa.long_backward_dkv_reference(*plain_args)
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        check(name, got, want)
    if bins is not None:
        check("d_rel", tfa.fold_rel_bins(bins, table, 32), tfa.fold_rel_bins(bins_ref, table, 32))

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, rel) if t is not None]
    full = leaves + [None] * (4 - len(leaves))
    got = torch.autograd.grad(fn(full[0], full[1], full[2], mask, full[3]), leaves, dout)
    want = _long_backward_plain(tfa, mode, q, k, v, mask, rel, ref, dout)
    # The row check's reference takes delta from the kernel's own output.
    chain = _long_backward_plain(tfa, mode, q, k, v, mask, rel, out, dout) if bf16 else want
    for name, g, w, c in zip(("dq", "dk", "dv", "d_rel"), got, want, chain):
        check(f"{name}_e2e", g, w, rows_want=c)
    if mode == tfa.ENCODER and not bf16 and (b, lq) == LONG_PAIR_CHECK:
        # The bias per pair, not per tile: a near/far rule that the plain
        # versions share with the kernels cannot hide here.
        pair = [t.clone().requires_grad_(True) for t in (q, k, v, rel)]
        pair_out = tfa.encoder_attention_reference(*pair[:3], mask, pair[3], num_heads=NUM_HEADS)
        check("out_pair", out, pair_out)
        for name, g, w in zip(("dq", "dk", "dv", "d_rel"), got,
                              torch.autograd.grad(pair_out, pair, dout)):
            check(f"{name}_pair", g, w)
        del pair, pair_out
    del chain
    if empty:
        ok &= out[-1].abs().max().item() == 0.0 and all(
            g[-1].abs().max().item() == 0.0 for g in got[:3])
    row = dict(mode=tfa.KERNEL_NAMES[mode], B=b, Lq=lq, Lk=lk, block_kv=block_kv,
               dtype=str(dtype).replace("torch.", ""), errs=errs, row_err=row_err,
               grad_row_err=grad_rows, ok=ok)
    del got, want, leaves, full
    if not bf16:
        return row

    iters = 5 if b * max(lq, lk) > 32 * 1024 else 10
    lib_leaves, qkv, attn = _library(tfa, mode, q, k, v, mask, rel)
    with torch.no_grad():
        row.update(
            ms=_time_ms(lambda: fn(q, k, v, mask, rel), iters),
            plain_ms=_time_ms(lambda: tfa.long_attention_reference(mode, q, k, v, mask, rel,
                                                                   *geo), iters),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                *qkv, attn_mask=attn, scale=1.0), iters),
            lse_ms=_time_ms(lambda: tfa._forward_cuda(*kernel_args, True, tfa.LONG_LSE), iters),
            lse_plain_ms=_time_ms(lambda: tfa.long_lse_reference(mode, q, k, mask, rel, *geo),
                                  iters),
            dq_ms=_time_ms(lambda: tfa._backward_cuda(mode, "dq", *common, dq, bins, NUM_HEADS,
                                                      128, tfa.LONG), iters),
            dq_plain_ms=_time_ms(lambda: tfa.long_backward_dq_reference(*plain_args), iters),
            dkv_ms=_time_ms(lambda: tfa._backward_cuda(mode, "dkv", *common, dk, dv, NUM_HEADS,
                                                       128, tfa.LONG), iters),
            dkv_plain_ms=_time_ms(lambda: tfa.long_backward_dkv_reference(*plain_args), iters))
    row["lse_library_ms"] = _efficient_lse_ms(q, k, v, attn, iters)
    out_l = F.scaled_dot_product_attention(*qkv, attn_mask=attn, scale=1.0)
    dout_l = dout.view(b, lq, NUM_HEADS, HEAD_DIM).transpose(1, 2)
    row["library_bwd_ms"] = _time_ms(
        lambda: torch.autograd.grad(out_l, lib_leaves, dout_l, retain_graph=True), iters)
    pairs = _valid_pairs(tfa, mode, mask, lq)
    for part in ("fwd", "lse", "dq", "dkv"):
        key = "" if part == "fwd" else f"{part}_"
        row[f"{key}bound_ms"], row[f"{key}bound_by"] = _bound(part, b, lq, lk, pairs, 2)
    return row


def phase_long_kernels(device) -> list:
    """Kernels 2, 5, 6 and 7 in the three modes against their plain versions
    at ``LONG_CASES``, fp32 and bf16 (see :func:`_long_row`)."""
    import torch

    from reprover_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modes = {"encoder": tfa.ENCODER, "causal": tfa.CAUSAL, "cross": tfa.CROSS}
    gen = torch.Generator(device=device).manual_seed(5)
    rows = []
    for kind, b, lq, lk, block_kv in LONG_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            row = _long_row(tfa, modes[kind], b, lq, lk, block_kv, dtype, gen, device)
            log(f"[long_kernel] {json.dumps(row)}")
            rows.append(row)
            torch.cuda.empty_cache()
    _check_rows(rows, "the long-route kernels")
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


def make_bench(work: str, long: bool = False) -> str:
    """The synthetic LeanDojo-format benchmark (12,900 premises) under
    ``work``; returns its directory. ``long``: premises of Mathlib-like
    serialized length (~220 bytes on average) and theorems that can each
    access >= 100 of them, so 100 retrieved premises pack a source to 8192
    bytes."""
    bench = os.path.join(work, "bench_long" if long else "bench")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "make_synthetic_benchmark.py"),
         "--out", bench, "--num-files", str(SLICE["num_files"]),
         "--premises-per-file", str(SLICE["premises_per_file"]),
         "--num-theorems", str(SLICE["num_theorems_made"])]
        + (["--mathlib-lengths", "--min-accessible", "100"] if long else []),
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
    failed = [r.theorem.full_name for r in results if r.status.name != "PROVED"]
    return dict(launches=launches, reindex_s=reindex_s, premises=n_premises,
                premises_per_s=n_premises / reindex_s, requests=requests,
                s_per_request=per_request, pass_1=pass_1, eval_s=eval_s, failed=failed,
                packed_source=_packed_source(retriever, first, generator.max_inp_seq_len))


def _packed_source(retriever, thm: dict, max_len: int) -> str:
    """A theorem's first state with its 100 retrieved premises, packed as a
    served request packs it."""
    from reprover_tpu_torch.data import Context, Pos, format_augmented_state, remove_marks

    state = thm["traced_tactics"][0]["state_before"]
    premises, _ = retriever.retrieve_batch(
        [Context(thm["file_path"], thm["full_name"], Pos.of(thm["start"]), state)], 100)
    return remove_marks(format_augmented_state(state, premises[0], max_len))


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

        # Device events only: the share reads no host op, and a 511-step
        # request runs ~180k of them, each traced and parsed otherwise.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


# Diverse beam search (phase 4b): (num_beams, num_beam_groups,
# diversity_penalty, length_penalty, max_length) of the selection check on a
# seeded logits table (B 2, V 384, values rounded to 0.1 so candidates tie),
# card against CPU; the real model at 64 beams over one packed source, the
# decode cut to 128 bytes (steps, not widths), classic, one group and G 4.
DIVERSE = dict(batch=2, vocab=384, table_seed=0, score_tol=1e-5,
               cases=[(64, 4, 1.0, 0.0, 64), (64, 16, 0.5, 1.0, 64), (8, 8, 2.0, 0.0, 32)],
               beams=64, max_len=128, groups=4, penalty=1.0)


def _table_search(table, device, k: int, groups: int, penalty: float, lp: float, t: int):
    """``beam_search`` on ``device`` whose step reads ``table[position,
    last token]`` -> (sequences, scores, lengths) on the host."""
    import torch

    from reprover_tpu_torch.generation.beam_search import beam_search

    tab = table.to(device)
    res = beam_search(lambda c, tok: (tab[c["step"], tok], {"step": c["step"] + 1}),
                      lambda c, parent: c, {"step": 0}, DIVERSE["batch"], k, t, 1, 0, 0,
                      length_penalty=lp, device=device, num_beam_groups=groups,
                      diversity_penalty=penalty)
    return [x.cpu() for x in (res.sequences, res.scores, res.lengths)]


def phase_diverse(device, cfg, gen_params, source: str) -> dict:
    """Phase 4b: grouped (diverse) beam search. (a) The selection on a
    seeded fp32 logits table indexed by (position, last token), rounded to
    0.1, at each ``DIVERSE["cases"]`` setting on the card and on the CPU:
    sequences and lengths equal, scores within 1e-5 (absolute and relative,
    as the CPU tests hold them). (b) The byt5-small generator over
    ``source`` (phase 4's packed source of the first val theorem) at 64
    beams, decode cut to 128: the classic call; one group
    without a penalty, bit-equal to it in sequences and scores; 4 groups at
    penalty 1.0, finite scores in descending order. ms per decode step
    (CUDA events over the search / its steps), distinct sequences of each,
    kernel 1's launches in the encoder."""
    import numpy as np
    import torch

    from reprover_tpu_torch.generation.beam_search import beam_search
    from reprover_tpu_torch.models.t5 import decode_step, encode, init_decode_state
    from reprover_tpu_torch.models.t5 import reorder_decode_state
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.tokenizer import ByT5Tokenizer

    report: dict = {"table": []}
    rng = np.random.default_rng(DIVERSE["table_seed"])
    max_t = max(c[4] for c in DIVERSE["cases"])
    v = DIVERSE["vocab"]
    table = np.round(rng.normal(scale=2.0, size=(max_t, v, v)), 1).astype(np.float32)
    table[:, :, 1] += 1.5  # EOS (id 1): hypotheses finish early and often
    table = torch.from_numpy(table)
    failures = []
    for k, groups, penalty, lp, t in DIVERSE["cases"]:
        got = _table_search(table, device, k, groups, penalty, lp, t)
        want = _table_search(table, torch.device("cpu"), k, groups, penalty, lp, t)
        gap = float((got[1] - want[1]).abs().max())
        size = float(want[1].abs().max())
        same = torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        report["table"].append(dict(beams=k, groups=groups, penalty=penalty, length_penalty=lp,
                                    max_len=t, same_tokens=same, score_gap=gap,
                                    max_abs_score=size))
        # Within 1e-5 as the CPU tests hold it (atol and rtol): a sum of 63
        # log-probs near 300 has an fp32 step of 3e-5.
        if not same or not gap <= DIVERSE["score_tol"] * (1.0 + size):
            failures.append(f"table search {k}/{groups}/{penalty}: tokens equal {same}, "
                            f"score gap {gap} at max |score| {size}")

    batch = ByT5Tokenizer()([source], max_length=SLICE["max_inp_seq_len"], bucket_multiple=128)
    ids = torch.from_numpy(batch.input_ids).to(device, torch.long)
    mask = torch.from_numpy(batch.attention_mask).to(device)
    beams, max_len = DIVERSE["beams"], DIVERSE["max_len"]
    tfa.reset_launch_counts()
    with torch.inference_mode():
        enc = encode(gen_params, cfg, ids, mask)
    report["encoder_attn_launches"] = tfa.KERNEL_LAUNCHES["encoder_attn"]
    runs = {}
    # One group first: its search takes the first call's costs off the
    # classic one's time.
    for tag, kw in (("one_group", dict(num_beam_groups=1, diversity_penalty=0.0)), ("classic", {}),
                    ("groups", dict(num_beam_groups=DIVERSE["groups"],
                                    diversity_penalty=DIVERSE["penalty"]))):
        steps = [0]

        def step(cache, tokens):
            steps[0] += 1
            return decode_step(gen_params, cfg, cache, tokens)

        with torch.inference_mode():
            cache = init_decode_state(gen_params, cfg, enc, mask, max_len, num_beams=beams)
            _sync(device)
            t0 = time.perf_counter()
            if device.type == "cuda":
                events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                events[0].record()
            res = beam_search(step, reorder_decode_state, cache, 1, beams, max_len,
                              cfg.eos_token_id, cfg.pad_token_id, cfg.decoder_start_token_id,
                              0.0, device, **kw)
            if device.type == "cuda":
                events[1].record()
            _sync(device)
        ms = (events[0].elapsed_time(events[1]) if device.type == "cuda"
              else 1e3 * (time.perf_counter() - t0))
        seqs = res.sequences[0].cpu()
        distinct = len({tuple(row[:n].tolist()) for row, n in zip(seqs, res.lengths[0].cpu())})
        runs[tag] = res
        report[tag] = dict(steps=steps[0], ms_per_step=ms / max(steps[0], 1),
                           distinct=distinct, best=float(res.scores[0, 0]))
    classic, one, grouped = runs["classic"], runs["one_group"], runs["groups"]
    if not (torch.equal(one.sequences, classic.sequences) and torch.equal(one.scores,
                                                                          classic.scores)):
        failures.append("one group without a penalty is not bit-equal to the classic search")
    scores = grouped.scores[0].float().cpu()
    if not bool(torch.isfinite(scores).all()) or bool((scores[1:] > scores[:-1]).any()):
        failures.append(f"the grouped search's scores are not finite and descending: {scores}")
    if device.type == "cuda" and report["encoder_attn_launches"] < 1:
        failures.append("the encoder did not launch kernel 1")
    log(f"[diverse] {json.dumps(report)}")
    if failures:
        raise AssertionError("diverse beam search failed: " + "; ".join(failures))
    return report


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
    encoder = {k: launches[k] for k in FULL_ROW_KERNELS if k.startswith("encoder_attn")}
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


def _profiled_share(state, loss_fn, model_cfg, batch: dict, device) -> dict:
    """Device time of one profiled train step by kernel, and each attention
    kernel's share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from reprover_tpu_torch.ops.flash_attention import launch_key
    from reprover_tpu_torch.training.tasks import timed_train_steps

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed_train_steps(state, loss_fn, model_cfg, batch, 1)
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    except Exception as ex:  # the share is a report; a profiler failure is not a phase failure
        return {"profiler": f"not measured: {ex!r}"}
    total = sum(by_name.values())
    attn: dict = {}
    for name, us in by_name.items():
        key = launch_key(name)
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

    from reprover_tpu_torch.training.tasks import timed_train_steps

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    timed = timed_train_steps(state, loss_fn, model_cfg, tensors, steps)
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


def _gen_argv(device, work: str, bench: str, preds: str, tiny: bool, gen: dict) -> list:
    """``generation.main`` flags of a generator phase (``gen``: ``GEN``, the
    reference data settings, or ``LONG_GEN``): remat on, seeded random init
    (or the tiny model), greedy validation on one batch."""
    return [
        "--device", device.type,
        "--model.tiny" if tiny else "--model.random_init", "true",
        "--model.remat", "true",
        "--model.num_beams", "1",
        "--data.data_path", os.path.join(bench, "random"),
        "--data.corpus_path", os.path.join(bench, "corpus.jsonl"),
        "--data.preds_path", preds,
        "--data.batch_size", str(gen["batch_size"]),
        "--data.eval_batch_size", str(gen["eval_batch_size"]),
        "--data.max_inp_seq_len", str(gen["max_inp_seq_len"]),
        "--data.max_oup_seq_len", str(gen["max_oup_seq_len"]),
        "--limit_val_batches", "1",
        "--seed", str(gen["seed"]),
        "--log_dir", os.path.join(work, "glogs"),
    ]


def phase_generator_train(device, work: str, bench: str, tiny: bool = False,
                          gen: dict = GEN) -> dict:
    """Retriever predictions from phase 7's checkpoint (``work/ckpts``),
    then generator training through the CLI entry point: ``gen["steps"]``
    steps, one validation and a checkpoint. ``GEN``: the reference settings
    at 2300 bytes, every full-row attention kernel launched, then ``validate
    --ckpt_dir`` restoring the checkpoint. ``LONG_GEN``: sources up to 8192
    bytes (its outputs under ``work/long``), the encoder and cross modes of
    kernels 2, 5, 6 and 7 launched."""
    import torch

    from reprover_tpu_torch.generation.datamodule import GeneratorDataModule
    from reprover_tpu_torch.generation.main import main as generation_main
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.retrieval.main import main as retrieval_main

    tag, long = gen["tag"] + "_train", gen is LONG_GEN
    out = os.path.join(work, "long") if long else work
    os.makedirs(os.path.join(out, "logs"), exist_ok=True)
    t0 = time.perf_counter()
    # GEN retrieves 40 premises per tactic: the synthetic corpus's first
    # files see only 43 accessible premises (the reference retrieves 100 from
    # Mathlib); LONG_GEN's benchmark keeps >= 100 accessible to each theorem.
    records = retrieval_main(["predict"] + _fit_argv(device, out, bench, tiny) + [
        "--ckpt_dir", os.path.join(work, "ckpts"), "--preds_out", "predictions.pickle",
        "--model.num_retrieved", str(gen["num_retrieved"])])
    preds = os.path.join(out, "logs", "predictions.pickle")
    log(f"[{tag}] retrieval.main predict: {len(records)} records in "
        f"{time.perf_counter() - t0:.3f}s -> {preds}")

    dm = GeneratorDataModule(os.path.join(bench, "random"), gen["batch_size"],
                             gen["eval_batch_size"], gen["max_inp_seq_len"],
                             gen["max_oup_seq_len"], 0.5, preds_path=preds, seed=gen["seed"])
    dm.setup("fit")
    shapes = sorted({(tuple(b["state_ids"].shape), tuple(b["tactic_ids"].shape))
                     for _, b in zip(range(gen["steps"]), dm.train_dataloader())})
    log(f"[{tag}] train batches (state_ids, tactic_ids) shapes: {shapes}")

    ckpt = os.path.join(out, "gckpts")
    argv = _gen_argv(device, out, bench, preds, tiny, gen) + [
        "--trainer.max_steps", str(gen["steps"]),
        "--trainer.val_interval", str(gen["steps"]),
        "--trainer.log_interval", str(gen["log_interval"]),
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
    with open(os.path.join(out, "glogs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    sps = [r["steps_per_sec"] for r in recs if "steps_per_sec" in r]
    val = [r for r in recs if "loss_val" in r]
    log(f"[{tag}] fit {state.step} steps in {fit_s:.3f}s (validation and checkpoint "
        f"included); losses {losses}; steps/s per {gen['log_interval']}-step window {sps}; "
        f"kernel launches {launches}")
    if val:
        log(f"[{tag}] validation {json.dumps(val[-1])}")
    if state.step != gen["steps"] or len(losses) != gen["steps"] // gen["log_interval"]:
        raise AssertionError(f"fit ran {state.step} steps and logged {len(losses)} losses")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not val or "top1_acc_val" not in val[-1] or not math.isfinite(val[-1]["loss_val"]):
        raise AssertionError("metrics.jsonl lacks a finite loss_val and top1_acc_val")
    required = LONG_GEN_KERNELS if long else FULL_ROW_KERNELS
    if device.type == "cuda" and min(launches[name] for name in required) < 1:
        raise AssertionError(f"generator training did not launch every kernel of its route "
                             f"({required}): {launches}")
    if not os.path.exists(os.path.join(ckpt, str(gen["steps"]), "state.pt")):
        raise AssertionError(f"fit wrote no checkpoint under {ckpt}")
    result = dict(launches=launches, losses=losses, steps_per_sec=sps, fit_s=fit_s,
                  validation=val[-1], shapes=shapes)
    if long:
        return result

    saved = torch.load(os.path.join(ckpt, str(gen["steps"]), "state.pt"),
                       map_location="cpu", weights_only=True)["params"]
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _, model = generation_main(["validate"] + argv + ["--ckpt_dir", ckpt])
    mismatched = [name for name, t in _flat(model.params).items()
                  if not torch.equal(t.detach().cpu(), _flat(saved)[name])]
    if mismatched:
        raise AssertionError(f"validate --ckpt_dir restored different parameters: {mismatched}")
    log(f"[{tag}] validate --ckpt_dir restored {len(_flat(saved))} parameter tensors "
        f"bit-equal")
    return result


def _generator_cfg(device, tiny: bool):
    """The generator's model config with remat ``full``: byt5-small, or the
    tiny geometry of the CLIs' ``--model.tiny``."""
    from reprover_tpu_torch.models.t5 import T5Config, byt5_small, default_dtype

    dtype = default_dtype(device)
    if tiny:
        return T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                        num_decoder_layers=1, compute_dtype=dtype, remat=True)
    return byt5_small(compute_dtype=dtype, remat=True)


def _generator_batch(gen: dict, device) -> dict:
    """One fixed random batch at ``gen["shape"]`` with [B, max_oup_seq_len]
    targets, ragged, -100 past each target, on ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(gen["seed"])
    (b, src), tgt = gen["shape"], gen["max_oup_seq_len"]
    src_len = rng.integers(src // 2, min(src, gen["max_inp_seq_len"]) + 1, b)
    tgt_len = rng.integers(tgt // 8, tgt + 1, b)
    src_mask = (np.arange(src)[None, :] < src_len[:, None]).astype(np.int64)
    tactic = rng.integers(3, 259, (b, tgt))
    tactic[np.arange(tgt)[None, :] >= tgt_len[:, None]] = -100
    batch = {"state_ids": torch.from_numpy(rng.integers(3, 259, (b, src)) * src_mask),
             "state_mask": torch.from_numpy(src_mask), "tactic_ids": torch.from_numpy(tactic)}
    return {k: v.to(device) for k, v in batch.items()}


def phase_generator_steps(device, tiny: bool = False, gen: dict = GEN) -> dict:
    """One fixed random batch at ``gen["shape"]`` (``GEN``: the reference cap,
    [8, 2304] sources; ``LONG_GEN``: [4, 8192]) with [B, 512] targets,
    ragged, -100 past each target, no warmup: ``gen["fixed_steps"]`` steps
    whose loss must fall, timed by part, peak memory and each attention
    kernel's share of a profiled step."""
    import torch

    from reprover_tpu_torch.models.t5 import fuse_mlp_params, init_params, place_master_params
    from reprover_tpu_torch.training.tasks import generation_loss, init_train_state

    cfg = _generator_cfg(device, tiny)
    params = init_params(cfg, torch.Generator().manual_seed(gen["seed"]))
    state = init_train_state(place_master_params(fuse_mlp_params(params), device), gen["lr"],
                             warmup_steps=0)
    del params
    batch = _generator_batch(gen, device)
    tag = gen["tag"] + "_step"
    row = _step_report(tag, state, generation_loss, cfg, batch, gen["fixed_steps"], device)
    losses = row["losses"]
    log(f"[{tag}] repeated batch, lr {gen['lr']} without warmup: loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f} over {len(losses)} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss on one fixed batch did not fall: {losses}")
    return row


def phase_long_serving(device, bench: str) -> dict:
    """Long-context serving: the phase-4 models (made again from their
    seeds) behind ``InferenceService`` with the generator at
    ``max_inp_seq_len`` 8192, answering two prover workers on
    ``LONG_SERVE`` theorems; each state packs its 100 retrieved premises
    past 4096 bytes, so the encoder takes the long route (kernel 2). Logs
    the padded encoder shape of every served batch, the length of each
    served source and s/request over all
    requests, and fails unless at least two batches were served, every
    served source passed 4096 and ``encoder_attn_long`` launched. Then one packed state's encode, timed
    with CUDA events."""
    import torch

    from reprover_tpu_torch.data import Context, Pos, format_augmented_state, remove_marks
    from reprover_tpu_torch.generation import TacticGeneratorModel
    from reprover_tpu_torch.models.t5 import encode
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.prover.environment import environment_from_dataset
    from reprover_tpu_torch.prover.evaluate import evaluate
    from reprover_tpu_torch.prover.service import InferenceService
    from reprover_tpu_torch.prover.tactic_generator import FixedTacticGenerator
    from reprover_tpu_torch.retrieval import PremiseRetriever

    lengths: list = []
    packed: list = []

    class Recording(TacticGeneratorModel):
        """The generator, recording the padded shape of each encoded batch
        and the unpadded length of each of its sources."""

        def generate_ids(self, input_ids, attention_mask, num_beams, max_length):
            lengths.append(list(input_ids.shape))
            packed.extend(int(n) for n in attention_mask.sum(1).tolist())
            return super().generate_ids(input_ids, attention_mask, num_beams, max_length)

    cfg, gen_params, ret_params = _full_width_models(device)
    data_path = os.path.join(bench, "random")
    with open(os.path.join(data_path, "val.json")) as f:
        theorems = json.load(f)
    retriever = PremiseRetriever(ret_params, cfg, max_seq_len=SLICE["max_inp_seq_len"])
    retriever.load_corpus(os.path.join(bench, "corpus.jsonl"))
    generator = Recording(gen_params, cfg, LONG_SERVE["max_inp_seq_len"],
                          SLICE["max_oup_seq_len"])
    service = InferenceService(generator, retriever=retriever, max_batch=8)
    tfa.reset_launch_counts()
    service.start()
    t0 = time.perf_counter()
    try:
        pass_1, results = evaluate(
            data_path, environment_from_dataset(theorems), FixedTacticGenerator("unused"),
            split="val", num_theorems=LONG_SERVE["num_theorems"],
            num_sampled_tactics=SLICE["num_sampled_tactics"], timeout=600,
            max_expansions=LONG_SERVE["max_expansions"], num_workers=SLICE["num_workers"],
            make_client=service.client, return_results=True,
        )
    finally:
        service.stop()
    _sync(device)
    eval_s = time.perf_counter() - t0
    launches = dict(tfa.KERNEL_LAUNCHES)
    stats = service.stats_snapshot()
    requests = int(stats["requests"])
    row = dict(requests=requests, batches=int(stats["batches"]), encoder_shapes=lengths,
               source_bytes=packed, s_per_request=stats["device_time"] / max(requests, 1), eval_s=eval_s,
               pass_1=pass_1, launches={k: n for k, n in launches.items() if n})

    # One packed state alone: its padded length and the encoder's time.
    thm = theorems[0]
    state = thm["traced_tactics"][0]["state_before"]
    ctx = Context(thm["file_path"], thm["full_name"], Pos.of(thm["start"]), state)
    premises, _ = retriever.retrieve_batch([ctx], 100)
    aug = remove_marks(format_augmented_state(state, premises[0], generator.max_inp_seq_len))
    batch = generator.tokenizer([aug], max_length=generator.max_inp_seq_len,
                                bucket_multiple=generator.bucket_multiple)
    ids = torch.from_numpy(batch.input_ids).to(device, torch.long)
    mask = torch.from_numpy(batch.attention_mask).to(device)
    with torch.inference_mode():
        run = lambda: encode(generator.params, cfg, ids, mask)  # noqa: E731
        row["encode_ms"] = _time_ms(run, 5) if device.type == "cuda" else None
    row.update(packed_bytes=len(aug.encode("utf-8")), source_len=int(ids.shape[1]))
    log(f"[long_serve] {json.dumps(row)}")
    if len(results) != LONG_SERVE["num_theorems"] or any(r is None for r in results):
        raise AssertionError(f"long-context searches failed or were discarded: {results}")
    if row["batches"] < 2 or any(n <= tfa.LONG_CONTEXT for _, n in lengths):
        raise AssertionError(f"fewer than two batches, or a served source within "
                             f"{tfa.LONG_CONTEXT}: {lengths}")
    if device.type == "cuda" and launches["encoder_attn_long"] < 1:
        raise AssertionError(f"long serving did not launch kernel 2: {launches}")
    del service, generator, retriever, gen_params, ret_params
    _empty_cache(device)
    return row


# Streaming serving (phases 12-14). byt5-small: the phase-4 benchmark and
# settings through the streaming service (slots for the two prover workers,
# the JAX CLI's chunk defaults), kernel 13 as the cache reorder. LLaMA-7B:
# the geometry of benchmarks/causal7b_serve.py (4 slots x 8 beams, prompts
# of 512 tokens, 129 decode positions incl. the start token).
STREAM = dict(num_slots=2, fp32_beams=8, fp32_max_len=64)
LLAMA = dict(num_slots=4, num_beams=8, src=512, dec=129, seed=0, clients=2, requests_per_client=1,
             bpe_vocab=4096)
LLAMA_ADMIT_ROWS = LLAMA["num_slots"] * (LLAMA["src"] - 1)  # one admission wave's prefill rows
# Every LLaMA-7B weight that routes to kernel 11/12: (K, N) of q/k/v/o,
# gate/up, down and lm_head.
LLAMA_WEIGHT_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
L2_BYTES = 50 * 2 ** 20


def reset_all_launch_counts() -> None:
    from reprover_tpu_torch.benchmarks import flash_kernel_bisect
    from reprover_tpu_torch.ops import beam_reorder, flash_attention, quant_matmul

    for mod in (flash_attention, beam_reorder, quant_matmul, flash_kernel_bisect):
        mod.reset_launch_counts()


def all_launch_counts() -> dict:
    from reprover_tpu_torch.benchmarks import flash_kernel_bisect
    from reprover_tpu_torch.ops import beam_reorder, flash_attention, quant_matmul

    return {**flash_attention.KERNEL_LAUNCHES, **beam_reorder.KERNEL_LAUNCHES,
            **quant_matmul.KERNEL_LAUNCHES, **flash_kernel_bisect.KERNEL_LAUNCHES}


def _time_cold_ms(fn, copies: int, iters: int) -> float:
    """Mean ms of ``fn(i)`` cycling over ``copies`` operand sets, chosen so
    they do not fit the 50 MB L2 cache together: each launch reads its
    weights from device memory, as a decode step does. CUDA events around
    back-to-back calls paced by the host, so a call shorter than its host
    enqueue reads the enqueue."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % copies)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _reorder_rows_fresh(shapes: list, seed: int) -> list:
    """``_reorder_row`` at each of ``shapes`` (full ``T_live``), made in a
    fresh process. Phase 29 takes its rows from there: in the smoke's own
    process the profiler recorded no device activity after phase 28 (seen
    on the card; the cause is not found), so a profiled call there cannot
    count launches."""
    code = ("import json, torch, chip_smoke; d = torch.device('cuda'); "
            f"g = torch.Generator(device=d).manual_seed({seed}); "
            f"print(json.dumps([chip_smoke._reorder_row(d, s, s[4], g) for s in {shapes!r}]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise AssertionError(f"kernel 13's phase 29 rows failed ({proc.returncode}): "
                             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _reorder_row(device, shape, t_live: int, gen) -> dict:
    """Kernel 13 at one engine shape (bf16, int64 parents and positions, a
    frozen slot, ``t_live`` of the buffer's T columns): bit-equality with the
    plain version, by the kernel's default and with each branch forced
    (``VECTOR_ROW_BYTES``); the kernels one call launches (exactly one) and
    their device ms, from a profiled run; ms by CUDA events, queued ms and
    host us a call (``kernel_timing.queued_ms``); times of the plain
    version, ``index_select`` + the column write and the engine's einsum and
    scan modes; the bound (distinct parents read once) and the bound that
    reads a parent once for every child."""
    import torch

    from reprover_tpu_torch.generation import engine as te
    from reprover_tpu_torch.ops import beam_reorder as br
    from reprover_tpu_torch.ops.kernel_timing import (index_select_reorder, profile_calls,
                                                      queued_ms, reorder_bound_ms)

    L, S, K, H, T, d = shape
    dt = torch.bfloat16
    k, v = (torch.randn(shape, generator=gen, device=device).to(dt) for _ in range(2))
    kc, vc = (torch.randn((L, S, K, H, 1, d), generator=gen, device=device).to(dt)
              for _ in range(2))
    parent = torch.randint(0, K, (S, K), generator=gen, device=device)
    frozen = torch.zeros(S, dtype=torch.bool, device=device)
    frozen[-1] = True
    pos = torch.randint(0, t_live, (S,), generator=gen, device=device)
    out_k, out_v = torch.zeros_like(k), torch.zeros_like(v)
    args = (k[..., :t_live, :], v[..., :t_live, :], kc, vc, parent, frozen, pos)
    outs = (out_k[..., :t_live, :], out_v[..., :t_live, :])
    want = br.reorder_append_gather_reference(*args)
    default, bit_equal, err = br.VECTOR_ROW_BYTES, {}, 0.0
    try:
        for branch, value in (("default", default), ("bulk", 1 << 30), ("vector", 16)):
            br.VECTOR_ROW_BYTES = value
            out_k.zero_(), out_v.zero_()
            br.reorder_append_gather(*args, *outs)
            torch.cuda.synchronize()
            bit_equal[branch] = bool(torch.equal(outs[0], want[0]) and torch.equal(outs[1], want[1]))
            err = max(err, (outs[0].float() - want[0].float()).abs().max().item(),
                      (outs[1].float() - want[1].float()).abs().max().item())
    finally:
        br.VECTOR_ROW_BYTES = default
    del want
    library = index_select_reorder(br, *args)
    iters = 10
    kernel = lambda: br.reorder_append_gather(*args, *outs)  # noqa: E731
    device_ms, launches = profile_calls(kernel, iters)
    queued, host_us = queued_ms(lambda i: kernel(), 1, iters)
    row = dict(kernel="beam_reorder", shape=list(shape), t_live=t_live, dtype="bfloat16",
               span_bytes=t_live * d * 2, branch="bulk" if d * 2 < default else "vector",
               bit_equal=bit_equal, max_abs_err=err, launches_per_call=launches,
               ms=_time_ms(kernel, iters), device_ms=device_ms, queued_ms=queued, host_us=host_us,
               plain_ms=_time_ms(lambda: br.reorder_append_gather_reference(*args), iters),
               library_ms=_time_ms(library, iters))
    # The engine's two plain modes (for AUTO_SCAN_CACHE_BYTES); scan last:
    # it rewrites the caches.
    row["einsum_ms"] = _time_ms(lambda: (te.reorder_append(args[0], kc, parent, frozen, pos),
                                         te.reorder_append(args[1], vc, parent, frozen, pos)), 3)
    row["scan_ms"] = _time_ms(
        lambda: te.reorder_append_scan(args[0], args[1], kc, vc, parent, frozen, pos), 3)
    row["auto_resolves_to"] = te.resolve_reorder_mode("auto", 2 * args[0].numel() * 2)
    row["bound_ms"], row["bound_all_parents_ms"] = reorder_bound_ms(shape, t_live, parent,
                                                                    frozen, 2)
    row["bound_by"] = "bytes"
    row["ok"] = all(bit_equal.values()) and launches == 1
    return row


def _weight_only_reading(bits: int, x, ws: list, copies: int, iters: int, ref) -> dict:
    """PyTorch's own weight-only products on the same weights, timed as a
    reading (the port never calls them): ``torch._weight_int4pack_mm`` on
    copies converted by ``torch._convert_weight_to_int4pack`` (nibble + 8
    as its unsigned 4-bit value, even k in the high nibble, zero points 0:
    its (u4 - 8) * scale + zero is our nibble times a bf16-rounded scale),
    ``torch._weight_int8pack_mm`` on transposed int8 copies. ``{"ms",
    "max_abs_err"}``, or ``{"error"}`` with the op's own text where the
    card's torch refuses the shape or the device."""
    import torch

    from reprover_tpu_torch.ops import quant_matmul as qm

    try:
        if bits == 4:
            packs = []
            for w in ws:
                u4 = (qm.unpack_int4(w.q) + 8).t().contiguous()  # [N, K] in [0, 15]
                packed = torch._convert_weight_to_int4pack(
                    ((u4[:, ::2] << 4) | u4[:, 1::2]).to(torch.uint8), 8)
                s_bf16 = w.scale.to(torch.bfloat16)
                packs.append((packed, torch.stack([s_bf16, torch.zeros_like(s_bf16)], -1)))
                del u4

            def fn(i):
                return torch._weight_int4pack_mm(x, packs[i][0], ws[i].group, packs[i][1])
        else:
            packs = [(w.q.t().contiguous(), w.scale.reshape(-1).to(torch.bfloat16)) for w in ws]

            def fn(i):
                return torch._weight_int8pack_mm(x, packs[i][0], packs[i][1])
        err = (fn(0).float() - ref).abs().max().item()
        return {"ms": _time_cold_ms(fn, copies, iters), "max_abs_err": err}
    except Exception as ex:  # a reading only: the op's refusal is the result
        return {"error": f"{type(ex).__name__}: {str(ex).splitlines()[0][:200]}"}


def _quant_row(device, bits: int, m: int, k: int, n: int, gen, tp: int = 1,
               column: bool = True) -> dict:
    """Kernel 11 (bits 8) or 12 (bits 4) at one LLaMA-7B weight shape in
    bf16 (fp32 output for the lm_head), or with ``tp`` > 1 at the first
    rank's tensor-parallel shard of it (``column``: split by output
    channels, else by the contraction; the whole weight quantized, its
    group kept, as ``shard_for_model`` cuts it): the body it launched (by
    ``BODY_LAUNCHES``); its error against the plain version, globally
    (2e-2 * max(1, max|ref|)) and row by row (each output row within 2e-2
    of its own max|ref|), and a second launch bit-equal to the first; times
    of the kernel, the plain version, dequantize + ``torch.matmul`` and
    PyTorch's own weight-only kernel over weight copies that exceed the L2
    cache (``_time_cold_ms``), the kernel's device time and host us per
    call (``kernel_timing.queued_ms``); and the bound."""
    import dataclasses

    import torch

    from reprover_tpu_torch.models import quantize as qz
    from reprover_tpu_torch.ops import quant_matmul as qm
    from reprover_tpu_torch.ops.kernel_timing import queued_ms

    out_dtype = torch.float32 if n == 32000 else torch.bfloat16
    w = torch.randn((k, n), generator=gen, device=device) * k ** -0.5
    qw = qz.quantize_weight(w) if bits == 8 else qz.quantize_weight4(w)
    del w
    if tp > 1:
        from reprover_tpu_torch.parallel.mesh import Mesh
        from reprover_tpu_torch.parallel.sharding import shard_pytree

        spec = (None, "model") if column else ("model", None)
        qw = shard_pytree(qw, dataclasses.replace(
            qw, q=spec, scale=spec if bits == 4 or column else (None, None)), Mesh(1, tp, (0, 0)))
        qw = dataclasses.replace(qw, q=qw.q.contiguous(), scale=qw.scale.contiguous())
        k, n = (k, n // tp) if column else (k // tp, n)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    copies = max(1, -(-3 * L2_BYTES // qw.nbytes))
    ws = [qw] + [qz.QuantWeight(q=qw.q.clone(), scale=qw.scale.clone()) if bits == 8 else
                 qz.Quant4Weight(q=qw.q.clone(), scale=qw.scale.clone(), group=qw.group)
                 for _ in range(copies - 1)]
    if bits == 8:
        kernel = lambda i: qm.quant_matmul(x, ws[i].q, ws[i].scale.reshape(-1), out_dtype)  # noqa: E731
        plain = lambda i: qm.quant_matmul_reference(x, ws[i].q, ws[i].scale, out_dtype)  # noqa: E731
        library = lambda i: torch.matmul(x, ws[i].q.to(torch.bfloat16) * ws[i].scale.to(  # noqa: E731
            torch.bfloat16))
        wbytes = k * n + 4 * n
    else:
        kernel = lambda i: qm.quant4_matmul(x, ws[i].q, ws[i].scale, ws[i].group, out_dtype)  # noqa: E731
        plain = lambda i: qm.quant4_matmul_reference(x, ws[i].q, ws[i].scale, ws[i].group,  # noqa: E731
                                                     out_dtype)
        library = lambda i: torch.matmul(x, qz.dequantize4(ws[i], torch.bfloat16))  # noqa: E731
        wbytes = k * n // 2 + 4 * n * (k // qw.group)
    before = dict(qm.BODY_LAUNCHES)
    got, again = kernel(0), kernel(0)
    bodies = [b for b, count in qm.BODY_LAUNCHES.items() if count != before[b]]
    ref = qm.quant_matmul_reference(x, qw.q, qw.scale, torch.float32) if bits == 8 else \
        qm.quant4_matmul_reference(x, qw.q, qw.scale, qw.group, torch.float32)
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    tol = BF16_REL_TOL * max(1.0, ref.abs().max().item())
    rows = row_error(got[None], ref[None], 1)
    bit_equal = bool(torch.equal(got, again))
    iters = 30 if m <= 64 else 5
    row = dict(kernel="quant_matmul" if bits == 8 else "quant4_matmul", M=m, K=k, N=n, tp=tp,
               group=getattr(qw, "group", None), out=str(out_dtype).replace("torch.", ""),
               body=bodies[0] if len(bodies) == 1 else bodies, max_abs_err=err, tol=tol,
               row_err=rows, bit_equal=bit_equal,
               ok=bool(torch.isfinite(got).all()) and err <= tol and rows <= BF16_REL_TOL
               and bit_equal,
               ms=_time_cold_ms(kernel, copies, iters), plain_ms=_time_cold_ms(plain, copies, 3),
               library_ms=_time_cold_ms(library, copies, iters))
    row["device_ms"], row["host_us"] = queued_ms(kernel, copies, iters)
    reading = _weight_only_reading(bits, x, ws, copies, iters, ref)
    key = "library_int4pack" if bits == 4 else "library_int8pack"
    row[f"{key}_ms"] = reading.get("ms", reading.get("error"))
    row[f"{key}_max_abs_err"] = reading.get("max_abs_err")
    nbytes = 2 * m * k + wbytes + m * n * (4 if out_dtype == torch.float32 else 2)
    t_ops, t_bytes = 2 * m * k * n / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    row["bound_ms"] = 1e3 * max(t_ops, t_bytes)
    row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return row


def phase_serving_kernels(device, byt5_shape) -> list:
    """Phase 12: kernel 13 at the byt5-small and LLaMA-7B engine shapes
    (``T_live`` T and T/4, and T/8 for byt5-small), bit-equal to its plain
    version with either branch, one kernel a call; kernels 11
    and 12 at every routed LLaMA-7B weight shape at decode (M = 32) and
    admission (``LLAMA_ADMIT_ROWS``) rows, within 2e-2 * max(1, max|ref|),
    each row within 2e-2 of its own max|ref|, two launches bit-equal, and
    every one launched on a tensor-core body (``body``: the body whose
    ``BODY_LAUNCHES`` count its two launches raised, "tma")."""
    import torch

    gen = torch.Generator(device=device).manual_seed(12)
    rows = []
    llama = (32, LLAMA["num_slots"], LLAMA["num_beams"], 32, LLAMA["dec"], 128)
    byt5_t = byt5_shape[4]
    for shape, lives in ((tuple(byt5_shape), (byt5_t, byt5_t // 4, byt5_t // 8)),
                         (llama, (llama[4], llama[4] // 4))):
        for t_live in lives:
            row = _reorder_row(device, shape, max(1, t_live), gen)
            log(f"[serving_kernel] {json.dumps(row)}")
            rows.append(row)
            torch.cuda.empty_cache()
    for bits in (8, 4):
        for k, n in LLAMA_WEIGHT_SHAPES:
            for m in (LLAMA["num_slots"] * LLAMA["num_beams"], LLAMA_ADMIT_ROWS):
                row = _quant_row(device, bits, m, k, n, gen)
                log(f"[serving_kernel] {json.dumps(row)}")
                rows.append(row)
                torch.cuda.empty_cache()
    _check_rows(rows, "the serving kernels do")
    off = [(r["kernel"], r["M"], r["K"], r["N"], r["body"]) for r in rows
           if "body" in r and r["body"] != "tma"]
    if off:
        raise AssertionError(f"routed LLaMA-7B products did not launch a tensor-core body: {off}")
    return rows


def _stream_args(num_beams: int, num_slots: int):
    """The evaluate CLI's ``--streaming`` flags (the JAX CLI's defaults)."""
    from reprover_tpu_torch.prover.evaluate import build_parser

    return build_parser().parse_args([
        "--data-path", "unused", "--streaming", "--num-slots", str(num_slots),
        "--num-sampled-tactics", str(num_beams)])


def _streaming_service(model, args, retriever=None, reorder_mode: str = "gather"):
    from reprover_tpu_torch.prover.service import StreamingInferenceService

    return StreamingInferenceService(
        model, retriever=retriever, num_slots=args.num_slots, num_beams=args.num_sampled_tactics,
        chunk_size=args.chunk_size, chunk_burst=args.chunk_burst,
        pipeline_depth=args.pipeline_depth, reorder_mode=reorder_mode)


def _timed_engine(engine, ids, mask, device, chunk: int, profile_chunk: bool) -> dict:
    """Admit one wave, then time its chunks on the host clock (synchronized):
    admission ms, ms per step, and the device-busy share of one profiled
    chunk with its device time by kernel and the quantized products'
    (kernels 11/12) device ms per step."""
    slots = list(range(ids.shape[0]))
    _sync(device)
    t0 = time.perf_counter()
    engine.admit_batch_tokens(slots, ids, mask)
    _sync(device)
    admit_ms = 1e3 * (time.perf_counter() - t0)
    steps, t0 = 0, time.perf_counter()
    for _ in range(4):
        steps += engine.unpack_status(engine.dispatch_run(chunk))[3]
    _sync(device)
    row = dict(admit_ms=admit_ms, steps=steps,
               ms_per_step=1e3 * (time.perf_counter() - t0) / max(steps, 1))
    if profile_chunk and device.type == "cuda":
        try:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            from reprover_tpu_torch.ops.quant_matmul import kernel_instance as quant_kernel_instance

            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                n = engine.unpack_status(engine.dispatch_run(chunk))[3]
                _sync(device)
            wall_ms = 1e3 * (time.perf_counter() - t0)
            by_name: dict = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            device_ms = sum(by_name.values()) / 1e3
            quant_ms = sum(us for name, us in by_name.items()
                           if quant_kernel_instance(name) is not None) / 1e3
            # Busy share: the profiled chunk's device time over the
            # unprofiled wall time of as many steps (the profiler's own
            # host cost would dilute it).
            row.update(profiled_steps=n, profiled_wall_ms=wall_ms, device_ms=device_ms,
                       device_busy_share=device_ms / (row["ms_per_step"] * n) if n else None,
                       quant_kernels_ms_per_step=quant_ms / n if n else None,
                       top_kernels_ms={k[:60]: us / 1e3 for k, us in
                                       sorted(by_name.items(), key=lambda kv: -kv[1])[:8]})
        except Exception as ex:  # the share is a report; a profiler failure is not a phase failure
            row["profiler"] = f"not measured: {ex!r}"
    return row


def phase_streaming(device, bench: str, cfg, gen_params, ret_params, tiny: bool = False) -> dict:
    """Phase 13: byt5-small served through the streaming service (``evaluate
    --streaming`` flags, the phase-4 benchmark and settings, kernel 13 as the
    reorder) to two prover workers; ms/step of the engine at that geometry;
    and one state in fp32 through the engine (gather) and the classic
    ``generate``: the same tactics, scores within rtol 1e-4."""
    import dataclasses

    import numpy as np
    import torch

    from reprover_tpu_torch.generation import TacticGeneratorModel
    from reprover_tpu_torch.models.t5 import place_params
    from reprover_tpu_torch.ops import beam_reorder as br
    from reprover_tpu_torch.prover.environment import environment_from_dataset
    from reprover_tpu_torch.prover.evaluate import evaluate
    from reprover_tpu_torch.prover.tactic_generator import FixedTacticGenerator
    from reprover_tpu_torch.retrieval import PremiseRetriever

    data_path = os.path.join(bench, "random")
    with open(os.path.join(data_path, "val.json")) as f:
        theorems = json.load(f)
    environment = environment_from_dataset(theorems)
    retriever = PremiseRetriever(ret_params, cfg, max_seq_len=SLICE["max_inp_seq_len"])
    retriever.load_corpus(os.path.join(bench, "corpus.jsonl"))
    generator = TacticGeneratorModel(gen_params, cfg, SLICE["max_inp_seq_len"],
                                     SLICE["max_oup_seq_len"])
    args = _stream_args(SLICE["num_sampled_tactics"], STREAM["num_slots"])
    service = _streaming_service(generator, args, retriever)
    reset_all_launch_counts()
    service.start()
    t0 = time.perf_counter()
    try:
        pass_1, results = evaluate(
            data_path, environment, FixedTacticGenerator("unused"), split="val",
            num_theorems=SLICE["num_theorems"], num_sampled_tactics=SLICE["num_sampled_tactics"],
            timeout=600, max_expansions=SLICE["max_expansions"], num_workers=SLICE["num_workers"],
            make_client=service.client, return_results=True)
    finally:
        service.stop()
    _sync(device)
    eval_s = time.perf_counter() - t0
    launches = all_launch_counts()
    stats = service.stats_snapshot()
    requests = int(stats["requests"])
    span = stats.get("last_resp_ts", 0.0) - stats.get("first_req_ts", 0.0)
    row = dict(requests=requests, admissions=int(stats["admissions"]), steps=int(stats["steps"]),
               chunks=int(stats["chunks"]), eval_s=eval_s, pass_1=pass_1,
               s_per_request=span / max(requests, 1),
               slot_utilization=stats["slot_busy"] / max(stats["slot_cap"], 1.0),
               launches={k: v for k, v in launches.items() if v})
    log(f"[stream] evaluate --streaming ({STREAM['num_slots']} slots x "
        f"{SLICE['num_sampled_tactics']} beams, reorder gather): {json.dumps(row)}")
    if len(results) != SLICE["num_theorems"] or any(r is None for r in results) or requests < 1:
        raise AssertionError(f"streaming searches failed or served nothing: {results} {stats}")
    if device.type == "cuda" and launches["beam_reorder"] < 1:
        raise AssertionError("streaming serving did not launch the beam-reorder kernel")

    # ms/step of the engine at the served geometry, one wave of real states.
    states = [t["traced_tactics"][0]["state_before"] for t in theorems[: STREAM["num_slots"]]]
    engine = generator.make_stepwise_engine(STREAM["num_slots"], SLICE["num_sampled_tactics"],
                                            reorder_mode="gather")
    ids, mask = generator.tokenize_for_engine(states)
    reset_all_launch_counts()
    row["engine"] = _timed_engine(engine, ids, mask, device, args.chunk_size, True)
    row["engine"]["cache_shape"] = list(engine.state.self_k.shape)
    log(f"[stream] engine at [{STREAM['num_slots']} slots, {SLICE['num_sampled_tactics']} beams]: "
        f"{json.dumps(row['engine'])}")
    launches_total = launches["beam_reorder"] + all_launch_counts()["beam_reorder"]
    del engine
    _empty_cache(device)

    # One state in fp32: the engine (gather) against the classic generate.
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    model32 = TacticGeneratorModel(place_params(gen_params, cfg32, device), cfg32,
                                   SLICE["max_inp_seq_len"], STREAM["fp32_max_len"])
    beams = STREAM["fp32_beams"]
    want = model32.generate(states[:1], beams)[0]
    engine = model32.make_stepwise_engine(1, beams, reorder_mode="gather")
    engine.admit_batch_tokens([0], *model32.tokenize_for_engine(states[:1]))
    while not engine.finished_slots():
        engine.run_chunk()
    got = model32.decode_candidates(*engine.finalize(0))
    same = [t for t, _ in got] == [t for t, _ in want]
    close = np.allclose([s for _, s in got], [s for _, s in want], rtol=1e-4, atol=1e-5)
    log(f"[stream] fp32 engine vs classic ({beams} beams x {STREAM['fp32_max_len']}): same "
        f"tactics {same}, scores {[round(s, 5) for _, s in got]} vs "
        f"{[round(s, 5) for _, s in want]}")
    if not (same and close):
        raise AssertionError(f"fp32 engine and classic disagree: {got} vs {want}")
    row["beam_reorder_launches"] = launches_total
    del model32, engine
    _empty_cache(device)
    return row


def _empty_cache(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.empty_cache()


def _tactic_tokenizer(bench: str, vocab: int):
    """A BPE tokenizer trained on the synthetic corpus: premise code and the
    benchmark's states and tactics."""
    from reprover_tpu_torch.generation.bpe_tokenizer import train_tactic_tokenizer

    texts = []
    with open(os.path.join(bench, "corpus.jsonl")) as f:
        for line in f:
            texts.extend(p.get("code", "") for p in json.loads(line).get("premises", []))
    with open(os.path.join(bench, "random", "train.json")) as f:
        for thm in json.load(f)[:200]:
            for tac in thm["traced_tactics"]:
                texts += [tac["state_before"], tac["tactic"]]
    return train_tactic_tokenizer(texts, vocab_size=vocab)


def _llama_cfg(device, tiny: bool):
    import torch

    from reprover_tpu_torch.models.causal_lm import CausalLMConfig
    from reprover_tpu_torch.models.t5 import default_dtype

    if tiny:
        return CausalLMConfig(vocab_size=512, d_model=64, num_layers=2, num_heads=4,
                              num_kv_heads=4, d_ff=128, compute_dtype=default_dtype(device))
    return CausalLMConfig(compute_dtype=torch.bfloat16)


def _check_bodies(what: str) -> None:
    """Every quantized product launched since the counts were reset took a
    tensor-core body."""
    from reprover_tpu_torch.ops import quant_matmul as qm

    if qm.BODY_LAUNCHES["simple"]:
        raise AssertionError(f"{what} launched the simple quantized-product body: "
                             f"{qm.BODY_LAUNCHES}")


def phase_llama(device, bench: str, tiny: bool = False) -> dict:
    """Phase 14: LLaMA-7B (seeded random weights at full CausalLMConfig
    width, made on the card one layer at a time) in int4 through the
    streaming service (4 slots x 8 beams, prompts 512, decode 129, reorder
    gather), answering requests from two client threads on states of the
    synthetic benchmark; timed engine chunks with a profiled one; then the
    same weights in int8 through one admission wave to the end."""
    import asyncio
    import threading

    import numpy as np
    import torch

    from reprover_tpu_torch.data import Pos
    from reprover_tpu_torch.generation.causal_generator import CausalTacticGeneratorModel
    from reprover_tpu_torch.models.causal_lm import init_serving_params
    from reprover_tpu_torch.models.quantize import routing_report, weight_bytes

    cfg = _llama_cfg(device, tiny)
    src, dec = (16, 9) if tiny else (LLAMA["src"], LLAMA["dec"])
    tok = _tactic_tokenizer(bench, 300 if tiny else LLAMA["bpe_vocab"])
    with open(os.path.join(bench, "random", "val.json")) as f:
        theorems = json.load(f)
    states = [t["traced_tactics"][0]["state_before"] for t in theorems]
    report: dict = dict(tokenizer_vocab=tok.vocab_size)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for bits in (4, 8):
        t0 = time.perf_counter()
        params = init_serving_params(cfg, LLAMA["seed"], device, bits=bits)
        _sync(device)
        model = CausalTacticGeneratorModel(params, cfg, tok, max_inp_seq_len=src,
                                           max_oup_seq_len=dec - 1)
        routes = {
            "decode": routing_report({**params["layers"], "lm_head": params["lm_head"]},
                                     LLAMA["num_slots"] * LLAMA["num_beams"], cfg.compute_dtype,
                                     device),
            "admission": routing_report(params["layers"], LLAMA["num_slots"] * (src - 1),
                                        cfg.compute_dtype, device),
        }
        head = dict(bits=bits, init_s=time.perf_counter() - t0,
                    weight_GB=weight_bytes(params) / 1e9, routes=routes)
        log(f"[llama] int{bits} weights: {json.dumps(head)}")
        kernel = "quant4_matmul" if bits == 4 else "quant_matmul"
        if bits == 4:
            args = _stream_args(LLAMA["num_beams"], LLAMA["num_slots"])
            service = _streaming_service(model, args)
            reset_all_launch_counts()
            service.start()
            answers: list = []
            errors: list = []

            def client_thread(c, mine):
                async def run():
                    for st in mine:
                        answers.append(await c.agenerate(st, "a.lean", "t", Pos(1, 1),
                                                         LLAMA["num_beams"]))
                try:
                    asyncio.run(run())
                except Exception as ex:  # surfaced below: the phase fails
                    errors.append(repr(ex))

            per = LLAMA["requests_per_client"]
            threads = [threading.Thread(target=client_thread, args=(
                service.client(), states[i * per:(i + 1) * per])) for i in range(LLAMA["clients"])]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            serve_s = time.perf_counter() - t0
            service.stop()
            _sync(device)
            launches = all_launch_counts()
            stats = service.stats_snapshot()
            served = dict(requests=int(stats["requests"]), steps=int(stats["steps"]),
                          serve_s=serve_s, s_per_request=serve_s / max(len(answers), 1),
                          launches={k: n for k, n in launches.items() if n})
            log(f"[llama] int4 streaming service, {LLAMA['clients']} client threads: "
                f"{json.dumps(served)}")
            want = LLAMA["clients"] * per
            if errors or len(answers) != want or any(
                    len(a) != LLAMA["num_beams"] or not all(np.isfinite(s) for _, s in a)
                    for a in answers):
                raise AssertionError(f"LLaMA-7B int4 serving failed: {errors} "
                                     f"{[len(a) for a in answers]}")
            if device.type == "cuda" and (launches["quant4_matmul"] < 1
                                          or launches["beam_reorder"] < 1):
                raise AssertionError(f"int4 serving missed kernel 12 or 13: {launches}")
            _check_bodies("int4 serving")
            head.update(served=served, answers=answers[:1])
            engine = model.make_stepwise_engine(LLAMA["num_slots"], LLAMA["num_beams"],
                                                reorder_mode="gather")
            ids, mask = model.tokenize_for_engine(states[: LLAMA["num_slots"]])
            head["engine"] = _timed_engine(engine, ids, mask, device, args.chunk_size, True)
            log(f"[llama] int4 engine chunks: {json.dumps(head['engine'])}")
            head["launches"] = launches
            del service
        else:
            engine = model.make_stepwise_engine(LLAMA["num_slots"], LLAMA["num_beams"],
                                                reorder_mode="gather")
            ids, mask = model.tokenize_for_engine(states[: LLAMA["num_slots"]])
            reset_all_launch_counts()
            t0 = time.perf_counter()
            engine.admit_batch_tokens(list(range(LLAMA["num_slots"])), ids, mask)
            done = {}
            while engine.has_active():
                engine.unpack_status(engine.dispatch_run(8))
                for slot in engine.finished_slots():
                    done[slot] = model.decode_candidates(*engine.finalize(slot))
            _sync(device)
            launches = all_launch_counts()
            head.update(wave_s=time.perf_counter() - t0, answers=[done[0]],
                        launches={k: n for k, n in launches.items() if n})
            log(f"[llama] int8 admission wave to the end: {json.dumps(head)}")
            if len(done) != LLAMA["num_slots"] or (device.type == "cuda"
                                                   and launches[kernel] < 1):
                raise AssertionError(f"the int8 wave did not finish or missed kernel 11: {head}")
            _check_bodies("the int8 wave")
            head["launches"] = launches
        if device.type == "cuda":
            head["max_memory_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"[llama] int{bits} peak device memory since phase 14 began: "
                f"{head['max_memory_allocated_GiB']:.3f} GiB")
        report[f"int{bits}"] = head
        del params, model, engine
        _empty_cache(device)
    return report


# Decoder-only fine-tuning (phases 19-22). The scaled causal kernels'
# checks: (B, T, heads, head width, block_kv, a left-padded row): LLaMA-7B
# width at the fine-tuning step's [4, 2048] (the kernels line's times), a
# ragged [3, 1000] right-padded with one left-padded row (a query with no
# valid key), the JAX benchmark's geometry [8, 2048] x 16 x 64, and the long
# route past 4096 with a ragged key mask.
SCALED_CASES = [(4, 2048, 32, 128, 0, False), (3, 1000, 32, 128, 0, True),
                (8, 2048, 16, 64, 0, False), (2, 4608, 4, 128, 0, True)]
SCALED_MAIN = (4, 2048, 32, 128)
SCALED_LONG_MAIN = (2, 4608, 4, 128)
# Fine-tuning at LLaMA-7B width (vocab 32000, d_model 4096, 32 heads x 128,
# d_ff 11008), cut to depth 4 of 32 (float32 masters, gradients and Adam
# moments of all 32 layers, ~108 GB, do not fit one 80 GB card): batches of
# the phase-4 benchmark with phase 10's retrieved premises, BPE-tokenized,
# up to 2048 tokens, padded to multiples of 128 (so flash is taken), 20
# steps and one greedy validation batch; then the benchmark's fixed step at
# [4, 2048] and at the JAX benchmark's geometry [8, 2048], 10 steps each way.
FINETUNE = dict(layers=4, batch_size=4, max_seq_len=2048, bucket_multiple=128, steps=20,
                lr=1e-4, seed=0, bpe_vocab=4096, max_oup_seq_len=32, fixed_steps=10)
SCALED_PARTS = ("", "_bwd_dq", "_bwd_dkv")
# Kernel 14's check: each ablation variant against its plain version.
BISECT_CHECK = (2, 512)


def _scaled_case(b: int, t: int, h: int, d: int, left_pad: bool, dtype, gen, device):
    """Random q, k, v, dO [b, t, h*d] and a key mask: ragged right padding
    (row 0 full), and with ``left_pad`` the last row left-padded by 37 keys."""
    import torch

    q, k, v, dout = (torch.randn((b, t, h * d), generator=gen, device=device).to(dtype)
                     for _ in range(4))
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=device)
    lengths[0] = t
    mask = (torch.arange(t, device=device)[None, :] < lengths[:, None]).to(torch.int32)
    if left_pad:
        mask[-1] = 0
        mask[-1, 37:] = 1
    return q, k, v, dout, mask


def _scaled_row(tfa, b, t, h, d, block_kv, left_pad, dtype, gen, device) -> dict:
    """The scaled causal kernels at one shape against their plain versions:
    the forward (kernel 1s, or 2 on the long route), the LSE (the forward's,
    or kernel 5's), the dQ and dK/dV kernels alone on the plain LSE (3s/4s,
    or 6/7), and the whole autograd backward through the public function;
    a left-padded row gives 0 and zero gradients. bf16 is also held row by
    row (:func:`row_error`, and :func:`grad_row_error` for dq, dk, dv) and
    its LSE to 1e-2. A bf16 row is timed beside the plain versions, one
    ``scaled_dot_product_attention`` call with the causal-and-key boolean
    mask (its autograd for the backward), the bounds, and that call with
    ``is_causal=True`` and no mask (``library_causal_ms``, and its autograd
    ``library_causal_bwd_ms``: its flash path, which gives the same rows as
    the kernels where a batch is right-padded, the fine-tuning data
    module's layout, but not on a left-padded row or a padded query)."""
    import torch
    import torch.nn.functional as F

    q, k, v, dout, mask = _scaled_case(b, t, h, d, left_pad, dtype, gen, device)
    scale = d ** -0.5
    long = tfa.takes_long_route(block_kv, t, t)
    route = tfa.LONG if long else tfa.FULL_ROW
    mode = tfa.SCALED_CAUSAL
    bf16 = dtype == torch.bfloat16
    errs, grad_rows, ok = {}, {}, True
    zero_q, zero_k = zero_grad_rows(tfa, mode, mask, q)

    def check(name, got, want, relative=True, rows_want=None):
        nonlocal ok
        errs[name] = (got.float() - want.float()).abs().max().item()
        tol = (BF16_REL_TOL if bf16 else FP32_TOL) * (
            max(1.0, want.float().abs().max().item()) if bf16 or relative else 1.0)
        ok &= bool(torch.isfinite(got).all()) and errs[name] <= tol
        part = name.split("_")[0]
        if bf16 and part in ("dq", "dk", "dv"):
            grad_rows[name] = grad_row_error(got, want if rows_want is None else rows_want, h,
                                             zero_q if part == "dq" else zero_k)
            ok &= grad_rows[name] <= BF16_REL_TOL

    def fn(q_, k_, v_):
        return tfa.scaled_causal_flash_attention(q_, k_, v_, mask, h, scale, block_kv=block_kv)

    with torch.no_grad():
        out, ref = fn(q, k, v), tfa.scaled_causal_attention_reference(q, k, v, mask, h, scale)
    check("out", out, ref, relative=False)
    row_err = row_error(out, ref, h)
    ok &= not bf16 or row_err <= BF16_REL_TOL
    qs = tfa.scale_queries(q, scale)
    mask32 = mask.contiguous()
    kernel_args = (mode, qs, k, v, mask32, None, None, h, 128)
    lse = tfa._forward_cuda(*kernel_args, True, tfa.LONG_LSE if long else tfa.FULL_ROW)[1]
    lse_ref = tfa.scaled_causal_attention_lse_reference(qs, k, mask, h)
    rows = torch.isfinite(lse_ref)
    ok &= bool(torch.equal(torch.isinf(lse), ~rows))
    check("lse", lse[rows], lse_ref[rows], relative=False)
    ok &= not bf16 or errs["lse"] <= BF16_LSE_TOL
    delta = tfa.row_delta(dout, ref, h)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    common = (qs, k, v, dout, mask32, None, None, lse_ref, delta)
    tfa._backward_cuda(mode, "dq", *common, dq, None, h, 128, route)
    tfa._backward_cuda(mode, "dkv", *common, dk, dv, h, 128, route)
    want = tfa.scaled_causal_attention_backward_reference(qs, k, v, mask, ref, lse_ref, dout, h)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        check(name, g, w)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(fn(*leaves), leaves, dout)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(tfa.scaled_causal_attention_reference(*plain, mask, h, scale),
                               plain, dout)
    chain = plain_grad_chain(tfa, mode, qs, k, v, mask, None, dout, h,
                             out=out) if bf16 else (None,) * 3
    if bf16:  # dq with respect to q, as autograd through scale_queries gives it
        chain = ((chain[0].float() * scale).to(dtype),) + chain[1:]
    for name, g, w, c in zip(("dq", "dk", "dv"), got, want, chain):
        check(f"{name}_e2e", g, w, rows_want=c)
    if left_pad:
        # The padded query rows get 0 and no gradient; the padded keys none.
        ok &= out[-1, :37].abs().max().item() == 0.0 and all(
            g[-1, :37].abs().max().item() == 0.0 for g in got)
    row = dict(B=b, T=t, H=h, d=d, block_kv=block_kv, route="long" if long else "full_row",
               dtype=str(dtype).replace("torch.", ""), errs=errs, row_err=row_err,
               grad_row_err=grad_rows, ok=ok)
    del got, want, leaves, plain, chain
    if not bf16:
        return row

    iters = 5 if b * t * h * d > 2 ** 22 else 10
    valid = tfa._valid(mode, mask, q)  # [B, 1, T, T]
    lib_leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    heads = [x.view(b, t, h, d).transpose(1, 2) for x in lib_leaves]
    with torch.no_grad():
        row.update(
            ms=_time_ms(lambda: fn(q, k, v), iters),
            plain_ms=_time_ms(lambda: tfa.scaled_causal_attention_reference(q, k, v, mask, h,
                                                                            scale), iters),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                *heads, attn_mask=valid, scale=scale), iters),
            library_causal_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                *heads, is_causal=True, scale=scale), iters))
    if long:
        row["lse_ms"] = _time_ms(lambda: tfa._forward_cuda(*kernel_args, True, tfa.LONG_LSE),
                                 iters)
        row["lse_plain_ms"] = _time_ms(
            lambda: tfa.scaled_causal_attention_lse_reference(qs, k, mask, h), iters)
    row["dq_ms"] = _time_ms(lambda: tfa._backward_cuda(mode, "dq", *common, dq, None, h, 128,
                                                       route), iters)
    row["dkv_ms"] = _time_ms(lambda: tfa._backward_cuda(mode, "dkv", *common, dk, dv, h, 128,
                                                        route), iters)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out_p = tfa.scaled_causal_attention_reference(*plain, mask, h, scale)
    row["plain_bwd_ms"] = _time_ms(
        lambda: torch.autograd.grad(out_p, plain, dout, retain_graph=True), iters)
    out_l = F.scaled_dot_product_attention(*heads, attn_mask=valid, scale=scale)
    dout_l = dout.view(b, t, h, d).transpose(1, 2)
    row["library_bwd_ms"] = _time_ms(
        lambda: torch.autograd.grad(out_l, lib_leaves, dout_l, retain_graph=True), iters)
    out_c = F.scaled_dot_product_attention(*heads, is_causal=True, scale=scale)
    row["library_causal_bwd_ms"] = _time_ms(
        lambda: torch.autograd.grad(out_c, lib_leaves, dout_l, retain_graph=True), iters)
    pairs = int(torch.cumsum(mask.long(), dim=1).sum().item())  # (q, k <= q) with k valid
    for part in ("fwd", "lse", "dq", "dkv"):
        key = "" if part == "fwd" else f"{part}_"
        row[f"{key}bound_ms"], row[f"{key}bound_by"] = _bound(part, b, t, t, pairs, 2, h, d)
    return row


def phase_scaled_kernels(device) -> list:
    """Phase 19: the scaled causal kernels (kernels 1s, 3s, 4s at head width
    128 and 64, and the long route's 2, 5, 6, 7 in this mode) against their
    plain versions at ``SCALED_CASES``, fp32 and bf16."""
    import torch

    from reprover_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(19)
    rows = []
    for b, t, h, d, block_kv, left_pad in SCALED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            row = _scaled_row(tfa, b, t, h, d, block_kv, left_pad, dtype, gen, device)
            log(f"[scaled_kernel] {json.dumps(row)}")
            rows.append(row)
            torch.cuda.empty_cache()
    _check_rows(rows, "the scaled causal kernels")
    return rows


def _finetune_cfg(device, tiny: bool, flash: bool = True):
    from reprover_tpu_torch.models.causal_lm import CausalLMConfig
    from reprover_tpu_torch.models.t5 import default_dtype

    dtype = default_dtype(device)
    if tiny:
        return CausalLMConfig(vocab_size=512, d_model=64, num_layers=2, num_heads=2,
                              num_kv_heads=2, d_ff=128, compute_dtype=dtype,
                              flash_attention=flash)
    return CausalLMConfig(num_layers=FINETUNE["layers"], compute_dtype=dtype,
                          flash_attention=flash)


def phase_finetune(device, work: str, bench: str, tiny: bool = False) -> dict:
    """Phase 20: decoder-only fine-tuning at LLaMA-7B width (depth 4) through
    the port's entry points: ``CausalGeneratorDataModule`` over the phase-4
    benchmark with phase 10's ``predictions.pickle`` and a BPE tokenizer
    trained on the corpus, seeded float32 masters made on the card,
    ``init_train_state`` / ``make_train_step`` over ``causal_lm_loss`` with
    ``flash_attention`` on (bf16 products); every loss finite, the three
    scaled causal kernels launched; then ``causal_validation_metrics`` on one
    validation batch (greedy)."""
    import torch

    from reprover_tpu_torch.benchmarks.causal_finetune_step import batch_loss
    from reprover_tpu_torch.generation import CausalGeneratorDataModule
    from reprover_tpu_torch.generation.causal_generator import CausalTacticGeneratorModel
    from reprover_tpu_torch.generation.validate import causal_validation_metrics
    from reprover_tpu_torch.models.causal_lm import init_params, place_params
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.training.tasks import (
        init_train_state, make_train_step, numeric_batch,
    )

    t0 = time.perf_counter()
    tok = _tactic_tokenizer(bench, 300 if tiny else FINETUNE["bpe_vocab"])
    preds = os.path.join(work, "logs", "predictions.pickle")
    max_len = 256 if tiny else FINETUNE["max_seq_len"]
    dm = CausalGeneratorDataModule(
        os.path.join(bench, "random"), tok, FINETUNE["batch_size"], FINETUNE["batch_size"],
        max_len, 0.5, corpus_path=os.path.join(bench, "corpus.jsonl"), preds_path=preds,
        bucket_multiple=FINETUNE["bucket_multiple"], seed=FINETUNE["seed"])
    dm.setup("fit")
    cfg = _finetune_cfg(device, tiny)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(FINETUNE["seed"]))
    state = init_train_state(params, FINETUNE["lr"], warmup_steps=0)
    step = make_train_step(batch_loss, cfg)
    setup_s = time.perf_counter() - t0
    reset_all_launch_counts()
    losses, shapes = [], set()
    t0 = time.perf_counter()
    for _, host in zip(range(FINETUNE["steps"]), dm.train_dataloader()):
        batch = numeric_batch({k: host[k] for k in ("input_ids", "attention_mask", "labels")},
                              device)
        shapes.add(tuple(batch["input_ids"].shape))
        state, loss = step(state, batch)
        losses.append(loss)
    losses = [float(x) for x in losses]
    _sync(device)
    train_s = time.perf_counter() - t0
    launches = {k: n for k, n in all_launch_counts().items() if n}
    with torch.no_grad():
        served = place_params(state.params, cfg, device)
    model = CausalTacticGeneratorModel(served, cfg, tok, max_inp_seq_len=max_len,
                                       max_oup_seq_len=FINETUNE["max_oup_seq_len"])
    t0 = time.perf_counter()
    val = causal_validation_metrics(model, dm.val_dataloader(), num_beams=1, limit_batches=1)
    _sync(device)
    report = dict(layers=cfg.num_layers, d_model=cfg.d_model, heads=cfg.num_heads,
                  head_dim=cfg.head_dim, setup_s=setup_s, train_s=train_s, steps=len(losses),
                  shapes=sorted(shapes), losses=losses, launches=launches, validation=val,
                  validation_s=time.perf_counter() - t0, tokenizer_vocab=tok.vocab_size)
    if device.type == "cuda":
        report["max_memory_allocated_GiB"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[finetune] {json.dumps(report)}")
    if len(losses) != FINETUNE["steps"] or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fine-tuning losses: {losses}")
    if not math.isfinite(val["loss_val"]) or "top1_acc_val" not in val:
        raise AssertionError(f"causal_validation_metrics: {val}")
    needed = ["scaled_causal_attn" + p for p in SCALED_PARTS]
    if device.type == "cuda" and min(launches.get(n, 0) for n in needed) < 1:
        raise AssertionError(f"fine-tuning missed a scaled causal kernel: {launches}")
    del state, params, served, model
    _empty_cache(device)
    return report


def phase_finetune_steps(device, tiny: bool = False) -> dict:
    """Phase 21: ``benchmarks/causal_finetune_step.py``'s fixed ragged batch,
    plain attention then flash, ``FINETUNE["fixed_steps"]`` steps each from
    the same seeded weights, at LLaMA-7B width (depth 4) [4, 2048] and at
    the JAX benchmark's geometry [8, 2048]: timed by part, peak memory, the
    attention kernels' share of a profiled flash step; the loss must fall
    both ways and the first losses agree within 2e-2 relative (bf16)."""
    from reprover_tpu_torch.benchmarks import causal_finetune_step as cfs

    report: dict = {}
    runs = [("llama7b", 4, 2048, None), ("jax", 8, 2048, None)]
    if tiny:
        runs = [("jax", 2, 256, 1)]
    for geometry, b, t, layers in runs:
        rows = {}
        for flash in (False, True):
            state, cfg, batch = cfs.setup(geometry, flash, device, layers, b, t, True,
                                          FINETUNE["seed"], FINETUNE["lr"])
            row = dict(geometry=geometry, flash=flash, B=b, T=t, layers=cfg.num_layers,
                       head_dim=cfg.head_dim,
                       **cfs.run_steps(state, cfg, batch, FINETUNE["fixed_steps"]))
            if flash and device.type == "cuda":
                row.update(_profiled_share(state, cfs.batch_loss, cfg, batch, device))
            log(f"[finetune_step] {json.dumps(row)}")
            rows[flash] = row
            del state, batch
            _empty_cache(device)
        for row in rows.values():
            if not row["losses"][-1] < row["losses"][0]:
                raise AssertionError(f"the loss on the fixed batch did not fall: {row}")
        first = (rows[False]["losses"][0], rows[True]["losses"][0])
        if abs(first[1] - first[0]) > 2e-2 * abs(first[0]):
            raise AssertionError(f"plain and flash first-step losses differ: {first}")
        report[geometry] = rows
    return report


def phase_bisect(device) -> dict:
    """Phase 22: kernel 14's ablation variants against their plain versions
    (``flash_kernel_bisect.variant_error``: fp32 within 1e-4, bf16 within
    2e-2, of max|ref| for the largest error and of the output's norm for the
    error's), fp32 and bf16, at ``BISECT_CHECK`` (a ragged key mask for the
    softmax variants, all keys for ``nosoftmax``, whose masked keys add
    -1e10, and ``matmulonly``, which has no mask) and for one layer at the
    sweep's own operands; ``full`` bit-equal to kernel 1
    (``encoder_flash_attention``) at both; then the harness's default sweep
    (``python -m reprover_tpu_torch.benchmarks.flash_kernel_bisect
    --block-kv 64``: [64, 1024] x 6 x 64, 12 layers, bf16) with its launch
    counts, and each variant's plain version and library call at that
    shape."""
    import torch
    import torch.nn.functional as F

    from reprover_tpu_torch.benchmarks import flash_kernel_bisect as fkb
    from reprover_tpu_torch.ops import flash_attention as tfa

    torch.backends.cuda.matmul.allow_tf32 = False
    argv = ["--block-kv", "64"]
    args = fkb.parser().parse_args(argv)
    gen = torch.Generator(device=device).manual_seed(22)
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(_attention_case(*BISECT_CHECK, BISECT_CHECK[1], dtype, gen, device),
                  NUM_HEADS),
                 (fkb.make_inputs(args.batch, args.seq, args.heads, device, dtype), args.heads)]
        for (q, k, v, mask, rel), heads in cases:
            for variant in fkb.VARIANTS:
                m = mask if variant in ("full", "nobias", "sharedcmp") else torch.ones_like(mask)
                got = fkb.bisect_attention(variant, q, k, v, m, rel, heads)
                check = fkb.variant_error(
                    got, fkb.bisect_attention_reference(variant, q, k, v, m, rel, heads))
                if variant == "full":
                    check["ok"] &= torch.equal(
                        got, tfa.encoder_flash_attention(q, k, v, m, rel, heads))
                checks.append(dict(variant=variant, dtype=str(dtype).replace("torch.", ""),
                                   shape=list(q.shape), **check))
        del cases, got
        _empty_cache(device)
    log(f"[bisect] checks {json.dumps(checks)}")
    if not all(c["ok"] for c in checks):
        raise AssertionError(f"kernel 14's variants disagree with their plain versions: {checks}")

    reset_all_launch_counts()
    sweep = fkb.main(argv)
    _sync(device)
    launches = dict(fkb.KERNEL_LAUNCHES)
    q, k, v, mask, rel = fkb.make_inputs(args.batch, args.seq, args.heads, device)
    same = torch.equal(
        fkb.run_layers(lambda *a: tfa.encoder_flash_attention(*a, args.heads), args.layers, q,
                       k, v, mask, rel),
        fkb.run_layers(fkb.variant_fn("full", args.heads), args.layers, q, k, v, mask, rel))
    heads = [t.view(args.batch, args.seq, args.heads, fkb.D).transpose(1, 2) for t in (q, k, v)]
    library = {
        "full": tfa._bucket_bias(rel, args.seq, True, fkb.NB, fkb.MAXD).to(torch.bfloat16),
        "sharedcmp": fkb._tile_bias(rel, args.seq, fkb.NB, fkb.MAXD).to(torch.bfloat16),
        "nobias": None,
    }
    pairs = args.batch * args.seq * args.seq
    rows = {}
    with torch.no_grad():
        for r in sweep:
            name = r["variant"]
            if name not in fkb.VARIANTS:
                continue
            row = dict(ms=r["ms_per_layer"], launches=launches[f"bisect_{name}"],
                       plain_ms=_time_ms(lambda: fkb.bisect_attention_reference(
                           name, q, k, v, mask, rel, args.heads), 3),
                       library_ms=None)
            if name in library:
                row["library_ms"] = _time_ms(lambda: F.scaled_dot_product_attention(
                    *heads, attn_mask=library[name], scale=1.0), 10)
            row["bound_ms"], row["bound_by"] = _bound("fwd", args.batch, args.seq, args.seq,
                                                      pairs, 2, args.heads, fkb.D)
            rows[name] = row
    report = dict(sweep=sweep, variants=rows, checks=checks, production_equals_full=same)
    log(f"[bisect] {json.dumps(report)}")
    if not same or min(launches.values()) < 1:
        raise AssertionError(f"the bisect sweep: {report}")
    return report


# The TPU kernel each of the nine replaces (file:line of its pallas_call or
# kernel function in the JAX package).
# Phase 23: the remat policies at three fixed train steps (the generator's
# at [8, 2304] -> [8, 512] and at [4, 8192] -> [4, 512], the retriever's at
# the 1024 cap), each policy for REMAT["steps"] steps from the same weights,
# then remat full with Adam's moments in host memory. Phase 24:
# span-corruption pretraining through its CLI at the JAX package's defaults
# (byt5-small, [8, 1024] -> [8, 256]).
REMAT = dict(steps=6, offload_opt_steps=4, policies=("full", "lite", "offload"))
OFFLOAD_OPT = "full+offload_optimizer"
PRETRAIN = dict(steps=20, offload_steps=5, log_interval=5, finetune_steps=2)


def _retriever_cap_batch(device) -> dict:
    """Phase 8's batch at the cap: contexts [8, 1024] and premises [32,
    1024] of random bytes, ragged, each context's own premise positive."""
    import numpy as np

    from reprover_tpu_torch.training.tasks import numeric_batch

    b = TRAIN["batch_size"]
    n = b * (1 + TRAIN["num_negatives"])
    label = np.zeros((b, n), np.float32)
    label[np.arange(b), np.arange(b)] = 1.0
    layout = {"context_ids": np.zeros((b, 1), np.int32), "premise_ids": np.zeros((n, 1), np.int32),
              "label": label}
    return numeric_batch(_long_batch(layout, TRAIN["seed"]), device)


def _remat_cases(device, tiny: bool) -> list:
    """(tag, loss function, model config, fused CPU params, batch, the
    forward kernels of its route with their calls per step under a
    selective policy). The long step is left out at the tiny width (its
    plain version at 8192 is minutes on the CPU)."""
    import torch

    from reprover_tpu_torch.models.t5 import fuse_mlp_params, init_params
    from reprover_tpu_torch.training.tasks import generation_loss, retrieval_infonce_loss

    cfg = _generator_cfg(device, tiny)
    enc, dec = cfg.num_encoder_layers, cfg.num_decoder_layers
    params = fuse_mlp_params(init_params(cfg, torch.Generator().manual_seed(GEN["seed"])))
    encoder = {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}
    cases = [("gen", generation_loss, cfg, params, _generator_batch(GEN, device),
              {"encoder_attn": enc, "causal_attn": dec, "cross_attn": dec})]
    if not tiny:
        cases.append(("long_gen", generation_loss, cfg, params, _generator_batch(LONG_GEN, device),
                      {"encoder_attn_long": enc, "causal_attn": dec, "cross_attn_long": dec}))
    cases.append(("retriever_cap", retrieval_infonce_loss, cfg, encoder,
                  _retriever_cap_batch(device), {"encoder_attn": enc}))
    return cases


def _flat_map(fn, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: _flat_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _grad_error(got: list, want: list) -> float:
    """Largest |got - want| of any leaf over max(1, max|want|) of that leaf."""
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def _policy_run(policy: str, loss_fn, cfg, params: dict, batch: dict, device,
                record_all: bool, profile: bool) -> tuple:
    """One policy's steps from ``params`` -> (row, the first step's
    gradients on the host, every step's gradients on the host if
    ``record_all``, final parameters, launches). The gradients are copied
    between backward and update, outside the timed parts; the peak covers
    the steps alone. ``profile``: one more step under the profiler, its
    device time and top kernels."""
    import dataclasses

    import torch

    from reprover_tpu_torch.models.t5 import place_master_params
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.training.tasks import (
        init_train_state, offload_opt_state, param_leaves, timed_train_steps,
    )

    offload_opt = policy == OFFLOAD_OPT
    run_cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy.split("+")[0])
    # A copy on every device (on the CPU, placing alone would alias params).
    placed = place_master_params(_flat_map(lambda t: t.clone(), params), device)
    state = init_train_state(placed, GEN["lr"], warmup_steps=0)
    if offload_opt:
        state = offload_opt_state(state)
    steps = REMAT["offload_opt_steps"] if offload_opt else REMAT["steps"]
    first: dict = {}
    grads: list = []

    def after_backward(i: int, st) -> None:
        if i == 0:
            first["launches"] = {k: n for k, n in tfa.KERNEL_LAUNCHES.items() if n}
        if i == 0 or record_all:
            grads.append([p.grad.detach().to("cpu") for p in param_leaves(st.params)])

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tfa.reset_launch_counts()
    timed = timed_train_steps(state, loss_fn, run_cfg, batch, steps, after_backward)
    launches = dict(tfa.KERNEL_LAUNCHES)
    losses = [float(t[0]) for t in timed]
    warm = timed[2:]
    row = dict(policy=policy, losses=losses,
               forward_ms=[t[1] for t in timed], backward_ms=[t[2] for t in timed],
               optimizer_ms=[t[3] for t in timed],
               mean_forward_ms=sum(t[1] for t in warm) / len(warm),
               mean_backward_ms=sum(t[2] for t in warm) / len(warm),
               mean_optimizer_ms=sum(t[3] for t in warm) / len(warm),
               step1_attention_launches=first["launches"])
    row["mean_step_ms"] = row["mean_forward_ms"] + row["mean_backward_ms"] + row["mean_optimizer_ms"]
    # One slow host step (it delays the launches the events bracket) moves a
    # mean of eight by tens of ms; the medians are the rows to compare.
    for i, part in enumerate(("forward", "backward", "optimizer", "step"), 1):
        row[f"median_{part}_ms"] = statistics.median(
            sum(t[1:4]) if part == "step" else t[i] for t in warm)
    if cuda:
        row["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        if profile:
            row.update(_profiled_share(state, loss_fn, run_cfg, batch, device))
    final = [p.detach() for p in param_leaves(state.params)]
    return row, grads[0], grads, final, launches


def phase_remat(device, tiny: bool = False) -> dict:
    """Remat ``full``, ``lite`` and ``offload`` at three fixed steps, each
    for ``REMAT["steps"]`` steps from the same weights (lr 1e-4, no warmup),
    then ``full`` with ``offload_optimizer`` for ``REMAT["offload_opt_steps"]``:
    per step forward / backward / optimizer ms by CUDA events, peak GiB and
    each attention kernel's launches in the first step. Fails unless each
    forward kernel of the route launches once per layer per step under
    ``lite`` and ``offload`` and twice under ``full`` (the backward kernels
    once either way), the first step's losses are bit-equal across the
    policies, every gradient leaf after one step lies within 2e-2 of
    ``full``'s relative to max(1, max|ref|), the losses are finite and fall,
    and with the moments in host memory the parameters after the steps are
    bit-equal to the on-device optimizer's on the same gradients (replayed)
    while the peak is lower by at least half the moments' bytes."""
    import torch

    from reprover_tpu_torch.training.optim import AdamWClip
    from reprover_tpu_torch.training.tasks import param_leaves

    cuda = device.type == "cuda"
    results: dict = {}
    launches: dict = {}
    for tag, loss_fn, cfg, params, batch, forward_kernels in _remat_cases(device, tiny):
        n_params = sum(t.numel() for t in param_leaves(params))
        rows, first_grads = {}, {}
        for policy in REMAT["policies"] + (OFFLOAD_OPT,):
            row, grads0, grads, final, run_launches = _policy_run(
                policy, loss_fn, cfg, params, batch, device, record_all=policy == OFFLOAD_OPT,
                profile=tag == "gen" and policy != OFFLOAD_OPT)
            for name, n in run_launches.items():
                launches[name] = launches.get(name, 0) + n
            if policy != "full":
                row["grad_error_vs_full"] = _grad_error(grads0, first_grads["full"])
            first_grads[policy] = grads0
            if policy == OFFLOAD_OPT:
                # The on-device optimizer on the same gradients, from the same weights.
                leaves = [t.to(device, copy=True).requires_grad_(True)
                          for t in param_leaves(params)]
                ref = AdamWClip(leaves, GEN["lr"], 0)
                for step_grads in grads:
                    for p, g in zip(leaves, step_grads):
                        p.grad = g.to(device)
                    ref.step()
                row["params_bit_equal"] = all(torch.equal(a, b) for a, b in zip(final, leaves))
                del leaves, ref
            del grads, final
            if cuda:
                torch.cuda.empty_cache()
            rows[policy] = row
            log(f"[remat] {tag} {json.dumps(row)}")
            expected = 1 if policy in ("lite", "offload") else 2
            got = row["step1_attention_launches"]
            for name, layers in forward_kernels.items():
                if cuda and (got.get(name, 0) != expected * layers
                             or got.get(name + "_bwd_dq", 0) != layers
                             or got.get(name + "_bwd_dkv", 0) != layers):
                    raise AssertionError(
                        f"{tag} {policy}: {name} launched {got.get(name, 0)} times in one step "
                        f"(expected {expected} per layer, {layers} layers), its backward "
                        f"kernels {got.get(name + '_bwd_dq', 0)} and "
                        f"{got.get(name + '_bwd_dkv', 0)} (expected {layers})")
            losses = row["losses"]
            if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
                raise AssertionError(f"{tag} {policy}: losses not finite or not falling: {losses}")
            if row.get("grad_error_vs_full", 0.0) > BF16_REL_TOL:
                raise AssertionError(f"{tag} {policy}: a gradient leaf differs from full's by "
                                     f"{row['grad_error_vs_full']} of max(1, max|ref|)")
        first = {p: rows[p]["losses"][0] for p in rows}
        if len(set(first.values())) != 1:
            raise AssertionError(f"{tag}: first-step losses differ across the policies: {first}")
        off = rows[OFFLOAD_OPT]
        if not off["params_bit_equal"]:
            raise AssertionError(f"{tag}: parameters with the moments in host memory differ from "
                                 f"the on-device optimizer's")
        moments_gib = 2 * 4 * n_params / 2**30
        if cuda:
            saved = rows["full"]["peak_GiB"] - off["peak_GiB"]
            log(f"[remat] {tag} offload_optimizer: peak {rows['full']['peak_GiB']:.3f} -> "
                f"{off['peak_GiB']:.3f} GiB (moments {moments_gib:.3f} GiB, {n_params} "
                f"parameters), optimizer {rows['full']['mean_optimizer_ms']:.2f} -> "
                f"{off['mean_optimizer_ms']:.2f} ms")
            if saved < moments_gib / 2:
                raise AssertionError(f"{tag}: offload_optimizer lowered the peak by {saved:.3f} "
                                     f"GiB, less than half the moments' {moments_gib:.3f}")
        results[tag] = dict(rows=rows, n_params=n_params, moments_GiB=moments_gib)
        del params, batch
    results["launches"] = launches
    return results


def _without_safetensors(fn, *args):
    """``fn(*args)`` with the ``safetensors`` package unimportable."""
    hidden = {name: sys.modules.pop(name) for name in list(sys.modules)
              if name == "safetensors" or name.startswith("safetensors.")}
    sys.modules["safetensors"] = None
    try:
        return fn(*args)
    finally:
        del sys.modules["safetensors"]
        sys.modules.update(hidden)


def phase_pretrain(device, work: str, bench: str, tiny: bool = False) -> dict:
    """Span-corruption pretraining through its CLI on the phase-4 corpus:
    byt5-small width (bf16 over fp32 masters, seeded random init) at the
    defaults ([8, 1024] -> [8, 256], lr 1e-3 with 1000 warmup steps, the
    divergence guard on), remat ``lite``, ``PRETRAIN["steps"]`` steps, one
    validation and ``--export_dir``; every logged loss finite, ``loss_val``,
    ``emb_eff_rank`` and ``cos_offdiag_std`` logged, the nine full-row
    attention kernels launched, the export reloaded through the port's
    ``load_hf_t5`` with ``safetensors`` unimportable and bit-equal to the
    trained parameters. Then ``generation.main fit --model.model_name
    <export>`` (phase 10's data) for ``PRETRAIN["finetune_steps"]`` steps, and
    pretraining for ``PRETRAIN["offload_steps"]`` steps with remat
    ``offload`` and ``offload_optimizer``. ms per step (the log windows'
    wall time) and peak GiB of each run."""
    import torch

    from reprover_tpu_torch.generation.main import main as generation_main
    from reprover_tpu_torch.models.hf_import import load_hf_t5
    from reprover_tpu_torch.models.t5 import fuse_mlp_params
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.training.pretrain import PretrainDataModule
    from reprover_tpu_torch.training.pretrain import main as pretrain_main

    cuda = device.type == "cuda"
    corpus = os.path.join(bench, "corpus.jsonl")
    dm = PretrainDataModule(corpus)
    log(f"[pretrain] stream {len(dm.train_ids)} train and {len(dm.val_ids)} val bytes, window "
        f"{dm.window}")
    if len(dm.val_ids) <= dm.window:
        raise AssertionError("the corpus's held-out tail is shorter than one window")
    out = os.path.join(work, "pretrain")
    export = os.path.join(out, "hf")
    launches: dict = {}

    def run(tag: str, fn, argv: list, log_dir: str, steps: int) -> tuple:
        tfa.reset_launch_counts()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = fn(["fit"] + argv)
        _sync(device)
        fit_s = time.perf_counter() - t0
        run_launches = dict(tfa.KERNEL_LAUNCHES)
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        sps = [r["steps_per_sec"] for r in recs if "steps_per_sec" in r]
        val = [r for r in recs if "loss_val" in r]
        row = dict(run=tag, steps=state.step, fit_s=fit_s, losses=losses,
                   ms_per_step=[1e3 / x for x in sps], validation=val[-1] if val else None,
                   launches={k: n for k, n in run_launches.items() if n})
        if cuda:
            row["peak_GiB"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"[pretrain] {json.dumps(row)}")
        if state.step != steps or not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{tag}: ran {state.step} steps, losses {losses}")
        return state, row

    def pretrain_argv(tag: str, steps: int, extra: list) -> tuple:
        log_dir = os.path.join(out, tag)
        return (["--device", device.type, "--data.data_path", corpus,
                 "--trainer.max_steps", str(steps), "--trainer.val_interval", str(steps),
                 "--trainer.log_interval", str(PRETRAIN["log_interval"]), "--log_dir", log_dir]
                + (["--model.tiny", "true"] if tiny else []) + extra, log_dir)

    argv, log_dir = pretrain_argv("lite", PRETRAIN["steps"],
                                  ["--model.remat_policy", "lite", "--export_dir", export])
    state, lite = run("lite", pretrain_main, argv, log_dir, PRETRAIN["steps"])
    if not lite["validation"] or not {"emb_eff_rank", "cos_offdiag_std"} <= set(lite["validation"]):
        raise AssertionError("metrics.jsonl lacks loss_val, emb_eff_rank or cos_offdiag_std")
    if cuda and min(lite["launches"].get(name, 0) for name in FULL_ROW_KERNELS) < 1:
        raise AssertionError(f"pretraining did not launch every full-row kernel: "
                             f"{lite['launches']}")
    loaded, _ = _without_safetensors(load_hf_t5, export)
    loaded = _flat(fuse_mlp_params(loaded))
    trained = {name: t.detach().cpu() for name, t in _flat(state.params).items()}
    mismatched = [name for name, t in trained.items() if not torch.equal(loaded[name], t)]
    if set(loaded) != set(trained) or mismatched:
        raise AssertionError(f"the export reloaded different parameters: {mismatched}")
    log(f"[pretrain] export reloaded without safetensors: {len(trained)} tensors bit-equal")
    del state, loaded, trained

    preds = os.path.join(work, "logs", "predictions.pickle")
    gen = dict(GEN, eval_batch_size=8)
    argv = _gen_argv(device, os.path.join(out, "finetune"), bench, preds, tiny, gen)
    init = argv.index("--model.tiny" if tiny else "--model.random_init")
    argv[init:init + 2] = ["--model.model_name", export]
    steps = PRETRAIN["finetune_steps"]
    argv += ["--trainer.max_steps", str(steps), "--trainer.val_interval", str(steps),
             "--trainer.log_interval", "1", "--trainer.monitor", "loss_val",
             "--trainer.monitor_mode", "min", "--trainer.patience", "99"]
    state, finetune = run("finetune_from_export", generation_main, argv,
                          os.path.join(out, "finetune", "glogs"), steps)
    del state

    argv, log_dir = pretrain_argv("offload", PRETRAIN["offload_steps"],
                                  ["--model.remat_policy", "offload",
                                   "--model.offload_optimizer", "true"])
    state, offload = run("offload", pretrain_main, argv, log_dir, PRETRAIN["offload_steps"])
    if not state.optimizer.offload_moments:
        raise AssertionError("--model.offload_optimizer true left the moments on the device")
    del state
    return dict(lite=lite, finetune=finetune, offload=offload, launches=launches)


EVAL = dict(num_retrieved=100, bm25_cpus=4, r10_tol=0.5, mrr_tol=0.005, embed_batch=16,
            index_batch=64, index_max_seq_len=1024)
LOAD = dict(workers=16, slots=8, chunk=8, beams=64, theorems=8, max_expansions=2,
            latent_theorems=16, latent_max_expansions=0, latent_beams=8, latencies=(0.0, 2.0),
            profile_window_s=3.0)


def _evaluate_cli(preds: str, data_path: str) -> dict:
    """``python -m reprover_tpu_torch.retrieval.evaluate`` in this process:
    its printed lines -> ``{split: (R@1, R@10, MRR)}``."""
    import contextlib
    import io

    from reprover_tpu_torch.retrieval.evaluate import main as evaluate_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        evaluate_main(["--preds-file", preds, "--data-path", data_path])
    rows = {}
    for line in out.getvalue().splitlines():
        m = re.match(r"(\w+): R@1 = (\S+) %, R@10 = (\S+) %, MRR = (\S+)$", line)
        if m:
            rows[m.group(1)] = tuple(float(m.group(i)) for i in (2, 3, 4))
    if set(rows) != {"train", "val", "test"}:
        raise AssertionError(f"evaluate printed {out.getvalue()!r}")
    for split, (r1, r10, mrr) in rows.items():
        if not (0 <= r1 <= 100 and 0 <= r10 <= 100 and 0 <= mrr <= 1) or not all(
                math.isfinite(x) for x in (r1, r10, mrr)):
            raise AssertionError(f"evaluate's {split} numbers are out of range: {rows[split]}")
    return rows


def phase_evaluate(device, work: str, bench: str, validation: dict, tiny: bool = False) -> dict:
    """Phase 25: the evaluation harnesses on phase 7's retriever.

    ``retrieval.evaluate`` on phase 10's ``predictions.pickle`` (every
    split, 40 premises a tactic: the corpus's first files see only 43), its
    numbers finite and in range; ``retrieval.main predict`` of the val split
    alone at the 100 premises phase 7's validation retrieved (a split
    directory whose train and test files are empty), whose val R@10 and MRR
    must lie within 0.5 points and 0.005 of the ``Recall@10_val`` and
    ``MRR`` that phase 7 logged for the same weights (the two paths embed
    the same contexts in different bf16 batches, so near-ties may flip);
    then the BM25 baseline (``retrieval.bm25 train-tokenizer`` and
    ``retrieve`` in a pool of 4) scored the same way beside the dense
    retriever; then ``scripts.convert_checkpoint retriever`` on phase 7's
    checkpoint, reloaded with ``load_hf_t5``: every parameter and one batch
    of premise embeddings through kernel 1 bit-equal to the checkpoint's;
    then the indexer CLI's ``main`` on one card over the converted
    checkpoint and the corpus (batch 64, ``max_seq_len`` 1024: the JAX
    indexer's defaults) and the val queries at 100 premises through
    ``PremiseRetriever.load_hf`` of it over that artifact: 100 premises
    each, finite descending scores."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from reprover_tpu_torch.models.hf_import import hf_config, load_hf_t5
    from reprover_tpu_torch.models.t5 import T5Config, byt5_small, fuse_mlp_params, place_params
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.retrieval import PremiseRetriever, build_preds_map, evaluate_split
    from reprover_tpu_torch.data.interop import load_reference_pickle
    from reprover_tpu_torch.retrieval.bm25 import main as bm25_main
    from reprover_tpu_torch.retrieval.main import main as retrieval_main
    from reprover_tpu_torch.scripts.convert_checkpoint import main as convert_main

    data_path = os.path.join(bench, "random")
    out = os.path.join(work, "evaluate")
    os.makedirs(os.path.join(out, "logs"), exist_ok=True)
    tfa.reset_launch_counts()
    report: dict = {}
    dense = _evaluate_cli(os.path.join(work, "logs", "predictions.pickle"), data_path)
    report["dense_k40"] = dense

    # The val split alone at phase 7's 100 premises, against its validation.
    view = os.path.join(out, "val_only", "random")
    os.makedirs(view, exist_ok=True)
    shutil.copy(os.path.join(data_path, "val.json"), os.path.join(view, "val.json"))
    for split in ("train", "test"):
        with open(os.path.join(view, f"{split}.json"), "w") as f:
            json.dump([], f)
    argv = _fit_argv(device, out, bench, tiny)
    argv[argv.index("--data.data_path") + 1] = view
    retrieval_main(["predict"] + argv + [
        "--ckpt_dir", os.path.join(work, "ckpts"), "--preds_out", "val_predictions.pickle",
        "--model.num_retrieved", str(EVAL["num_retrieved"])])
    with open(os.path.join(data_path, "val.json")) as f:
        val = json.load(f)
    r1, r10, mrr = evaluate_split(val, build_preds_map(load_reference_pickle(
        os.path.join(out, "logs", "val_predictions.pickle"))))
    report["dense_val_k100"] = dict(r1=r1, r10=r10, mrr=mrr)
    gap = dict(r10=r10 - validation["Recall@10_val"], mrr=mrr - validation["MRR"])
    report["gap_to_phase7"] = gap
    log(f"[evaluate] dense (phase 10's pickle, 40 premises) {json.dumps(dense)}; val at 100 "
        f"premises R@1 {r1} R@10 {r10} MRR {mrr}; phase 7 logged R@10 "
        f"{validation['Recall@10_val']} MRR {validation['MRR']}; gap {json.dumps(gap)}")
    if abs(gap["r10"]) > EVAL["r10_tol"] or abs(gap["mrr"]) > EVAL["mrr_tol"]:
        raise AssertionError(f"evaluate's val R@10/MRR differ from phase 7's validation by "
                             f"{gap} (limits {EVAL['r10_tol']} points, {EVAL['mrr_tol']})")

    # BM25 on the same benchmark, scored by the same evaluator.
    t0 = time.perf_counter()
    tok = os.path.join(out, "bm25.tok")
    bm25_main(["train-tokenizer", "--data-path", data_path, "--output-path", tok])
    bm25_preds = os.path.join(out, "bm25_predictions.pickle")
    bm25_main(["retrieve", "--tokenizer-path", tok, "--data-path", data_path,
               "--output-path", bm25_preds, "--num-cpus", str(EVAL["bm25_cpus"])])
    bm25 = _evaluate_cli(bm25_preds, data_path)
    report["bm25"], report["bm25_s"] = bm25, time.perf_counter() - t0
    for split in ("train", "val", "test"):
        log(f"[evaluate] {split}: R@1 / R@10 / MRR dense {dense[split][0]:.4f} / "
            f"{dense[split][1]:.4f} / {dense[split][2]:.4f}, BM25 {bm25[split][0]:.4f} / "
            f"{bm25[split][1]:.4f} / {bm25[split][2]:.4f}")

    # The checkpoint converted to an HF directory and reloaded.
    cfg = (T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                    num_decoder_layers=1) if tiny else byt5_small())
    geometry = os.path.join(out, "geometry")
    os.makedirs(geometry, exist_ok=True)
    with open(os.path.join(geometry, "config.json"), "w") as f:
        json.dump(hf_config(cfg, encoder_only=True), f)
    hf_dir = os.path.join(out, "hf_retriever")
    convert_main(["retriever", "--src", os.path.join(work, "ckpts"), "--hf-config", geometry,
                  "--dst", hf_dir])
    step = max(int(s) for s in os.listdir(os.path.join(work, "ckpts")) if s.isdigit())
    saved = torch.load(os.path.join(work, "ckpts", str(step), "state.pt"), map_location="cpu",
                       weights_only=True)["params"]
    loaded, loaded_cfg = load_hf_t5(hf_dir, encoder_only=True)
    loaded = fuse_mlp_params(loaded)
    flat_saved, flat_loaded = _flat(saved), _flat(loaded)
    unequal = [n for n, t in flat_saved.items()
               if n not in flat_loaded or not torch.equal(flat_loaded[n], t)]
    if unequal or loaded_cfg.d_model != cfg.d_model:
        raise AssertionError(f"the converted checkpoint differs from phase 7's: {unequal}")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    ecfg = dataclasses.replace(loaded_cfg, compute_dtype=dtype)
    with open(os.path.join(bench, "corpus.jsonl")) as f:
        first = json.loads(f.readline())
    texts = [p["code"] for p in first["premises"][: EVAL["embed_batch"]]]
    before = tfa.KERNEL_LAUNCHES["encoder_attn"]
    embs = []
    for params in ({"shared_embedding": saved["shared_embedding"], "encoder": saved["encoder"]},
                   loaded):
        retriever = PremiseRetriever(place_params(params, ecfg, device), ecfg,
                                     max_seq_len=TRAIN["max_seq_len"])
        embs.append(torch.from_numpy(retriever.encode_strings(texts)))
        _sync(device)
    launched = tfa.KERNEL_LAUNCHES["encoder_attn"] - before
    if not torch.equal(embs[0], embs[1]) or not bool(torch.isfinite(embs[0]).all()):
        raise AssertionError("the converted checkpoint's embeddings differ from phase 7's")
    if device.type == "cuda" and launched < 2:
        raise AssertionError(f"the converted checkpoint's encode launched kernel 1 "
                             f"{launched} times")
    log(f"[evaluate] convert_checkpoint retriever: {len(flat_saved)} tensors and a "
        f"[{len(texts)}] embedding batch bit-equal ({launched} kernel-1 launches); BM25 "
        f"took {report['bm25_s']:.1f}s")

    # The converted checkpoint indexed on one card by the indexer CLI (its
    # main, which ``python -m reprover_tpu_torch.retrieval.indexer`` runs),
    # then the val queries through ``load_hf`` of it over the artifact.
    index = dict(ckpt=hf_dir, corpus=os.path.join(bench, "corpus.jsonl"),
                 path=os.path.join(out, "indexed"))
    index.update(_run_indexer(index_argv(index, device) + ["--output-path", index["path"]]))
    retriever = PremiseRetriever.load_hf(hf_dir, EVAL["index_max_seq_len"], device=device)
    retriever.load_corpus(index["path"])
    contexts = val_contexts(val)
    premises, scores = retriever.retrieve_batch(contexts, EVAL["num_retrieved"])
    scores = np.asarray(scores)
    if retriever.embeddings_staled or any(len(row) != EVAL["num_retrieved"] for row in premises) \
            or not np.isfinite(scores).all() or (np.diff(scores, axis=1) > 0).any():
        raise AssertionError("the one-card index does not reload into a query-ready retriever")
    log(f"[evaluate] indexer on one card: {index['premises_per_s']} premises/s; reloaded: "
        f"{len(contexts)} val queries x {EVAL['num_retrieved']} premises, finite and descending")
    report["index"] = index
    report["launches"] = dict(tfa.KERNEL_LAUNCHES)
    return report


def index_argv(index: dict, device) -> list:
    """The indexer CLI's flags for ``index`` (its checkpoint and corpus) at
    the JAX indexer's defaults."""
    return ["--ckpt-path", index["ckpt"], "--corpus-path", index["corpus"], "--batch-size",
            str(EVAL["index_batch"]), "--max-seq-len", str(EVAL["index_max_seq_len"]),
            "--device", device.type]


def val_contexts(val: list) -> list:
    """The port's ``Context`` of every traced tactic of the val theorems."""
    from reprover_tpu_torch.data import Context, Pos

    return [Context(thm["file_path"], thm["full_name"], Pos.of(thm["start"]),
                    tac["state_before"]) for thm in val for tac in thm["traced_tactics"]]


def phase_attribution(device, bench: str, cfg, gen_params, ret_params, failed: list) -> dict:
    """Phase 26: Pass@1 failure attribution of phase 4's failed theorems
    (``SLICE["num_theorems"]`` val theorems at full width, 64 samples)
    through the card's ``RetrievalAugmentedTacticGenerator`` over phase 4's
    models and corpus;
    the bucket table; fails unless the counts sum to the failed theorems
    that have ``traced_tactics``, kernel 1 launched, and a second run gives
    identical records (the search is seeded, beam search deterministic)."""
    import dataclasses

    from reprover_tpu_torch.generation import TacticGeneratorModel
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.prover import (
        LocalTacticGenerator,
        RetrievalAugmentedTacticGenerator,
        attribute_failures,
    )
    from reprover_tpu_torch.retrieval import PremiseRetriever

    data_path = os.path.join(bench, "random")
    with open(os.path.join(data_path, "val.json")) as f:
        theorems = json.load(f)
    tfa.reset_launch_counts()
    retriever = PremiseRetriever(ret_params, cfg, max_seq_len=SLICE["max_inp_seq_len"])
    retriever.load_corpus(os.path.join(bench, "corpus.jsonl"))
    retriever.reindex_corpus(batch_size=32)
    generator = TacticGeneratorModel(gen_params, cfg, SLICE["max_inp_seq_len"],
                                     SLICE["max_oup_seq_len"])
    tac_gen = RetrievalAugmentedTacticGenerator(
        LocalTacticGenerator(generator, device=device.type), retriever,
        max_inp_seq_len=SLICE["max_inp_seq_len"], max_num_retrieved=100)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = attribute_failures(theorems, failed, tac_gen, SLICE["num_sampled_tactics"],
                                 corpus=retriever.corpus)
        _sync(device)
        runs.append((out, time.perf_counter() - t0))
    (out, seconds), (again, _) = runs
    by_name = {t["full_name"]: t for t in theorems}
    traced = [n for n in failed if by_name.get(n, {}).get("traced_tactics")]
    launches = tfa.KERNEL_LAUNCHES["encoder_attn"]
    records = [dataclasses.asdict(r) for r in out["records"]]
    log(f"[attribution] {len(failed)} failed theorems, buckets {json.dumps(out['counts'])} in "
        f"{seconds:.1f}s; first failing steps "
        f"{[r['first_failing_step'] for r in records]}; kernel-1 launches {launches}")
    if sum(out["counts"].values()) != len(traced) or len(records) != len(traced):
        raise AssertionError(f"attribution counted {out['counts']} for {len(traced)} traced "
                             f"failures")
    if records != [dataclasses.asdict(r) for r in again["records"]]:
        raise AssertionError("a second attribution run gave different records")
    if device.type == "cuda" and launches < 1:
        raise AssertionError("attribution did not launch the encoder-attention kernel")
    return dict(counts=out["counts"], seconds=seconds, failed=len(failed),
                launches=dict(tfa.KERNEL_LAUNCHES))


def phase_load(device, work: str, cfg, gen_params, tiny: bool = False) -> dict:
    """Phase 27: the port's service load driver
    (``benchmarks/service_load.py``) at full byt5-small width (phase 4's
    generator weights, input 512, output 128, the JAX driver's geometry),
    streaming, 16 spawned workers, 8 slots, chunk 8, 64 beams, on the
    driver's synthetic benchmark, in two cells: ``--env-latency 0`` and
    ``2.0``. Cut to fit the smoke: 8 theorems at latency 0 and 16 at 2.0
    (16 at both before the diverse and indexer parts; at 2.0 the serving
    window of 8 searches, ~2 s, ends before the 3 s profiled window;
    ``service_load.py`` runs 24), ``max_expansions`` 2 at latency 0 and 0
    at 2.0 (``service_load.py`` runs 6; the search stops once it has
    passed the limit, so a search runs 3 and 1 expansions), and 8 beams at
    2.0 (the environment waits 2.0 s a tactic on average, so an expansion
    of 64 would wait ~128 s, of 8 ~16 s). Expansions/s by wall and over the serving window, the
    service's stats and the device-busy share of a 3 s profiled window
    (``utils/profiling.device_trace``); fails unless every search ran its
    expansions, kernel 13 launched and the trace names the encoder and
    reorder kernels."""
    from reprover_tpu_torch.benchmarks import service_load as sl
    from reprover_tpu_torch.generation import TacticGeneratorModel

    data = sl.make_data(os.path.join(work, "service_load"))
    model = TacticGeneratorModel(gen_params, cfg, max_inp_seq_len=512, max_oup_seq_len=128)
    cells = []
    launches: dict = {}
    for latency in LOAD["latencies"]:
        limit = LOAD["max_expansions"] if latency == 0 else LOAD["latent_max_expansions"]
        theorems = LOAD["theorems"] if latency == 0 else LOAD["latent_theorems"]
        reset_all_launch_counts()
        row = sl.run_cell(model, data, LOAD["workers"], 0, 0.0, num_theorems=theorems,
                          streaming=True, num_slots=LOAD["slots"], chunk_size=LOAD["chunk"],
                          num_beams=LOAD["beams"] if latency == 0 else LOAD["latent_beams"],
                          env_latency_s=latency,
                          max_expansions=limit, device=device,
                          profile_window_s=LOAD["profile_window_s"])
        counts = all_launch_counts()
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        names = row.get("trace_kernels", {})
        row["launches"] = {k: n for k, n in counts.items() if n}
        log(f"[load] {json.dumps({k: v for k, v in row.items() if k != 'trace_kernels'})}")
        if row["searched_nodes"] != [limit + 1] * theorems:
            raise AssertionError(f"the load searches ran {row['searched_nodes']} expansions, "
                                 f"not {limit + 1} each")
        if device.type == "cuda":
            if counts["beam_reorder"] < 1:
                raise AssertionError("the load cells did not launch the beam-reorder kernel")
            from reprover_tpu_torch.ops.flash_attention import kernel_instance

            enc = [n for n in names if (kernel_instance(n) or (None,))[0] == "fwd"
                   and kernel_instance(n)[2] == 0]
            if not enc or not any("reorder_append_kernel" in n for n in names):
                raise AssertionError(f"the profiled window does not name the encoder and "
                                     f"reorder kernels: {sorted(names)[:20]} "
                                     f"{row.get('profiler')}")
        cells.append(row)
    return dict(cells=cells, launches=launches)


# Data-parallel training: two ranks share the one card over gloo
# (NCCL refuses two ranks on one device), each launching the CUDA kernels.
DP = dict(ranks=2, backend="gloo", steps=3, lr=1e-4, loss_rtol=2e-2, loss_atol=2e-3,
          update_l1=5e-2, r10_tol=5.0, moment_share=0.55, index_tol=1e-6, index_k=10)


def _dp_argv(device, run_dir: str, bench: str, task: str, tiny: bool, preds: str) -> list:
    """``fit`` flags of a data-parallel phase's runs: the training phases'
    flags (the generator's on phase 10's predictions), ``DP["steps"]``
    steps at lr 1e-4 without warmup (so the parameters move; at the
    generator's 5e-4 the loss swings 2-6 between steps, and the validation
    of two runs that differ by bf16's rounding parts by 3%), a loss logged
    at every step, one validation and a checkpoint at the end."""
    if task == "retriever":
        argv = _fit_argv(device, run_dir, bench, tiny)
        monitor = []
    else:
        argv = _gen_argv(device, run_dir, bench, preds, tiny, GEN)
        monitor = ["--trainer.monitor", "loss_val", "--trainer.monitor_mode", "min"]
    return argv + monitor + [
        "--model.lr", str(DP["lr"]),
        "--model.warmup_steps", "0",
        "--trainer.max_steps", str(DP["steps"]),
        "--trainer.val_interval", str(DP["steps"]),
        "--trainer.log_interval", "1",
        "--trainer.patience", "99",
        "--trainer.ckpt_dir", os.path.join(run_dir, "ckpts"),
    ]


DP_TASKS = {"retriever": "reprover_tpu_torch.retrieval.main",
            "generator": "reprover_tpu_torch.generation.main"}


def _dp_rank(rank: int, device_type: str, argvs: dict, init_file: str, out_dir: str,
             index_flags: list) -> None:
    """One rank of the data-parallel phases: joins the ranks' gloo group,
    runs each task's ``fit`` (kernel launches, moment bytes, seconds), times
    the reduction of the last step's gradients alone, runs the multichip dry
    run's checks on the same ranks, then the indexer CLI in the group
    (``index_flags`` and an output path of its own); writes one JSON file."""
    import importlib

    import torch
    import torch.distributed as dist

    from reprover_tpu_torch.benchmarks import multichip_dryrun
    from reprover_tpu_torch.parallel.collectives import reduce_gradients_
    from reprover_tpu_torch.parallel.mesh import init_distributed, make_mesh

    device = torch.device(device_type)
    if device.type == "cpu":  # a CPU rehearsal: two ranks' OpenMP threads spin on few cores
        torch.set_num_threads(1)
    init_distributed(device, backend=DP["backend"], init_method=f"file://{init_file}",
                     rank=rank, world_size=DP["ranks"])
    out: dict = {}
    for task, argv in argvs.items():
        reset_all_launch_counts()
        t0 = time.perf_counter()
        state = importlib.import_module(DP_TASKS[task]).main(["fit"] + argv)
        _sync(device)
        fit_s = time.perf_counter() - t0
        grads = [p.grad for p in state.optimizer.params if p.grad is not None]
        mesh = make_mesh(data=DP["ranks"])
        reduce_ms = []
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            reduce_gradients_(grads, mesh)
            _sync(device)
            reduce_ms.append(1e3 * (time.perf_counter() - t0))
        out[task] = dict(launches=all_launch_counts(), fit_s=fit_s, reduce_ms=reduce_ms,
                         moment_bytes=state.optimizer.moment_bytes(),
                         grad_bytes=sum(g.numel() * g.element_size() for g in grads),
                         shard_axes=sum(a is not None for a in state.optimizer.shard_axes))
        del state, grads
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_all_launch_counts()
    out["dryrun"] = multichip_dryrun.run_rank(make_mesh(data=DP["ranks"]), device)
    out["dryrun"]["launches"] = {k: n for k, n in all_launch_counts().items() if n}
    out["dryrun"]["seconds"] = time.perf_counter() - t0
    out["indexer"] = _run_indexer(index_flags + ["--output-path",
                                                 os.path.join(out_dir, f"indexed{rank}")])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _run_indexer(argv: list) -> dict:
    """``retrieval.indexer.main(argv)`` in this process: its seconds, kernel
    1's launches and what it printed (the rate and the gather, on the
    writing rank)."""
    import contextlib
    import io

    from reprover_tpu_torch.retrieval.indexer import main as index_main, parse_report

    before = all_launch_counts()["encoder_attn"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        index_main(argv)
    wall = time.perf_counter() - t0
    return dict(parse_report(out.getvalue()), wall_s=wall, printed=out.getvalue(),
                encoder_attn=all_launch_counts()["encoder_attn"] - before)


def _metrics(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _initial_params(task: str, tiny: bool, seed: int) -> dict:
    """The fits' seeded initial parameters (the CLIs' ``random_init`` or
    ``tiny`` build), flat, on the CPU."""
    import torch

    from reprover_tpu_torch.models.t5 import byt5_small, fuse_mlp_params, init_params

    cfg = _generator_cfg(torch.device("cpu"), tiny) if tiny else byt5_small()
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    if task == "retriever":
        params = {"shared_embedding": params["shared_embedding"], "encoder": params["encoder"]}
    return _flat(fuse_mlp_params(params))


def _dp_compare(task: str, one_dir: str, dp_dir: str, tiny: bool, seed: int) -> dict:
    """One rank's fit against the two ranks': the loss at each step (bf16:
    within 2e-2 of itself plus 2e-3 of max(1, |loss|), the form of the bf16
    gradient checks), the parameters after the last step (their updates
    from the seeded initial parameters: summed absolute difference within
    ``update_l1`` of the one-rank update's summed magnitude; Adam's
    near-sign updates flip where a gradient element is below bf16's
    noise), and the validation metric."""
    import torch

    recs = {k: _metrics(os.path.join(d, "logs" if task == "retriever" else "glogs",
                                     "metrics.jsonl")) for k, d in (("one", one_dir),
                                                                    ("dp", dp_dir))}
    losses = {k: [r["loss"] for r in v if "loss" in r] for k, v in recs.items()}
    ms = {k: [1e3 / r["steps_per_sec"] for r in v if "steps_per_sec" in r][1:]
          for k, v in recs.items()}
    val_key = "Recall@10_val" if task == "retriever" else "loss_val"
    val = {k: [r for r in v if val_key in r][-1] for k, v in recs.items()}
    saved = {k: torch.load(os.path.join(d, "ckpts", str(DP["steps"]), "state.pt"),
                           map_location="cpu", weights_only=True)
             for k, d in (("one", one_dir), ("dp", dp_dir))}
    init = _initial_params(task, tiny, seed)
    one_p, dp_p = _flat(saved["one"]["params"]), _flat(saved["dp"]["params"])
    diff = sum(float((dp_p[k] - one_p[k]).abs().sum()) for k in init)
    moved = sum(float((one_p[k] - init[k]).abs().sum()) for k in init)
    dot = sum(float(((dp_p[k] - init[k]) * (one_p[k] - init[k])).sum()) for k in init)
    norm_dp = math.sqrt(sum(float(((dp_p[k] - init[k]) ** 2).sum()) for k in init))
    norm_one = math.sqrt(sum(float(((one_p[k] - init[k]) ** 2).sum()) for k in init))
    moments_whole = all(
        tuple(st["exp_avg"].shape) == tuple(one_p[name].shape)
        for (i, st), name in zip(sorted(saved["dp"]["optimizer"]["adamw"]["state"].items()),
                                 _flat(saved["dp"]["params"])))
    return dict(losses=losses, ms_per_step=ms, validation={k: v.get(val_key) for k, v in
                                                           val.items()},
                update_l1_rel=diff / max(moved, 1e-30),
                update_cosine=dot / max(norm_dp * norm_one, 1e-30),
                checkpoint_moments_whole=moments_whole,
                top1={k: v.get("top1_acc_val") for k, v in val.items()})


def phase_data_parallel(device, work: str, bench: str, index: dict,
                        tiny: bool = False) -> dict:
    """``dp_retriever``, ``dp_generator``, ``dp_dryrun`` and ``dp_indexer``:
    each fit on one rank in this process, then on two ranks sharing the card
    over gloo (one spawn for all: each rank runs both fits, the multichip
    dry run's checks and the indexer CLI), held against each other; each
    rank must launch its task's kernels and hold about half of the one-rank
    moment bytes. The indexer runs on the two ranks as phase 25 ran it on
    one card (``index``: its checkpoint, corpus, artifact and rate): exactly
    one artifact must be written, with the one card's corpus, embeddings
    within 1e-6 of its and the same top-10 retrieval of the val states."""
    import torch
    import torch.multiprocessing as mp

    import importlib

    seconds, results = {}, {}
    root = os.path.join(work, "dp")
    preds = os.path.join(work, "logs", "predictions.pickle")
    argvs = {}
    one_bytes = {}
    for task, module in DP_TASKS.items():
        t0 = time.perf_counter()
        one_dir, dp_dir = os.path.join(root, task, "one"), os.path.join(root, task, "dp")
        argvs[task] = _dp_argv(device, dp_dir, bench, task, tiny, preds)
        state = importlib.import_module(module).main(
            ["fit"] + _dp_argv(device, one_dir, bench, task, tiny, preds)
            + ["--data_parallel", "false"])
        one_bytes[task] = state.optimizer.moment_bytes()
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
        seconds[f"dp_{task}_one_rank"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp.spawn(_dp_rank, args=(device.type, argvs, os.path.join(root, "rendezvous"), root,
                             index_argv(index, device)), nprocs=DP["ranks"], join=True)
    seconds["dp_ranks"] = time.perf_counter() - t0
    ranks = []
    for r in range(DP["ranks"]):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    failures = []
    for task in DP_TASKS:
        res = _dp_compare(task, os.path.join(root, task, "one"), os.path.join(root, task, "dp"),
                          tiny, TRAIN["seed"] if task == "retriever" else GEN["seed"])
        required = ([k for k in FULL_ROW_KERNELS if k.startswith("encoder_attn")]
                    if task == "retriever" else FULL_ROW_KERNELS)
        res.update(
            launches_per_rank=[{k: r[task]["launches"][k] for k in required} for r in ranks],
            moment_bytes_per_rank=[r[task]["moment_bytes"] for r in ranks],
            moment_bytes_one_rank=one_bytes[task],
            grad_bytes=ranks[0][task]["grad_bytes"],
            reduce_ms=[r[task]["reduce_ms"] for r in ranks],
            fit_s=[round(r[task]["fit_s"], 1) for r in ranks])
        results[task] = res
        log(f"[dp_{task}] {json.dumps(res)}")
        one, dp = res["losses"]["one"], res["losses"]["dp"]
        if len(one) != DP["steps"] or len(dp) != DP["steps"]:
            failures.append(f"{task}: logged {len(one)} / {len(dp)} losses")
        for a, b in zip(one, dp):
            if not abs(a - b) <= DP["loss_rtol"] * abs(a) + DP["loss_atol"] * max(1.0, abs(a)):
                failures.append(f"{task}: loss {b} on two ranks against {a} on one")
        if not res["update_l1_rel"] <= DP["update_l1"]:
            failures.append(f"{task}: parameter updates differ by {res['update_l1_rel']:.4f} "
                            f"(limit {DP['update_l1']})")
        if not res["checkpoint_moments_whole"]:
            failures.append(f"{task}: the two ranks' checkpoint holds moment shards")
        v1, v2 = res["validation"]["one"], res["validation"]["dp"]
        tol = (DP["r10_tol"] if task == "retriever"
               else DP["loss_rtol"] * abs(v1) + DP["loss_atol"] * max(1.0, abs(v1)))
        if v1 is None or v2 is None or not abs(v1 - v2) <= tol:
            failures.append(f"{task}: validation {v2} on two ranks against {v1} on one")
        if any(b > DP["moment_share"] * one_bytes[task] for b in res["moment_bytes_per_rank"]):
            failures.append(f"{task}: a rank holds more than {DP['moment_share']} of the "
                            f"one-rank moment bytes")
        if device.type == "cuda" and any(min(x.values()) < 1 for x in res["launches_per_rank"]):
            failures.append(f"{task}: a rank did not launch every kernel of its path")
        seconds[f"dp_{task}"] = round(seconds[f"dp_{task}_one_rank"]
                                      + max(r[task]["fit_s"] for r in ranks), 1)
    dry = [r["dryrun"] for r in ranks]
    log(f"[dp_dryrun] {json.dumps(dry)}")
    for d in dry:
        if not d["ok"]:
            failures.append(f"dryrun: rank {d['rank']} disagrees with one rank")
    log(f"[dp_gloo] collectives on {device.type} tensors over gloo: "
        f"{json.dumps(dry[0]['collectives'])}")
    seconds["dp_dryrun"] = round(max(d["seconds"] for d in dry), 1)
    t0 = time.perf_counter()
    failures += _check_indexer(device, root, index, bench, [r["indexer"] for r in ranks])
    seconds["dp_indexer"] = round(time.perf_counter() - t0
                                  + max(r["indexer"]["wall_s"] for r in ranks), 1)
    if failures:
        raise AssertionError("data-parallel phases failed: " + "; ".join(failures))
    return dict(seconds={k: round(v, 1) for k, v in seconds.items()}, results=results,
                dryrun=dry)


def _check_indexer(device, root: str, one: dict, bench: str, ranks: list) -> list:
    """The two ranks' indexer against the one card's: one artifact, the same
    corpus, embeddings within ``DP["index_tol"]``, the same top-10 of the
    val states; logs ``[dp_indexer]`` and returns the failures."""
    import numpy as np

    from reprover_tpu_torch.data import IndexedCorpus
    from reprover_tpu_torch.retrieval import PremiseRetriever

    failures = []
    written = sorted(n for n in os.listdir(root) if n.startswith("indexed"))
    want = IndexedCorpus.load(one["path"])
    report = dict(written=written, one_card=one["premises_per_s"],
                  two_ranks=ranks[0]["premises_per_s"], gather_ms=ranks[0]["gather_ms"],
                  gather_bytes=ranks[0]["gather_bytes"],
                  encoder_attn_per_rank=[r["encoder_attn"] for r in ranks],
                  wall_s=dict(one_card=one["wall_s"], ranks=[r["wall_s"] for r in ranks]))
    if written != ["indexed0"]:
        failures.append(f"indexer: the ranks wrote {written}, not one artifact")
    else:
        got = IndexedCorpus.load(os.path.join(root, "indexed0"))
        same_corpus = [p.full_name for p in got.corpus.all_premises] == [
            p.full_name for p in want.corpus.all_premises]
        gap = float(np.abs(got.embeddings - want.embeddings).max())
        retriever = PremiseRetriever.load_hf(one["ckpt"], EVAL["index_max_seq_len"],
                                             device=device)
        with open(os.path.join(bench, "random", "val.json")) as f:
            contexts = val_contexts(json.load(f))
        top = []
        for artifact in (want, got):
            retriever.load_corpus(artifact)
            premises, _ = retriever.retrieve_batch(contexts, DP["index_k"])
            top.append([[p.full_name for p in row] for row in premises])
        report.update(same_corpus=same_corpus, embedding_gap=gap, same_top10=top[0] == top[1],
                      queries=len(contexts))
        if not same_corpus or not gap <= DP["index_tol"] or top[0] != top[1]:
            failures.append(f"indexer: corpus equal {same_corpus}, embedding gap {gap} (limit "
                            f"{DP['index_tol']}), top-{DP['index_k']} equal {top[0] == top[1]}")
    if device.type == "cuda" and min(report["encoder_attn_per_rank"]) < 1:
        failures.append("indexer: a rank did not launch kernel 1")
    log(f"[dp_indexer] {json.dumps(report)}")
    return failures


# Tensor parallelism (phase 29): two ranks share the card over gloo, as in
# phase 28. byt5-small served at TP 2 (3 heads a rank): 2 requests, 64
# beams, inputs <= 2048 bytes, decode cut to 64 tokens, 2 slots; one fp32
# request against one rank (8 beams, 16 tokens); LLaMA-7B width cut to
# depth 4 of 32 in int4 and int8 (4 slots x 8 beams, prompts 512, decode
# 129: int4 to the end, int8 two chunks); training at (1, 2): the generator
# at [2, 1024] -> [2, 256] and the depth-4 LLaMA fine-tuning at [2, 1024], 3
# steps each against one rank in this process.
TP = dict(ranks=2, backend="gloo", requests=2, slots=2, beams=64, src=2048, dec=64, chunk=8,
          fp32_beams=8, fp32_dec=16, fp32_rtol=1e-4, llama_layers=4, llama_src=512,
          llama_dec=129, llama_slots=4, llama_beams=8, int8_chunks=2, steps=3, lr=1e-4,
          gen=(2, 1024, 256), finetune=(2, 1024), seed=0, split_share=0.52)
TP_TINY = dict(TP, beams=4, src=64, dec=8, fp32_beams=4, fp32_dec=6, llama_src=16, llama_dec=9,
               llama_beams=4, gen=(2, 64, 16), finetune=(2, 128))
# Sequence parallelism (phase 29's spawn): the byt5-small encoder (12
# layers, 6 heads x 64, seeded weights) at [2, 16384] on a seq axis of the
# two ranks (shards of 8192); row 1 holds 6000 valid bytes, so rank 1's
# shard of it is all padding. The one-card references run in this process
# after the ranks.
SP = dict(batch=2, length=16384, short_row=6000, fp32_rtol=1e-4, cosine=0.99, iters=3,
          shift_iters=5, seed=0)
SP_TINY = dict(SP, length=256, short_row=100)


def _tp_t5(device, tiny: bool, dtype):
    """The byt5-small generator (tiny: 2 heads, so TP 2 splits them) with
    seeded weights, fused MLP, in ``dtype`` on ``device`` -> (cfg, params)."""
    import torch

    from reprover_tpu_torch.models.t5 import (
        T5Config, byt5_small, fuse_mlp_params, init_params, place_params,
    )

    cfg = (T5Config(d_model=32, d_kv=16, d_ff=64, num_heads=2, num_encoder_layers=2,
                    num_decoder_layers=2, compute_dtype=dtype) if tiny
           else byt5_small(compute_dtype=dtype))
    params = fuse_mlp_params(init_params(cfg, torch.Generator().manual_seed(SLICE["seed"])))
    return cfg, place_params(params, cfg, device)


def _tp_llama_cfg(device, tiny: bool, flash: bool = False):
    import torch

    from reprover_tpu_torch.models.causal_lm import CausalLMConfig

    if tiny:
        return CausalLMConfig(vocab_size=512, d_model=64, num_layers=2, num_heads=4,
                              num_kv_heads=2, d_ff=128, compute_dtype=torch.float32,
                              flash_attention=flash)
    return CausalLMConfig(num_layers=TP["llama_layers"], compute_dtype=torch.bfloat16,
                          flash_attention=flash)


def _tp_train(task: str, device, tiny: bool, mesh=None) -> tuple:
    """``TP["steps"]`` steps of ``make_train_step`` (tensor-parallel under a
    ``mesh``) on one seeded batch: the generator at ``TP["gen"]`` (remat
    full) or the LLaMA fine-tuning at ``TP["finetune"]`` (fused attention),
    float32 masters -> (losses, state)."""
    import numpy as np
    import torch

    from reprover_tpu_torch.models import causal_lm
    from reprover_tpu_torch.models.t5 import fuse_mlp_params, init_params, place_master_params
    from reprover_tpu_torch.training import tasks

    tp = TP_TINY if tiny else TP
    rng = np.random.default_rng(TP["seed"])
    if task == "generator":
        cfg = _generator_cfg(device, tiny)
        params = place_master_params(fuse_mlp_params(init_params(
            cfg, torch.Generator().manual_seed(GEN["seed"]))), device)
        b, src, tgt = tp["gen"]
        mask = (np.arange(src)[None, :] < np.array([src, src * 3 // 4])[:, None]).astype(np.int64)
        tactic = rng.integers(3, 259, (b, tgt))
        tactic[1, tgt // 2:] = -100
        batch = {"state_ids": rng.integers(3, 259, (b, src)) * mask, "state_mask": mask,
                 "tactic_ids": tactic}
        loss_fn = tasks.generation_loss
    else:
        cfg = _tp_llama_cfg(device, tiny, flash=True)
        params = causal_lm.init_params(cfg, torch.Generator(device=device).manual_seed(TP["seed"]))
        b, t = tp["finetune"]
        mask = (np.arange(t)[None, :] < np.array([t, t * 2 // 3])[:, None]).astype(np.int64)
        batch = {"input_ids": rng.integers(3, cfg.vocab_size, (b, t)) * mask,
                 "attention_mask": mask}
        loss_fn = tasks.causal_loss
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    state = tasks.init_train_state(params, lr=TP["lr"], warmup_steps=0)
    step = tasks.make_train_step(loss_fn, cfg, mesh=mesh)
    losses = []
    for _ in range(TP["steps"]):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, state


def _sp_inputs(device, tiny: bool):
    """Seeded ids ``[B, L]`` and the ragged mask: row 1 valid for its first
    ``short_row`` bytes."""
    import numpy as np
    import torch

    sp = SP_TINY if tiny else SP
    rng = np.random.default_rng(sp["seed"])
    ids = torch.from_numpy(rng.integers(3, 259, (sp["batch"], sp["length"]))).to(device)
    mask = torch.ones((sp["batch"], sp["length"]), dtype=torch.long, device=device)
    mask[1, sp["short_row"]:] = 0
    return ids, mask


def _sp_rank(device, mesh, tiny: bool, work: str) -> dict:
    """This rank's part of phase 29's sequence-parallel checks: the fp32 and
    bf16 ring encoders' shards written for the parent to compare, the bf16
    ring's ms per encode (CUDA events, median), peak GiB and one ring shift
    of a layer's k/v/mask shard alone (median)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from reprover_tpu_torch.benchmarks.sequence_parallel_encode import model, timed
    from reprover_tpu_torch.models.t5 import encode_sequence_parallel, place_params
    from reprover_tpu_torch.parallel.collectives import ring_shift

    sp = SP_TINY if tiny else SP
    r, n = mesh.coord("seq"), mesh.shape["seq"]
    ids, mask = _sp_inputs(device, tiny)
    cfg, params = model(torch.float32, tiny)
    placed = place_params(params, cfg, device)
    with torch.inference_mode():
        h = encode_sequence_parallel(placed, cfg, ids, mask, mesh)
        torch.save(h.cpu(), os.path.join(work, f"sp_fp32_{r}.pt"))
        del placed, h
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
        placed = place_params(params, cfg, device)
        dist.barrier(group=mesh.group("seq"))
        _empty_cache(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        ms = timed(lambda: encode_sequence_parallel(placed, cfg, ids, mask, mesh), sp["iters"],
                   device)
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda"
                else None)
        torch.save(encode_sequence_parallel(placed, cfg, ids, mask, mesh).cpu(),
                   os.path.join(work, f"sp_bf16_{r}.pt"))
        shard = sp["length"] // n
        buf = torch.zeros(2 * sp["batch"] * cfg.num_heads * shard * cfg.d_kv
                          + sp["batch"] * shard, dtype=torch.bfloat16, device=device)
        shift = timed(lambda: ring_shift(buf, mesh), sp["shift_iters"], device)
    return dict(ms=statistics.median(ms), ms_all=ms, peak_GiB=peak,
                shift_ms=statistics.median(shift),
                shift_bytes=buf.numel() * buf.element_size(),
                transfer_ms_per_encode=statistics.median(shift) * (n - 1) * cfg.num_encoder_layers)


def _sp_check(device, work: str, tiny: bool, ranks: list) -> tuple:
    """The ranks' ring encoders gathered against one card's ``encode`` in
    this process -> (the ``[sp]`` result, failures)."""
    import dataclasses

    import torch

    from reprover_tpu_torch.benchmarks.sequence_parallel_encode import model, timed
    from reprover_tpu_torch.models.t5 import encode, place_params
    from reprover_tpu_torch.ops.pooling import masked_mean_normalize

    sp = SP_TINY if tiny else SP
    ids, mask = _sp_inputs(device, tiny)
    failures = []

    def gathered(tag: str):
        return torch.cat([torch.load(os.path.join(work, f"sp_{tag}_{r}.pt"))
                          for r in range(len(ranks))], dim=1).to(device)

    cfg, params = model(torch.float32, tiny)
    placed = place_params(params, cfg, device)
    with torch.inference_mode():
        reset_all_launch_counts()
        ref = encode(placed, cfg, ids, mask)
        launches = {k: v for k, v in all_launch_counts().items() if v}
        ring = gathered("fp32")
        err = (ring - ref).abs()
        overall = float(err.max()) / max(1.0, float(ref.abs().max()))
        by_row = float((err.amax(dim=-1) / ref.abs().amax(dim=-1).clamp(min=1.0)).max())
        finite = bool(torch.isfinite(ring[mask.any(dim=1)]).all())
        del placed, ref, ring, err
        _empty_cache(device)
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
        placed = place_params(params, cfg, device)
        ref = encode(placed, cfg, ids, mask)
        one_ms = timed(lambda: encode(placed, cfg, ids, mask), sp["iters"], device)
        ring = gathered("bf16")
        cosine = (masked_mean_normalize(ring, mask) * masked_mean_normalize(ref, mask)).sum(dim=1)
        token_cosine = float(torch.nn.functional.cosine_similarity(
            ring.float(), ref.float(), dim=-1)[mask.bool()].min())
    rows = [r["sp"] for r in ranks]
    res = dict(shape=[sp["batch"], sp["length"]], layers=cfg.num_encoder_layers,
               ranks=len(ranks), fp32_rel_err=overall, fp32_row_rel_err=by_row,
               fp32_finite=finite, bf16_row_cosine=[float(c) for c in cosine],
               bf16_token_cosine_min=token_cosine, ms_per_rank=[row["ms"] for row in rows],
               peak_GiB_per_rank=[row["peak_GiB"] for row in rows],
               shift_ms_per_rank=[row["shift_ms"] for row in rows],
               shift_bytes=rows[0]["shift_bytes"],
               transfer_ms_per_encode=[row["transfer_ms_per_encode"] for row in rows],
               one_card_bf16_ms=statistics.median(one_ms), one_card_launches=launches,
               transport=ranks[0]["dryrun"]["sequence_parallel"]["transport"],
               dryrun_gap=[r["dryrun"]["sequence_parallel"]["max_abs_gap"] for r in ranks])
    if not (overall <= sp["fp32_rtol"] and by_row <= sp["fp32_rtol"]):
        failures.append(f"sequence parallel fp32: {overall:.3g} overall, {by_row:.3g} by row "
                        f"against one card (limit {sp['fp32_rtol']})")
    if not finite:
        failures.append("sequence parallel fp32: a row with a valid key is not finite")
    if not float(cosine.min()) >= sp["cosine"]:
        failures.append(f"sequence parallel bf16: per-row cosine {res['bf16_row_cosine']}")
    if device.type == "cuda" and launches.get("encoder_attn_long", 0) < 1:
        failures.append(f"the one-card reference took no long route: {launches}")
    return res, failures


def _beam_state(engine) -> dict:
    """The engine's beam bookkeeping on the host (every rank's must match)."""
    st = engine.state
    return {f: getattr(st, f).detach().cpu() for f in ("fin_tokens", "fin_scores", "fin_lens",
                                                         "tokens", "beam_scores", "n", "done")}


def _tp_byt5(device, mesh, states: list, tiny: bool, out: dict, work: str) -> None:
    """byt5-small bf16 at TP 2 behind the streaming service (the leader
    serves ``TP["requests"]`` requests; the other rank follows), then one
    fp32 request against one rank."""
    import asyncio

    import numpy as np
    import torch

    from reprover_tpu_torch.generation import TacticGeneratorModel
    from reprover_tpu_torch.models.t5 import decode_step, encode, init_decode_state
    from reprover_tpu_torch.parallel.sharding import shard_for_model
    from reprover_tpu_torch.data import Pos
    from reprover_tpu_torch.prover import serve_tensor_parallel

    tp = TP_TINY if tiny else TP
    cfg, params = _tp_t5(device, tiny, torch.bfloat16 if device.type == "cuda" else torch.float32)
    model = TacticGeneratorModel(params, cfg, tp["src"], tp["dec"])
    opts = dict(num_slots=tp["slots"], num_beams=tp["beams"], chunk_size=tp["chunk"],
                reorder_mode="gather")
    reset_all_launch_counts()
    t0 = time.perf_counter()
    svc = serve_tensor_parallel(model, mesh, **opts)  # a follower returns once it stops
    if mesh.is_leader:
        svc.start()
        try:
            clients = [svc.client() for _ in range(tp["requests"])]

            async def ask():
                return await asyncio.gather(*[c.agenerate(s, "a.lean", "t", Pos(1, 1),
                                                          tp["beams"])
                                              for c, s in zip(clients, states)])

            answers = asyncio.run(ask())
        finally:
            svc.stop()
        stats = svc.stats_snapshot()
        out["byt5_served"] = dict(requests=int(stats["requests"]), steps=int(stats["steps"]),
                                  answers=[len(a) for a in answers],
                                  finite=all(np.isfinite(s) for a in answers for _, s in a))
    engine = svc.engine
    _sync(device)
    out["byt5_s"] = time.perf_counter() - t0
    out["byt5_launches"] = {k: n for k, n in all_launch_counts().items() if n}
    out["byt5_cache"] = list(engine.state.self_k.shape)
    torch.save(_beam_state(engine), os.path.join(work, f"beams{mesh.coord('model')}.pt"))
    del svc, engine, model, params
    _empty_cache(device)

    # One fp32 request: the encoder output and the first step's log-probs
    # through the sharded forward against one rank, then the beams.
    cfg32, params32 = _tp_t5(device, tiny, torch.float32)
    local32, _ = shard_for_model(params32, cfg32, mesh)
    model32 = TacticGeneratorModel(params32, cfg32, tp["src"], tp["fp32_dec"])
    ids, mask = (torch.from_numpy(x).to(device) for x in model32.tokenize_for_engine(states[:1]))
    ids = ids.long()
    start = torch.full((1,), cfg32.decoder_start_token_id, dtype=torch.long, device=device)
    with torch.no_grad():
        enc = encode(local32, cfg32, ids, mask, mesh=mesh)
        logits, _ = decode_step(local32, cfg32, init_decode_state(local32, cfg32, enc, mask, 1),
                                start, mesh=mesh)
        if mesh.is_leader:
            enc1 = encode(params32, cfg32, ids, mask)
            logits1, _ = decode_step(params32, cfg32, init_decode_state(params32, cfg32, enc1,
                                                                        mask, 1), start)
            logp, logp1 = (torch.log_softmax(x, -1) for x in (logits, logits1))
            out["fp32_encoder_rel"] = ((enc - enc1).abs().max() / enc1.abs().max()).item()
            out["fp32_logprob_rel"] = ((logp - logp1).abs().max() / logp1.abs().max()).item()
    engine = model32.make_stepwise_engine(1, tp["fp32_beams"], mesh=mesh, reorder_mode="gather")
    if mesh.is_leader:
        try:
            engine.admit_batch_tokens([0], *model32.tokenize_for_engine(states[:1]))
            while not engine.finished_slots():
                engine.run_chunk()
            got = model32.decode_candidates(*engine.finalize(0))
        finally:
            engine.release_followers()
        one = model32.make_stepwise_engine(1, tp["fp32_beams"], reorder_mode="gather")
        one.admit_batch_tokens([0], *model32.tokenize_for_engine(states[:1]))
        while not one.finished_slots():
            one.run_chunk()
        want = model32.decode_candidates(*one.finalize(0))
        out["fp32_beams_equal_share"] = sum(a[0] == b[0] for a, b in zip(got, want)) / len(want)
        out["fp32_score_gap"] = max(abs(a[1] - b[1]) for a, b in zip(got, want))
    else:
        engine.follow()
    del engine, model32, params32, local32
    _empty_cache(device)


def _tp_llama(device, mesh, tiny: bool, out: dict) -> None:
    """LLaMA-7B width at depth 4, int4 and int8, at TP 2: each rank's
    routes against one card's, the tensor-core bodies, weight bytes, and an
    admission wave (int4 to the end, int8 two chunks)."""
    import numpy as np
    import torch

    from reprover_tpu_torch.generation.causal_engine import CausalStepwiseEngine
    from reprover_tpu_torch.models.causal_lm import init_serving_params
    from reprover_tpu_torch.models.quantize import routing_report, weight_bytes

    tp = TP_TINY if tiny else TP
    cfg = _tp_llama_cfg(device, tiny)
    rows = {"decode": tp["llama_slots"] * tp["llama_beams"],
            "admission": tp["llama_slots"] * (tp["llama_src"] - 1)}
    rng = np.random.default_rng(TP["seed"])
    ids = rng.integers(3, cfg.vocab_size, (tp["llama_slots"], tp["llama_src"]))
    for bits in (4, 8):
        params = init_serving_params(cfg, TP["seed"], device, bits=bits)

        def routes(p):
            return {k: routing_report({**p["layers"], "lm_head": p["lm_head"]}, m,
                                      cfg.compute_dtype, device) for k, m in rows.items()}

        whole_routes, whole_bytes = routes(params), weight_bytes(params)
        split_bytes = weight_bytes({"layers": params["layers"], "lm_head": params["lm_head"]})
        engine = CausalStepwiseEngine(params, cfg, tp["llama_slots"], tp["llama_beams"],
                                      tp["llama_src"], tp["llama_dec"], chunk_size=8, mesh=mesh,
                                      reorder_mode="gather")
        del params
        _empty_cache(device)
        local = engine.params
        row = dict(routes_equal=routes(local) == whole_routes, routes=whole_routes["decode"],
                   weight_bytes=weight_bytes(local), weight_bytes_one_rank=whole_bytes,
                   split_bytes=weight_bytes({"layers": local["layers"],
                                             "lm_head": local["lm_head"]}),
                   split_bytes_one_rank=split_bytes, cache=list(engine.state.dec_k.shape))
        reset_all_launch_counts()
        t0 = time.perf_counter()
        if mesh.is_leader:
            try:
                engine.admit_batch_tokens(list(range(tp["llama_slots"])), ids, np.ones_like(ids))
                chunks = 0
                while engine.has_active() and (bits == 4 or chunks < TP["int8_chunks"]):
                    engine.unpack_status(engine.dispatch_run(8))
                    chunks += 1
                    for slot in engine.finished_slots():
                        engine.finalize(slot)
                row["steps"] = int(engine.state.n.max().item())
            finally:
                engine.release_followers()
        else:
            engine.follow()
        _sync(device)
        from reprover_tpu_torch.ops import quant_matmul as qm

        row.update(seconds=time.perf_counter() - t0, bodies=dict(qm.BODY_LAUNCHES),
                   launches={k: n for k, n in all_launch_counts().items() if n})
        out[f"llama_int{bits}"] = row
        del engine, local
        _empty_cache(device)


def _tp_rank(rank: int, device_type: str, tiny: bool, states: list, work: str) -> None:
    """One rank of phase 29: joins the ranks' gloo group, serves byt5-small
    and LLaMA-7B at TP 2, trains the generator and the fine-tuning step at
    (1, 2), runs the multichip dry run's tensor- and sequence-parallel
    checks and the byt5-small encoder over a ``seq`` axis of the two ranks;
    writes one JSON file."""
    import hashlib

    import torch
    import torch.distributed as dist

    from reprover_tpu_torch.benchmarks import multichip_dryrun
    from reprover_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from reprover_tpu_torch.parallel.sharding import shard_axis
    from reprover_tpu_torch.training.tasks import param_leaves

    device = torch.device(device_type)
    if device.type == "cpu":
        torch.set_num_threads(1)
    init_distributed(device, backend=TP["backend"], init_method=f"file://{work}/rendezvous",
                     rank=rank, world_size=TP["ranks"])
    mesh = make_mesh(data=1, model=TP["ranks"])
    seq_mesh = make_mesh(data=1, seq=TP["ranks"])
    out: dict = {"coords": list(mesh.coords)}
    seconds = {}
    t0 = time.perf_counter()
    _tp_byt5(device, mesh, states, tiny, out, work)
    seconds["byt5"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _tp_llama(device, mesh, tiny, out)
    seconds["llama"] = time.perf_counter() - t0
    for task in ("generator", "finetune"):
        t0 = time.perf_counter()
        reset_all_launch_counts()
        losses, state = _tp_train(task, device, tiny, mesh)
        _sync(device)
        leaves = zip(param_leaves(state.params), param_leaves(state.param_specs, spec=True))
        digest = hashlib.sha256()
        replicated = 0
        for t, spec in leaves:
            if shard_axis(spec, "model") is None:
                digest.update(t.detach().cpu().numpy().tobytes())
                replicated += 1
        out[task] = dict(losses=losses, replicated_leaves=replicated,
                         replicated_sha256=digest.hexdigest(),
                         launches={k: n for k, n in all_launch_counts().items() if n})
        if device.type == "cuda":
            out[task]["peak_GiB"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        del state
        _empty_cache(device)
        seconds[task] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dryrun"] = multichip_dryrun.run_rank(mesh, device, seq_mesh)
    seconds["dryrun"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sp"] = _sp_rank(device, seq_mesh, tiny, work)
    seconds["sp"] = time.perf_counter() - t0
    out["seconds"] = seconds
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_tensor_parallel(device, work: str, bench: str, tiny: bool = False) -> dict:
    """Phase 29: tensor parallelism at TP 2, two ranks sharing the card over
    gloo (one spawn). Before it, in this process: kernels 11/12 at the first
    rank's shard of every LLaMA-7B product at decode and admission rows and
    kernel 13 at the sharded byt5-small and LLaMA-7B caches, against their
    plain versions (``[tp_kernel]``); and the two training steps on one
    rank. The ranks' results are held to: the served requests answered with
    finite scores, both ranks' beams bit-equal, the fp32 encoder output and
    first log-probs within 1e-4 of one rank's (the beams' share equal to
    one rank's printed); each rank's LLaMA-7B routes equal to one card's,
    every quantized product on a tensor-core body, the split weights' bytes
    half of one card's; the training losses within the bf16 limit of one
    rank's and the replicated leaves bit-equal across the ranks; the dry
    run's tensor- and sequence-parallel checks; every kernel of each path
    launched on every rank. Then the ranks' sequence-parallel encoders
    against one card's ``encode`` here (``_sp_check``, ``[sp]``)."""
    import shutil

    import torch
    import torch.multiprocessing as mp

    tp = TP_TINY if tiny else TP
    root = os.path.join(work, "tp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    seconds, failures, kernel_rows = {}, [], []
    t0 = time.perf_counter()
    if device.type == "cuda":
        gen = torch.Generator(device=device).manual_seed(29)
        m_decode = tp["llama_slots"] * tp["llama_beams"]
        m_admit = tp["llama_slots"] * (tp["llama_src"] - 1)
        for bits in (8, 4):
            for (k, n), column in zip(LLAMA_WEIGHT_SHAPES, (True, True, False, True)):
                for m in (m_decode, m_admit):
                    kernel_rows.append(_quant_row(device, bits, m, k, n, gen, TP["ranks"], column))
                    log(f"[tp_kernel] {json.dumps(kernel_rows[-1])}")
                    torch.cuda.empty_cache()
            # o: the row split of a [4096, 4096] weight (q/k/v are its column split)
            for m in (m_decode, m_admit):
                kernel_rows.append(_quant_row(device, bits, m, 4096, 4096, gen, TP["ranks"],
                                              False))
                log(f"[tp_kernel] {json.dumps(kernel_rows[-1])}")
        shapes = [(4, tp["slots"], tp["beams"], 6 // TP["ranks"], tp["dec"], 64),
                  (32, tp["llama_slots"], tp["llama_beams"], 32 // TP["ranks"], tp["llama_dec"],
                   128)]
        for row in _reorder_rows_fresh(shapes, 29):
            kernel_rows.append(row)
            log(f"[tp_kernel] {json.dumps(row)}")
        _check_rows(kernel_rows, "the tensor-parallel shard shapes' kernels do")
        off = [(r["kernel"], r["M"], r["K"], r["N"], r["body"]) for r in kernel_rows
               if "body" in r and r["body"] != "tma"]
        if off:
            failures.append(f"shard products off the tensor-core bodies: {off}")
    seconds["tp_kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = {task: _tp_train(task, device, tiny)[0] for task in ("generator", "finetune")}
    _empty_cache(device)
    seconds["tp_one_rank_train"] = time.perf_counter() - t0
    with open(os.path.join(bench, "random", "val.json")) as f:
        states = [t["traced_tactics"][0]["state_before"] for t in json.load(f)][: tp["requests"]]
    t0 = time.perf_counter()
    mp.spawn(_tp_rank, args=(device.type, tiny, states, root), nprocs=TP["ranks"], join=True)
    seconds["tp_ranks"] = time.perf_counter() - t0
    ranks = []
    for r in range(TP["ranks"]):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    lead = ranks[0]
    beams = [torch.load(os.path.join(root, f"beams{r}.pt")) for r in range(TP["ranks"])]
    beams_equal = all(torch.equal(beams[0][k], b[k]) for b in beams[1:] for k in beams[0])
    served = lead["byt5_served"]
    byt5 = dict(served=served, seconds=[round(r["byt5_s"], 1) for r in ranks],
                cache_per_rank=lead["byt5_cache"], ranks_beams_equal=beams_equal,
                fp32_encoder_rel=lead["fp32_encoder_rel"],
                fp32_logprob_rel=lead["fp32_logprob_rel"],
                fp32_beams_equal_share=lead["fp32_beams_equal_share"],
                fp32_score_gap=lead["fp32_score_gap"])
    log(f"[tp_byt5] {json.dumps(byt5)}")
    if served["requests"] != tp["requests"] or served["answers"] != [tp["beams"]] * tp[
            "requests"] or not served["finite"]:
        failures.append(f"byt5 TP serving answered {served}")
    if not beams_equal:
        failures.append("the byt5 ranks' beams differ")
    for key in ("fp32_encoder_rel", "fp32_logprob_rel"):
        if not lead[key] <= TP["fp32_rtol"]:
            failures.append(f"byt5 fp32 {key} {lead[key]} against one rank")
    for bits in (4, 8):
        rows = [r[f"llama_int{bits}"] for r in ranks]
        log(f"[tp_llama] int{bits} per rank: {json.dumps(rows)}")
        kernel = "quant4_matmul" if bits == 4 else "quant_matmul"
        for r, row in enumerate(rows):
            if not row["routes_equal"]:
                failures.append(f"LLaMA int{bits} rank {r}: routes differ from one card's")
            # The split weights' bytes halve but for the replicated scales of
            # int8's row-split products.
            if row["split_bytes"] > TP["split_share"] * row["split_bytes_one_rank"]:
                failures.append(f"LLaMA int{bits} rank {r}: split weights {row['split_bytes']} B "
                                f"of {row['split_bytes_one_rank']}")
            if device.type == "cuda" and (row["bodies"]["simple"] or
                                          row["launches"].get(kernel, 0) < 1
                                          or row["launches"].get("beam_reorder", 0) < 1):
                failures.append(f"LLaMA int{bits} rank {r}: kernels {row['launches']} bodies "
                                f"{row['bodies']}")
    for task in ("generator", "finetune"):
        rows = [r[task] for r in ranks]
        res = dict(losses_one_rank=one[task], losses=[row["losses"] for row in rows],
                   replicated_equal=len({row["replicated_sha256"] for row in rows}) == 1,
                   replicated_leaves=rows[0]["replicated_leaves"],
                   peak_GiB=[row.get("peak_GiB") for row in rows])
        log(f"[tp_{task}] {json.dumps(res)}")
        for row in rows:
            for a, b in zip(one[task], row["losses"]):
                if not abs(a - b) <= DP["loss_rtol"] * abs(a) + DP["loss_atol"] * max(1.0, abs(a)):
                    failures.append(f"{task}: loss {b} at TP 2 against {a} on one rank")
        if not res["replicated_equal"]:
            failures.append(f"{task}: replicated leaves differ across the ranks")
    required = {"byt5": ("encoder_attn", "beam_reorder"),
                "generator": FULL_ROW_KERNELS,
                "finetune": tuple("scaled_causal_attn" + p for p in ("", "_bwd_dq", "_bwd_dkv"))}
    launches = {r: {"byt5": ranks[r]["byt5_launches"],
                    **{t: ranks[r][t]["launches"] for t in ("generator", "finetune")},
                    **{f"llama_int{b}": ranks[r][f"llama_int{b}"]["launches"] for b in (4, 8)}}
                for r in range(TP["ranks"])}
    if device.type == "cuda":
        for r, per in launches.items():
            for path, names in required.items():
                missing = [k for k in names if per[path].get(k, 0) < 1]
                if missing:
                    failures.append(f"rank {r} {path}: no launch of {missing}")
    dry = [r["dryrun"] for r in ranks]
    log(f"[tp_dryrun] {json.dumps(dry)}")
    for d in dry:
        if not d["ok"]:
            failures.append(f"dryrun: rank {d['coords']} disagrees with one rank")
    t0 = time.perf_counter()
    sp, sp_failures = _sp_check(device, root, tiny, ranks)
    failures += sp_failures
    seconds["sp_one_card"] = time.perf_counter() - t0
    log(f"[sp] {json.dumps(sp)}")
    seconds.update({f"tp_{k}": round(max(r["seconds"][k] for r in ranks), 1)
                    for k in ranks[0]["seconds"]})
    if failures:
        raise AssertionError("tensor-parallel phase failed: " + "; ".join(failures))
    return dict(seconds={k: round(v, 1) for k, v in seconds.items()}, kernel_rows=kernel_rows,
                launches=launches, byt5=byt5, sp=sp)


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
    "quant_matmul": "reprover_tpu/ops/quant_matmul.py:28",
    "quant4_matmul": "reprover_tpu/ops/quant_matmul.py:136",
    "beam_reorder": "reprover_tpu/ops/beam_reorder.py:42",
}
SERVING_SOURCES = {"quant_matmul": "quant_matmul.cu", "quant4_matmul": "quant_matmul.cu",
                   "beam_reorder": "beam_reorder.cu"}
# The long route's kernels: the line of the TPU kernel each replaces (in
# reprover_tpu/ops/flash_attention.py), and the prefix of their keys in a
# ``_long_row``.
LONG_REPLACES = {"_long": ("reprover_tpu/ops/flash_attention.py:274", ""),
                 "_long_lse": ("reprover_tpu/ops/flash_attention.py:864", "lse_"),
                 "_long_bwd_dq": ("reprover_tpu/ops/flash_attention.py:934", "dq_"),
                 "_long_bwd_dkv": ("reprover_tpu/ops/flash_attention.py:1034", "dkv_")}
LONG_ERRS = {"_long": ("out",), "_long_lse": ("lse",),
             "_long_bwd_dq": ("dq", "d_rel", "dq_e2e", "d_rel_e2e"),
             "_long_bwd_dkv": ("dk", "dv", "dk_e2e", "dv_e2e")}


def serving_entry(name: str, rows: list, launches: int, llama_cache: list) -> dict:
    """The kernels-line entry of a serving kernel: its largest error over
    every checked shape, and its times at the LLaMA-7B decode design point
    (4096 x 11008 at M = 32 for kernels 11/12, the full [32, 4, 8, 32, 129,
    128] cache for kernel 13); kernels 11/12 also at the admission wave's
    rows (``admission_*``, 4096 x 11008 at M = 2044), and ``device_ms``
    beside ``ms``: the products queued behind a device sleep, without the
    host's enqueue; for kernel 13 the profiler's device ms, the host us a
    call and the bound that reads a parent once for every child."""
    mine = [r for r in rows if r["kernel"] == name]
    extra = {}
    if name == "beam_reorder":
        at = next(r for r in mine if r["shape"] == llama_cache and r["t_live"] == llama_cache[4])
        extra = {"device_ms": at["device_ms"], "host_us": at["host_us"],
                 "bound_all_parents_ms": at["bound_all_parents_ms"]}
    else:
        at = next(r for r in mine if (r["M"], r["K"], r["N"]) == (
            LLAMA["num_slots"] * LLAMA["num_beams"], 4096, 11008))
        adm = next(r for r in mine if (r["M"], r["K"], r["N"]) == (LLAMA_ADMIT_ROWS, 4096, 11008))
        extra = {"device_ms": at["device_ms"], "admission_ms": adm["ms"],
                 "admission_device_ms": adm["device_ms"], "admission_bound_ms": adm["bound_ms"],
                 "admission_bound_by": adm["bound_by"], "admission_library_ms": adm["library_ms"]}
    return {"name": name, "route": "cuda",
            "source": f"reprover_tpu_torch/csrc/{SERVING_SOURCES[name]}",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine), "ms": at["ms"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], **extra}


def kernel_entries(fwd_rows: list, bwd_rows: list, launches: dict) -> list:
    """The ``{"kernels": [...]}`` entries of the nine attention kernels: per
    kernel its launches on the main paths, its largest bf16 error over every
    checked shape, and its times, bound and library time at the
    generator-training shapes (encoder [8, 2304], causal [8, 512], cross
    [8, 512] x [8, 2304]), bf16."""
    main_shape = {"encoder_attn": (8, 2304, 2304), "causal_attn": (8, 512, 512),
                  "cross_attn": (8, 512, 2304)}
    entries = []
    for name, replaces in REPLACES.items():
        if name in SERVING_SOURCES:
            continue
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


def long_kernel_entries(rows: list, launches: dict) -> list:
    """The ``{"kernels": [...]}`` entries of kernels 2, 5, 6 and 7 in the
    three modes: launches on the long main paths, the largest bf16 error
    over every checked shape (the whole backward's included for 6 and 7),
    and the times, bound and library time at ``LONG_MAIN``, bf16. No
    library call computes the LSE sweep alone (kernel 5): its
    ``library_ms`` is null."""
    entries = []
    for attn in ATTENTIONS:
        mine = [r for r in rows if r["mode"] == attn and r["dtype"] == "bfloat16"]
        at = next(r for r in mine if (r["B"], r["Lq"], r["Lk"]) == LONG_MAIN[attn]
                  and r["block_kv"] == 0)
        for part, (replaces, key) in LONG_REPLACES.items():
            err = max(r["errs"][e] for r in mine for e in LONG_ERRS[part] if e in r["errs"])
            library = {"": at["library_ms"], "lse_": None}.get(key, at["library_bwd_ms"])
            source = "encoder_attn.cu" if key in ("", "lse_") else "encoder_attn_bwd.cu"
            entries.append({"name": attn + part, "route": "cuda",
                            "source": f"reprover_tpu_torch/csrc/{source}",
                            "replaces": replaces,
                            "launches": launches[attn + part], "max_abs_err": err,
                            "ms": at[f"{key}ms"], "plain_ms": at[f"{key}plain_ms"],
                            "bound_ms": at[f"{key}bound_ms"], "bound_by": at[f"{key}bound_by"],
                            "library_ms": library})
    return entries


# The scaled causal kernels: the line of the TPU code each replaces (the
# function that reaches kernel 1's pallas_call, then the backward's
# pallas_calls, then the long route's kernels), and the prefix of their keys
# in a ``_scaled_row``.
SCALED_REPLACES = {"": ("reprover_tpu/ops/flash_attention.py:1589", ""),
                   "_bwd_dq": ("reprover_tpu/ops/flash_attention.py:1343", "dq_"),
                   "_bwd_dkv": ("reprover_tpu/ops/flash_attention.py:1384", "dkv_"),
                   "_long": ("reprover_tpu/ops/flash_attention.py:274", ""),
                   "_long_lse": ("reprover_tpu/ops/flash_attention.py:864", "lse_"),
                   "_long_bwd_dq": ("reprover_tpu/ops/flash_attention.py:934", "dq_"),
                   "_long_bwd_dkv": ("reprover_tpu/ops/flash_attention.py:1034", "dkv_")}
SCALED_ERRS = {"": ("out",), "_lse": ("lse",), "_bwd_dq": ("dq", "dq_e2e"),
               "_bwd_dkv": ("dk", "dv", "dk_e2e", "dv_e2e")}


def scaled_kernel_entries(rows: list, launches: dict) -> list:
    """The ``{"kernels": [...]}`` entries of the scaled causal kernels: the
    full-row ones (1s, 3s, 4s) with their launches in fine-tuning (phase 20)
    and their times at ``SCALED_MAIN``, the long route's with their
    main-path launches (none: fine-tuning stays at or below 2048 tokens) and
    their times at ``SCALED_LONG_MAIN``; each with its largest error over
    every checked shape of its route (bf16 and fp32)."""
    entries = []
    for part, (replaces, key) in SCALED_REPLACES.items():
        long = part.startswith("_long")
        mine = [r for r in rows if (r["route"] == "long") == long]
        at = next(r for r in mine if r["dtype"] == "bfloat16" and (r["B"], r["T"], r["H"], r["d"])
                  == (SCALED_LONG_MAIN if long else SCALED_MAIN))
        kind = part.replace("_long", "") or ""
        err = max(r["errs"][e] for r in mine for e in SCALED_ERRS[kind])
        plain = at["lse_plain_ms"] if key == "lse_" else (
            at["plain_ms"] if key == "" else at["plain_bwd_ms"])
        library = {"": at["library_ms"], "lse_": None}.get(key, at["library_bwd_ms"])
        source = "encoder_attn.cu" if key in ("", "lse_") else "encoder_attn_bwd.cu"
        name = "scaled_causal_attn" + part
        entries.append({"name": name, "route": "cuda",
                        "source": f"reprover_tpu_torch/csrc/{source}", "replaces": replaces,
                        "launches": launches.get(name, 0), "max_abs_err": err,
                        "ms": at[f"{key}ms"], "plain_ms": plain,
                        "bound_ms": at[f"{key}bound_ms"], "bound_by": at[f"{key}bound_by"],
                        "library_ms": library})
    return entries


def bisect_entries(report: dict) -> list:
    """The entries of kernel 14's variants: launches in the harness's sweep,
    the largest error of the checks, and the times at the sweep's shape."""
    entries = []
    for name, row in report["variants"].items():
        err = max(c["max_abs_err"] for c in report["checks"] if c["variant"] == name)
        entries.append({"name": f"bisect_{name}", "route": "cuda",
                        "source": "reprover_tpu_torch/csrc/encoder_attn.cu",
                        "replaces": "benchmarks/flash_kernel_bisect.py:71",
                        "launches": row["launches"], "max_abs_err": err, "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    return entries


# The fused elementwise kernels: the plain JAX function each chain comes
# from (no Pallas kernel: XLA fuses these chains on the TPU).
FUSED_REPLACES = {"add_rms_norm": "none: XLA fuses reprover_tpu/models/t5.py:198 rms_norm",
                  "gated_gelu": "none: XLA fuses reprover_tpu/models/t5.py:207 gelu_new"}


def fused_entries(report: dict, launches: dict) -> list:
    """The entries of the fused elementwise kernels: launches on the main
    paths, the largest error over every checked shape, and the times at
    ``FUSED_MAIN`` (no library call computes either chain as one)."""
    entries = []
    for name, replaces in FUSED_REPLACES.items():
        at = next(r for r in report["times"] if r["kernel"] == name)
        entries.append({"name": name, "route": "cuda",
                        "source": "reprover_tpu_torch/csrc/fused_elementwise.cu",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(r["max_abs_err"] for r in report["rows"]
                                           if r["kernel"] == name),
                        "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
                        "bound_by": at["bound_by"], "library_ms": None})
    return entries


def main() -> int:
    import torch

    from reprover_tpu_torch.ops import fused_elementwise as fe

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda")
    seconds: dict = {}

    fused_launches: dict = {}

    def phase(name: str, fn, *args, **kwargs):
        """Run one phase; its wall seconds go to the ``[smoke]`` line, the
        fused elementwise kernels' launches in it (counted from 0: nothing
        else resets them) to ``fused_launches``."""
        t0 = time.perf_counter()
        fe.reset_launch_counts()
        result = fn(*args, **kwargs)
        seconds[name] = round(time.perf_counter() - t0, 1)
        if any(fe.KERNEL_LAUNCHES.values()):
            fused_launches[name] = dict(fe.KERNEL_LAUNCHES)
        return result

    info = phase("device", phase_device)
    phase("build", phase_build)
    phase("sass", phase_sass)
    rows = phase("kernel", phase_kernel, device)
    fused = phase("fused_kernels", phase_fused_kernels, device)
    dec_fwd, dec_bwd = phase("decoder_kernels", phase_decoder_kernels, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        bench = make_bench(work)
        bwd_rows = phase("kernel_backward", phase_kernel_backward, device, data_shapes(bench))
        cfg, gen_params, ret_params = _full_width_models(device)
        byt5_cache = [cfg.num_decoder_layers, STREAM["num_slots"], SLICE["num_sampled_tactics"],
                      cfg.num_heads, SLICE["max_oup_seq_len"], cfg.d_kv]
        serving_rows = phase("serving_kernels", phase_serving_kernels, device, byt5_cache)
        sl = phase("slice", phase_slice, device, bench, cfg, gen_params, ret_params)
        phase("diverse", phase_diverse, device, cfg, gen_params, sl["packed_source"])
        phase("sanity", phase_sanity, device, cfg, ret_params)
        st = phase("streaming", phase_streaming, device, bench, cfg, gen_params, ret_params)
        del gen_params, ret_params
        torch.cuda.empty_cache()
        ll = phase("llama", phase_llama, device, bench)
        torch.cuda.empty_cache()
        tr = phase("train", phase_train, device, work, bench)
        phase("train_steps", phase_train_steps, device, bench)
        torch.cuda.empty_cache()
        gt = phase("generator_train", phase_generator_train, device, work, bench)
        torch.cuda.empty_cache()
        phase("generator_steps", phase_generator_steps, device)
        torch.cuda.empty_cache()
        long_rows = phase("long_kernels", phase_long_kernels, device)
        ls = phase("long_serving", phase_long_serving, device, bench)
        lg = phase("long_generator_train", phase_generator_train, device, work,
                   make_bench(work, long=True), gen=LONG_GEN)
        torch.cuda.empty_cache()
        phase("long_generator_steps", phase_generator_steps, device, gen=LONG_GEN)
        torch.cuda.empty_cache()
        reset_all_launch_counts()
        scaled_rows = phase("scaled_kernels", phase_scaled_kernels, device)
        scaled_check_launches = {k: n for k, n in all_launch_counts().items() if n}
        ft = phase("finetune", phase_finetune, device, work, bench)
        phase("finetune_steps", phase_finetune_steps, device)
        bs = phase("bisect", phase_bisect, device)
        torch.cuda.empty_cache()
        rm = phase("remat", phase_remat, device)
        torch.cuda.empty_cache()
        pt = phase("pretrain", phase_pretrain, device, work, bench)
        torch.cuda.empty_cache()
        ev = phase("evaluate", phase_evaluate, device, work, bench, tr["validation"])
        cfg, gen_params, ret_params = _full_width_models(device)
        at = phase("attribution", phase_attribution, device, bench, cfg, gen_params, ret_params,
                   sl["failed"])
        del ret_params
        ld = phase("load", phase_load, device, work, cfg, gen_params)
        del gen_params
        torch.cuda.empty_cache()
        dp = phase("data_parallel", phase_data_parallel, device, work, bench, ev["index"])
        seconds.update(dp["seconds"])
        tpr = phase("tensor_parallel", phase_tensor_parallel, device, work, bench)
        seconds.update(tpr["seconds"])
    log(f"[smoke] phase seconds {json.dumps(seconds)}")
    log(f"[smoke] wall time {time.perf_counter() - t_start:.1f}s")

    # Launches on the main paths: serving, retriever and generator training,
    # the remat policies' steps, pretraining (and fine-tuning from its
    # export), streaming byt5-small, LLaMA-7B int4 and int8.
    launches = {name: tr["launches"][name] + gt["launches"][name]
                + rm["launches"].get(name, 0) + pt["launches"].get(name, 0)
                for name in REPLACES if name not in SERVING_SOURCES}
    launches["encoder_attn"] += (sl["launches"] + ev["launches"]["encoder_attn"]
                                 + at["launches"]["encoder_attn"]
                                 + ld["launches"]["encoder_attn"])
    log(f"[smoke] phase-25 (evaluate), 26 (attribution), 27 (load) launches of kernel 1: "
        f"{ev['launches']['encoder_attn']}, {at['launches']['encoder_attn']}, "
        f"{ld['launches']['encoder_attn']}; of kernel 13 in phase 27: "
        f"{ld['launches']['beam_reorder']}")
    log(f"[smoke] phase-28 (data parallel) launches per rank: "
        f"{json.dumps({t: r['launches_per_rank'] for t, r in dp['results'].items()})}; the "
        f"kernels line counts the one-card main paths only")
    log(f"[smoke] phase-29 (tensor parallel) launches per rank: {json.dumps(tpr['launches'])}; "
        f"the kernels line counts the one-card main paths only")
    log(f"[smoke] phase-23 (remat) launches "
        f"{json.dumps({k: n for k, n in rm['launches'].items() if n})}; phase-24 (pretraining) "
        f"launches {json.dumps({k: n for k, n in pt['launches'].items() if n})}")
    entries = kernel_entries(rows + dec_fwd, bwd_rows + dec_bwd, launches)
    llama_cache = [32, LLAMA["num_slots"], LLAMA["num_beams"], 32, LLAMA["dec"], 128]
    serving_launches = {
        "quant_matmul": ll["int8"]["launches"]["quant_matmul"],
        "quant4_matmul": ll["int4"]["launches"]["quant4_matmul"],
        "beam_reorder": st["beam_reorder_launches"] + ll["int4"]["launches"]["beam_reorder"]
        + ll["int8"]["launches"]["beam_reorder"] + ld["launches"]["beam_reorder"],
    }
    entries += [serving_entry(name, serving_rows, n, llama_cache)
                for name, n in serving_launches.items()]
    # The long route's main paths: long serving, generator training at 8192
    # bytes and phase 23's long step. The causal mode runs only in phase 15: no path has a
    # target past 4096 (T <= 512).
    long_launches = {a + p: ls["launches"].get(a + p, 0) + lg["launches"][a + p]
                     + rm["launches"].get(a + p, 0) for a in ATTENTIONS for p in LONG_PARTS}
    log(f"[smoke] long-route launches on the main paths {json.dumps(long_launches)}; the "
        f"causal_attn_long kernels are launched by the check phase only (T <= 512 on every "
        f"path)")
    entries += long_kernel_entries(long_rows, long_launches)
    # Decoder-only fine-tuning: the scaled causal kernels' launches in phase
    # 20; their long route runs in phase 19's checks only (fine-tuning
    # sequences stay at or below 2048 tokens); kernel 14's in its sweep.
    log(f"[smoke] phase-19 check launches {json.dumps(scaled_check_launches)}; the "
        f"scaled_causal_attn_long kernels are launched by the check phase only (T <= 2048 in "
        f"fine-tuning)")
    entries += scaled_kernel_entries(scaled_rows, ft["launches"])
    entries += bisect_entries(bs)
    # The fused elementwise kernels: every inference path of the T5 models
    # in bf16 on the card (serving, re-indexing, the streaming engine,
    # evaluation, validation inside training); phase 3b is their check.
    log(f"[smoke] fused elementwise launches by phase {json.dumps(fused_launches)}")
    main_fused = {name: sum(n.get(name, 0) for p, n in fused_launches.items()
                            if p != "fused_kernels") for name in FUSED_REPLACES}
    entries += fused_entries(fused, main_fused)
    unfused = [p for p in ("slice", "streaming")
               if not all(fused_launches.get(p, {}).get(name) for name in FUSED_REPLACES)]
    if unfused:
        raise AssertionError(f"phases {unfused} served byt5-small in bf16 on the card without "
                             f"launching both fused elementwise kernels: {fused_launches}")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["name"], "count": info["count"]}}), flush=True)
    return 0


_CHILD_ENV = "CHIP_SMOKE_PHASES"


def _prctl(option: int, arg: int) -> None:
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(option, arg, 0, 0, 0)


def _left_behind() -> list:
    """The live processes handed to this one, a subreaper, when their parent
    died: ``[(pid, command line)]``."""
    me, found = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            # The fields after the command's closing parenthesis: state, ppid.
            state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
            if int(ppid) == me:
                with open(f"/proc/{name}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode()[:120]
                found.append((int(name), cmd if state != "Z" else None))
        except (OSError, ValueError):
            continue  # ended meanwhile
    return found


def _stop_left_behind(grace_s: float = 0.0) -> None:
    """Kill and reap every process handed to this one, until none is left
    (a killed process's children are handed over in turn); for the first
    ``grace_s`` seconds only reap those that end by themselves
    (multiprocessing's resource tracker ends once its owner has)."""
    stopped: dict = {}
    grace_end = time.monotonic() + grace_s
    for _ in range(400):
        procs = _left_behind()
        if not procs:
            break
        for pid, cmd in procs:
            if cmd is not None and time.monotonic() >= grace_end:
                stopped.setdefault(pid, cmd)
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        time.sleep(0.05)
        while True:
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break
    if stopped:
        print(f"[smoke] stopped {len(stopped)} processes the run left behind: "
              f"{json.dumps(sorted(stopped.items()))}", file=sys.stderr, flush=True)


def supervise(argv: list) -> int:
    """Run ``main`` in a child process and stop every process the run leaves
    behind once the child has ended, however it ended. This process is the
    run's subreaper: a process whose parent dies is handed to it, not to
    init, so none escapes. The child dies with this process
    (``PR_SET_PDEATHSIG``), and SIGTERM, SIGINT and SIGHUP stop the child
    and what it left before this process exits; every process stays in the
    caller's process group."""
    _prctl(36, 1)  # PR_SET_CHILD_SUBREAPER
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv],
        env={**os.environ, _CHILD_ENV: "1"},
        preexec_fn=lambda: _prctl(1, signal.SIGKILL))  # PR_SET_PDEATHSIG

    def stop(signum, frame):
        # Not child.wait(): the interrupted wait holds its lock. The child is
        # reaped with the rest.
        try:
            os.kill(child.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        _stop_left_behind()
        sys.exit(128 + signum)

    for signum in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        signal.signal(signum, stop)
    rc = child.wait()
    _stop_left_behind(grace_s=2.0)
    return rc if rc >= 0 else 128 - rc  # killed by a signal: 128 + its number


if __name__ == "__main__":
    sys.exit(main() if os.environ.get(_CHILD_ENV) else supervise(sys.argv[1:]))
