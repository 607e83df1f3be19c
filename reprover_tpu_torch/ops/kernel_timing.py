"""Time the attention kernels (forward, dQ, dK/dV) and the weight-only
quantized products of one checkout of this repository on the card, for
comparing two versions in one call.

    python reprover_tpu_torch/ops/kernel_timing.py --checkout DIR --label NAME \
        [--shapes 8x2304] [--decoder 8x512x2304] [--long 4x8192] [--quant 32x4096x11008]

imports ``reprover_tpu_torch`` from ``DIR`` (which builds its own kernels into
``DIR/build/kernels``) and prints one JSON line per shape: bf16 q/k/v of
byt5-small attention (6 heads x 64) with ragged key masks, made from a seed.
The ``--shapes`` rows use only functions that every version of the port has
(``encoder_flash_attention``, ``encoder_attention_backward`` and
``encoder_attention_lse_reference``; keep their lengths within 4096, the
full-row route); each kernel's time is its device time from
``torch.profiler`` over ``--iters`` launches, beside the forward's time
from CUDA events. ``--decoder BxTxS`` adds the generator decoder's kernels
1c/3c/4c (causal self-attention at ``[B, T]``) and 8/9/10 (cross-attention
of ``[B, T]`` queries over ``[B, S]`` keys), forward and autograd backward
through ``causal_flash_attention`` and ``cross_flash_attention``. ``--long BxL`` adds the long route's kernels 2, 5, 6 and 7
(a checkout that has ``long_attention_backward``): the encoder at
``[B, L]`` and the cross-attention of ``[B, 512]`` queries (the
generator's target cap) over it. ``--scaled BxTxHxD`` adds the LLaMA family's scaled
causal kernels 1s/3s/4s (a checkout that has ``scaled_causal_flash_attention``),
forward and autograd backward at ``[B, T]`` with H heads of width D and
right-padded key masks, the fine-tuning data module's layout. ``--quant
MxKxN`` adds the weight-only products, kernels 11 (int8) and 12 (int4, the
quantizer's group), through ``quant_matmul`` / ``quant4_matmul`` on weights
made from a seed and cycled over copies that exceed the 50 MB L2 cache, bf16
output (fp32 at N = 32000, the lm_head): one JSON line per shape and bits
with ``ms`` (CUDA events around back-to-back calls queued behind a device
sleep, so the device's time and not the host's enqueue: every kernel a call
launches counts), ``device_ms`` (the profiler's sum over the call's
kernels) and ``host_us`` (the host's time to issue one call). Run the
checkouts in turns (parent, change, change, parent), each in its own
process, on one card: times from two cards do not compare. ``--engine N``
adds N samples of the LLaMA-7B int4 streaming engine (seeded random
weights at full width, 4 slots x 8 beams, prompts of 512 tokens): the
admission wave's ms and the next 32 steps' ms per step, host clock.
``--t5-engine N`` adds N samples of the same for the byt5-small streaming
engine (``StepwiseBeamEngine``: seeded random bf16 weights, 16 slots x 64
beams, sources of 2048 bytes, reorder by the gather kernel), whose decode
step runs the T5 blocks.
``--reorder LxSxKxHxTxd[:T_live]`` (repeatable) adds kernel 13, the beam-cache
reorder, on the ``T_live`` prefix (all T by default) of bf16 caches made from
a seed (int64 parents and positions, a frozen slot, the engines' dtypes) and
cycled over copies past the L2 cache: one JSON line a shape with
``device_ms`` (the profiler's sum over every kernel one call launches),
``launches`` (kernels a call launches), ``queued_ms`` and ``host_us`` as
above, ``bound_ms`` (a new beam's rows written once and each distinct
parent's read once, at 3.35 TB/s; ``bound_all_parents_ms`` reads a parent
once a child), ``library_ms`` (``index_select`` and the column write), the engine's
``einsum_ms`` and ``scan_ms`` (queued), and whether the result is bit-equal
to the plain version; where the checkout's wrapper has
``VECTOR_ROW_BYTES``, also each branch forced (``bulk_*``, ``vector_*``).
``--fused [BxL,...]`` (by default the re-index cell's 64x256, 64x512 and
64x1024; a checkout that has ``ops/fused_elementwise.py``) adds the T5
block's fused elementwise kernels at byt5-small's widths: ``add_rms_norm``
on ``[B, L, 1472]`` and ``gated_gelu`` on the two halves of a ``[B, L,
7168]`` product, bf16 operands made from a seed and cycled past the L2
cache: one JSON line a kernel and shape with ``ms`` (CUDA events around
queued calls, as above), ``bound_ms`` (each operand byte read and each
output byte written once, at 3.35 TB/s), ``bound_pct``, ``plain_ms`` (the
model's plain chain, ``h + delta`` then ``rms_norm``, or ``gelu_new(gate)
* up``) and ``speedup`` (plain over fused).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import Callable, Dict, List, Tuple


# attn_<part>_kernel<T, mode> (versions before the long route),
# attn_<part>_kernel<T, mode, route>, or with the head width (and, for the
# forward, the ablation variant) after the route.
_KERNEL = re.compile(
    r"attn_(fwd|bwd_dq|bwd_dkv)_kernel<[^,>]+,\s*(\d)(?:,\s*(\d))?((?:,\s*\d+)*)>")
_MODE_PREFIX = {0: "", 1: "causal_", 2: "cross_", 3: "scaled_causal_"}


def _kernel_kind(name: str) -> str:
    """'fwd', 'dq' or 'dkv' for a full-row encoder attention kernel's
    profiled name, 'long', 'long_lse', 'long_dq' or 'long_dkv' for the long
    route's, the same with 'causal_', 'cross_' or 'scaled_causal_' before it
    for the other modes; '' for another kernel (or an ablation variant)."""
    m = _KERNEL.search(name)
    if m is None:
        return ""
    extra = [int(x) for x in re.findall(r"\d+", m.group(4))]
    if len(extra) == 2 and extra[1] != 0:
        return ""
    part = {"fwd": "fwd", "bwd_dq": "dq", "bwd_dkv": "dkv"}[m.group(1)]
    route = int(m.group(3) or 0)
    if route == 0:
        kind = part
    elif part == "fwd":
        kind = "long" if route == 1 else "long_lse"
    else:
        kind = f"long_{part}"
    return _MODE_PREFIX[int(m.group(2))] + kind


def _device_ms(fn: Callable[[], object], iters: int) -> Dict[str, float]:
    """Per-launch device ms of each attention kernel kind that ``fn`` runs,
    from ``torch.profiler`` over ``iters`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    sums: Dict[str, float] = {}
    for e in prof.events():
        kind = _kernel_kind(e.name)
        if e.device_type == DeviceType.CUDA and kind:
            sums[kind] = sums.get(kind, 0.0) + e.time_range.elapsed_us()
    return {f"{kind}_ms": us / 1e3 / iters for kind, us in sorted(sums.items())}


def time_shape(tfa: object, b: int, length: int, iters: int, seed: int) -> Dict[str, float]:
    """Per-launch ms of the three encoder kernels at ``[b, length]`` bf16."""
    import torch

    heads, inner = 6, 384
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn((b, length, inner), generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))
    lengths = torch.randint(length // 2, length + 1, (b,), generator=gen, device="cuda")
    lengths[0] = length
    mask = (torch.arange(length, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    rel = torch.randn((32, heads), generator=gen, device="cuda")
    out = tfa.encoder_flash_attention(q, k, v, mask, rel, num_heads=heads)
    lse = tfa.encoder_attention_lse_reference(q, k, mask, rel, heads)

    def forward() -> None:
        tfa.encoder_flash_attention(q, k, v, mask, rel, num_heads=heads)

    def backward() -> None:
        tfa.encoder_attention_backward(q, k, v, mask, rel, out, lse, dout, heads)

    forward()
    backward()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        forward()
    end.record()
    torch.cuda.synchronize()
    row = {"fwd_event_ms": start.elapsed_time(end) / iters}
    row.update(_device_ms(lambda: (forward(), backward()), iters))
    return row


def time_decoder(tfa: object, b: int, t: int, s: int, iters: int,
                 seed: int) -> Dict[str, float]:
    """Per-launch ms of the decoder's kernels, bf16: causal self-attention
    at ``[b, t]`` (kernels 1c/3c/4c, the relative-position bias included)
    and cross-attention of ``[b, t]`` over ``[b, s]`` with ragged source
    masks (8/9/10), each forward and autograd backward."""
    import torch

    heads, inner = 6, 384
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(n: int) -> "torch.Tensor":
        return torch.randn((b, n, inner), generator=gen, device="cuda").to(torch.bfloat16)

    lengths = torch.randint(s // 2, s + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    rel = torch.randn((32, heads), generator=gen, device="cuda")
    q, dout, k_self, v_self, k, v = rand(t), rand(t), rand(t), rand(t), rand(s), rand(s)
    leaves = [x.requires_grad_(True) for x in (q, k_self, v_self, k, v)]

    def step() -> None:
        out = tfa.causal_flash_attention(leaves[0], leaves[1], leaves[2], rel, num_heads=heads)
        torch.autograd.grad(out, leaves[:3], dout)
        out = tfa.cross_flash_attention(leaves[0], leaves[3], leaves[4], mask, num_heads=heads)
        torch.autograd.grad(out, [leaves[0], leaves[3], leaves[4]], dout)

    step()
    torch.cuda.synchronize()
    return _device_ms(step, iters)


def time_long(tfa: object, b: int, length: int, queries: int, iters: int,
              seed: int) -> List[Dict[str, float]]:
    """Per-launch ms of the long route's kernels at ``[b, length]`` bf16:
    the encoder's (kernels 2, 5, 6, 7 with the relative-position bias), and
    the cross-attention's of ``[b, queries]`` over ``[b, length]``; and the
    forward alone by CUDA events (``fwd_event_ms``)."""
    import torch

    heads, inner = 6, 384
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(n: int) -> "torch.Tensor":
        return torch.randn((b, n, inner), generator=gen, device="cuda").to(torch.bfloat16)

    lengths = torch.randint(length // 2, length + 1, (b,), generator=gen, device="cuda")
    lengths[0] = length
    mask = (torch.arange(length, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    rel = torch.randn((32, heads), generator=gen, device="cuda")
    rows = []
    for mode, lq, bias in ((tfa.ENCODER, length, rel), (tfa.CROSS, queries, None)):
        q, dout, k, v = rand(lq), rand(lq), rand(length), rand(length)
        out = tfa.long_attention_forward(mode, q, k, v, mask, bias, heads)

        def step() -> None:
            tfa.long_attention_forward(mode, q, k, v, mask, bias, heads)
            tfa.long_attention_backward(mode, q, k, v, mask, bias, out, dout, heads)

        step()
        torch.cuda.synchronize()
        # The forward alone, by CUDA events (in the profiled steps it starts
        # from the cache state the backward leaves).
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            tfa.long_attention_forward(mode, q, k, v, mask, bias, heads)
        end.record()
        torch.cuda.synchronize()
        row = {"mode": tfa.KERNEL_NAMES[mode], "B": b, "Lq": lq, "Lk": length,
               "fwd_event_ms": start.elapsed_time(end) / iters}
        row.update(_device_ms(step, iters))
        rows.append(row)
    return rows


def time_scaled(tfa: object, b: int, t: int, heads: int, d: int, iters: int,
                seed: int) -> Dict[str, float]:
    """Per-launch ms of the scaled causal kernels at ``[b, t]``, ``heads`` x
    ``d``, bf16: forward and autograd backward through
    ``scaled_causal_flash_attention`` with right-padded key masks."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn((b, t, heads * d), generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device="cuda")
    lengths[0] = t
    mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]

    def step() -> None:
        out = tfa.scaled_causal_flash_attention(*leaves, mask, heads, d ** -0.5)
        torch.autograd.grad(out, leaves, dout)

    step()
    torch.cuda.synchronize()
    return _device_ms(step, iters)


L2_BYTES = 50 * 2 ** 20


def parse_quant(spec: str) -> List[Tuple[int, int, int]]:
    """``"MxKxN,..."`` -> ``[(M, K, N), ...]``; an empty string gives none."""
    shapes = []
    for item in filter(None, (part.strip() for part in spec.split(","))):
        dims = item.split("x")
        if len(dims) != 3 or not all(d.isdigit() and int(d) > 0 for d in dims):
            raise ValueError(f"--quant wants MxKxN with positive sizes, got {item!r}")
        shapes.append((int(dims[0]), int(dims[1]), int(dims[2])))
    return shapes


def queued_ms(fn: Callable[[int], object], copies: int, iters: int) -> Tuple[float, float]:
    """``(device ms per call, host us per call)`` of ``fn(i)`` cycling over
    ``copies`` operand sets: the calls are queued behind a device sleep
    longer than their enqueue, so the events time the device running them
    back to back."""
    import time

    import torch

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i % copies)
    host_s = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * (2 * host_s * iters + 1e-3)))  # ~2 GHz cycles
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % copies)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 1e6 * host_s


def time_quant(qm: object, qz: object, m: int, k: int, n: int, bits: int, iters: int,
               seed: int) -> Dict[str, float]:
    """Kernel 11 (bits 8) or 12 (bits 4) on ``[m, k] x [k, n]``, bf16
    activations, over weight copies that exceed the L2 cache."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
    qw = qz.quantize_weight(w) if bits == 8 else qz.quantize_weight4(w)
    del w
    copies = max(1, -(-3 * L2_BYTES // qw.nbytes))
    ws = [qw] + [type(qw)(**{f: getattr(qw, f).clone() if torch.is_tensor(getattr(qw, f))
                             else getattr(qw, f) for f in qw.__dataclass_fields__})
                 for _ in range(copies - 1)]
    out_dtype = torch.float32 if n == 32000 else torch.bfloat16
    if bits == 8:
        def call(i: int) -> object:
            return qm.quant_matmul(x, ws[i].q, ws[i].scale.reshape(-1), out_dtype)
    else:
        def call(i: int) -> object:
            return qm.quant4_matmul(x, ws[i].q, ws[i].scale, ws[i].group, out_dtype)
    ms, host_us = queued_ms(call, copies, iters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            call(i % copies)
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    return {"M": m, "K": k, "N": n, "bits": bits, "group": getattr(qw, "group", None),
            "ms": ms, "device_ms": device_us / 1e3 / iters, "host_us": host_us}


def time_engine(samples: int, seed: int, cfg: object = None, device: str = "cuda",
                num_slots: int = 4, num_beams: int = 8, src: int = 512, dec: int = 129,
                chunk: int = 8, chunks: int = 4) -> Dict[str, object]:
    """The int4 streaming engine of ``cfg`` (LLaMA-7B by default; random
    weights from ``seed``, reorder by the gather kernel) at the serving
    geometry: ``samples`` times (after one untimed), a blank state, one
    admission wave of ``num_slots`` random prompts of ``src`` tokens, then
    ``chunks`` chunks of ``chunk`` steps; per sample the wave's ms and the
    chunks' ms per step, both on the host clock with the device
    synchronized."""
    import time

    import torch

    from reprover_tpu_torch.generation.causal_engine import CausalStepwiseEngine
    from reprover_tpu_torch.models.causal_lm import CausalLMConfig, init_serving_params

    cfg = cfg or CausalLMConfig(compute_dtype=torch.bfloat16)
    params = init_serving_params(cfg, seed, device, bits=4)
    engine = CausalStepwiseEngine(params, cfg, num_slots=num_slots, num_beams=num_beams,
                                  max_src_len=src, max_decode_len=dec, chunk_size=chunk,
                                  reorder_mode="gather")
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, cfg.vocab_size, (num_slots, src), generator=gen)
    mask = torch.ones_like(ids)

    def sync() -> None:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    admit_ms: List[float] = []
    step_ms: List[float] = []
    for sample in range(samples + 1):
        engine.reset()
        sync()
        t0 = time.perf_counter()
        engine.admit_batch_tokens(list(range(num_slots)), ids, mask)
        sync()
        admit = 1e3 * (time.perf_counter() - t0)
        steps, t0 = 0, time.perf_counter()
        for _ in range(chunks):
            steps += engine.unpack_status(engine.dispatch_run(chunk))[3]
        sync()
        if sample:
            admit_ms.append(admit)
            step_ms.append(1e3 * (time.perf_counter() - t0) / max(steps, 1))
    return {"engine": "int4", "d_model": cfg.d_model, "slots": num_slots, "beams": num_beams, "src": src,
            "steps_per_sample": steps, "admit_ms": admit_ms, "ms_per_step": step_ms}


def time_t5_engine(samples: int, seed: int, device: str = "cuda", num_slots: int = 16,
                   num_beams: int = 64, src: int = 2048, dec: int = 512, chunk: int = 8,
                   chunks: int = 4) -> Dict[str, object]:
    """:func:`time_engine` for byt5-small's streaming beam engine: random
    weights from ``seed`` (bf16 products, fused ``wi``), ``num_slots`` random
    byte sources of ``src`` bytes, reorder by the gather kernel."""
    import time

    import torch

    from reprover_tpu_torch.generation.engine import StepwiseBeamEngine
    from reprover_tpu_torch.models.t5 import byt5_small, fuse_mlp_params, init_params, place_params

    cfg = byt5_small(compute_dtype=torch.bfloat16)
    params = place_params(fuse_mlp_params(init_params(cfg, torch.Generator().manual_seed(seed))),
                          cfg, device)
    engine = StepwiseBeamEngine(params, cfg, num_slots=num_slots, num_beams=num_beams,
                                max_src_len=src, max_decode_len=dec, chunk_size=chunk,
                                reorder_mode="gather")
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, cfg.vocab_size, (num_slots, src), generator=gen)
    mask = torch.ones_like(ids)
    admit_ms: List[float] = []
    step_ms: List[float] = []
    for sample in range(samples + 1):
        engine.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.admit_batch_tokens(list(range(num_slots)), ids, mask)
        torch.cuda.synchronize()
        admit = 1e3 * (time.perf_counter() - t0)
        steps, t0 = 0, time.perf_counter()
        for _ in range(chunks):
            steps += engine.unpack_status(engine.dispatch_run(chunk))[3]
        torch.cuda.synchronize()
        if sample:
            admit_ms.append(admit)
            step_ms.append(1e3 * (time.perf_counter() - t0) / max(steps, 1))
    return {"engine": "byt5-small", "slots": num_slots, "beams": num_beams, "src": src,
            "steps_per_sample": steps, "admit_ms": admit_ms, "ms_per_step": step_ms}


PEAK_BYTES_PER_S = 3.35e12


def parse_reorder(spec: str) -> Tuple[Tuple[int, ...], int]:
    """``"LxSxKxHxTxd[:T_live]"`` -> ``((L, S, K, H, T, d), T_live)``."""
    dims, _, live = spec.partition(":")
    parts = dims.split("x")
    if len(parts) != 6 or not all(p.isdigit() and int(p) > 0 for p in parts) or (
            live and not (live.isdigit() and 0 < int(live) <= int(parts[4]))):
        raise ValueError(f"--reorder wants LxSxKxHxTxd[:T_live] with 0 < T_live <= T, got {spec!r}")
    shape = tuple(int(p) for p in parts)
    return shape, int(live) if live else shape[4]


def reorder_bound_ms(shape: Tuple[int, ...], t_live: int, parent: "torch.Tensor",
                     frozen: "torch.Tensor", itemsize: int) -> Tuple[float, float]:
    """Kernel 13's bound at 3.35 TB/s: ``(this call's, every child's)``. A
    call must write every new beam's ``t_live`` rows of both caches and read
    each distinct parent's once (its row ``pos`` from the column instead),
    so the first counts the distinct effective parents of each slot; the
    second reads a parent's rows once for every child, and the column."""
    import torch

    L, S, K, H, _, d = shape
    row = d * itemsize
    eff = torch.where(frozen[:, None].bool(), torch.arange(K, device=parent.device)[None, :],
                      parent.long())
    distinct = int(torch.zeros((S, K), device=parent.device).scatter_(1, eff, 1.0).sum().item())
    written = 2 * L * S * K * H * t_live * row
    needed = written + 2 * L * distinct * H * t_live * row
    every = 2 * written + 2 * L * S * K * H * row
    return 1e3 * needed / PEAK_BYTES_PER_S, 1e3 * every / PEAK_BYTES_PER_S


def index_select_reorder(br: object, k: "torch.Tensor", v: "torch.Tensor", kc: "torch.Tensor",
                         vc: "torch.Tensor", parent: "torch.Tensor", frozen: "torch.Tensor",
                         pos: "torch.Tensor") -> Callable[[], None]:
    """Kernel 13's library yardstick on the ``T_live`` caches ``k``/``v``:
    a call that reorders each by ``torch.index_select`` and writes the
    columns with one indexed assignment (timed only; the port never calls
    it)."""
    import torch

    L, S, K, H, t_live, d = k.shape
    eff = br.parent_effective(parent, frozen)
    flat_idx = (torch.arange(S, device=k.device)[:, None] * K + eff).reshape(-1)
    slot_ix = torch.arange(S, device=k.device)[:, None]
    live = torch.nonzero(pos < t_live)[:, 0]

    def library() -> None:
        for cache, col in ((k, kc), (v, vc)):
            out = torch.index_select(cache.reshape(L, S * K, H, t_live, d), 1,
                                     flat_idx).view(L, S, K, H, t_live, d)
            cols = col[:, slot_ix, eff][:, :, :, :, 0].permute(1, 0, 2, 3, 4)  # [S, L, K, H, d]
            out.permute(1, 4, 0, 2, 3, 5)[live, pos[live]] = cols[live]

    return library


def profile_calls(fn: Callable[[], object], iters: int) -> Tuple[float, float]:
    """``(device ms a call, kernels a call)`` of ``fn``: the profiler's
    records of ``iters`` calls, each kernel's mean time by its launches a
    call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: Dict[str, List[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset")):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    # A kernel's launches a call, rounded: the profiler now and then drops a
    # record of a long run, which would read as a fraction of a launch.
    per_call = {name: round(len(us) / iters) for name, us in by_name.items()}
    return (sum(sum(us) / len(us) * per_call[name] for name, us in by_name.items()) / 1e3,
            float(sum(per_call.values())))


def time_reorder(br: object, te: object, shape: Tuple[int, ...], t_live: int, iters: int,
                 seed: int) -> Dict[str, object]:
    """Kernel 13 through ``br.reorder_append_gather`` at ``shape`` bf16 over
    its first ``t_live`` columns, beside ``index_select`` and the engine's
    plain modes, on operand sets cycled past the L2 cache."""
    import torch

    L, S, K, H, T, d = shape
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    live = L * S * K * H * t_live * d * 2  # bytes of one cache's live prefix
    copies = max(1, -(-3 * L2_BYTES // (4 * live)))
    sets = []
    for _ in range(copies):
        k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(2))
        kc, vc = (torch.randn((L, S, K, H, 1, d), generator=gen, device="cuda").to(dt)
                  for _ in range(2))
        sets.append((k, v, kc, vc, torch.zeros_like(k), torch.zeros_like(v)))
    parent = torch.randint(0, K, (S, K), generator=gen, device="cuda")
    frozen = torch.zeros(S, dtype=torch.bool, device="cuda")
    frozen[-1] = True
    pos = torch.randint(0, t_live, (S,), generator=gen, device="cuda")
    cut = (slice(None),) * 4 + (slice(0, t_live),)
    views = [(k[cut], v[cut], kc, vc, ok[cut], ov[cut]) for k, v, kc, vc, ok, ov in sets]

    def call(i: int) -> object:  # the wrapper alone: the views are cut once
        k, v, kc, vc, ok, ov = views[i]
        return br.reorder_append_gather(k, v, kc, vc, parent, frozen, pos, ok, ov)

    def check() -> bool:
        k, v, kc, vc, ok, ov = sets[0]
        ok.zero_(), ov.zero_()
        call(0)
        want = br.reorder_append_gather_reference(k[cut], v[cut], kc, vc, parent, frozen, pos)
        return bool(torch.equal(ok[cut], want[0]) and torch.equal(ov[cut], want[1]))

    def measure(prefix: str) -> Dict[str, object]:
        queued, host_us = queued_ms(call, copies, iters)
        device, launches = profile_calls(lambda: [call(i) for i in range(copies)], iters)
        return {f"{prefix}bit_equal": check(), f"{prefix}device_ms": device / copies,
                f"{prefix}launches": launches / copies, f"{prefix}queued_ms": queued,
                f"{prefix}host_us": host_us}

    row: Dict[str, object] = {"shape": list(shape), "t_live": t_live, "dtype": "bfloat16",
                              "copies": copies}
    row.update(measure(""))
    knob = getattr(br, "VECTOR_ROW_BYTES", None)
    if knob is not None:
        try:
            for branch, value in (("bulk", 1 << 30), ("vector", 16)):
                br.VECTOR_ROW_BYTES = value
                row.update(measure(f"{branch}_"))
        finally:
            br.VECTOR_ROW_BYTES = knob
    row["span_bytes"], row["row_bytes"] = t_live * d * 2, d * 2
    row["bound_ms"], row["bound_all_parents_ms"] = reorder_bound_ms(shape, t_live, parent, frozen,
                                                                    2)
    row["bound_by"] = "bytes"

    libraries = [index_select_reorder(br, k, v, kc, vc, parent, frozen, pos)
                 for k, v, kc, vc, _, _ in views]

    def einsum(i: int) -> None:
        k, v, kc, vc, _, _ = sets[i]
        te.reorder_append(k[cut], kc, parent, frozen, pos)
        te.reorder_append(v[cut], vc, parent, frozen, pos)

    def scan(i: int) -> None:
        k, v, kc, vc, _, _ = sets[i]
        te.reorder_append_scan(k[cut], v[cut], kc, vc, parent, frozen, pos)

    row["library_ms"] = queued_ms(lambda i: libraries[i](), copies, iters)[0]
    row["einsum_ms"] = queued_ms(einsum, copies, 3)[0]
    row["scan_ms"] = queued_ms(scan, copies, 3)[0]  # last: it rewrites the caches
    return row


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def time_fused(fe: object, t5: object, b: int, length: int, iters: int, seed: int,
               d_model: int = 1472, d_ff: int = 3584) -> List[Dict[str, object]]:
    """``add_rms_norm`` and ``gated_gelu`` at ``[b, length]`` rows of
    byt5-small's widths beside the plain chains they replace, on operand
    sets cycled past the L2 cache."""
    import torch

    rows, eps = b * length, 1e-6
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape: int) -> "torch.Tensor":
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    out: List[Dict[str, object]] = []
    norm_bytes = rows * d_model * 2 * 4 + d_model * 4  # h, delta in; h_new, normed out
    gelu_bytes = rows * d_ff * 2 * 3  # gate, up in; out
    copies = max(1, -(-3 * L2_BYTES // (rows * d_model * 2 * 2)))
    w = torch.rand(d_model, generator=gen, device="cuda") + 0.5
    hs = [(rand(b, length, d_model), rand(b, length, d_model)) for _ in range(copies)]

    def plain_norm(i: int) -> object:
        h = hs[i][0] + hs[i][1]
        return h, t5.rms_norm(h, w, eps)

    cases = [("add_rms_norm", d_model, norm_bytes, copies,
              lambda i: fe.add_rms_norm(hs[i][0], hs[i][1], w, eps), plain_norm)]
    gelu_copies = max(1, -(-3 * L2_BYTES // (rows * d_ff * 2 * 2)))
    wis = [rand(b, length, 2 * d_ff).chunk(2, dim=-1) for _ in range(gelu_copies)]
    cases.append(("gated_gelu", d_ff, gelu_bytes, gelu_copies,
                  lambda i: fe.gated_gelu(*wis[i]),
                  lambda i: t5.gelu_new(wis[i][0]) * wis[i][1]))
    for name, width, nbytes, n, fused, plain in cases:
        ms = queued_ms(fused, n, iters)[0]
        plain_ms = queued_ms(plain, n, iters)[0]
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        out.append({"kernel": name, "B": b, "L": length, "width": width, "dtype": "bfloat16",
                    "copies": n, "ms": ms, "bound_ms": bound_ms, "bound_by": "bytes",
                    "bound_pct": 100 * bound_ms / ms, "plain_ms": plain_ms,
                    "speedup": plain_ms / ms})
    del hs, wis
    torch.cuda.empty_cache()
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", required=True, help="root of the checkout to time")
    parser.add_argument("--label", required=True)
    parser.add_argument("--shapes", default="8x2048,8x1024,40x1024",
                        help="comma-separated BxL (empty: none)")
    parser.add_argument("--decoder", default="", help="BxTxS of the decoder rows, e.g. 8x512x2304")
    parser.add_argument("--long", default="", help="BxL of the long-route rows, e.g. 4x8192")
    parser.add_argument("--scaled", default="",
                        help="comma-separated BxTxHxD of the scaled causal rows, e.g. 4x2048x32x128")
    parser.add_argument("--quant", default="",
                        help="comma-separated MxKxN of the int8/int4 products, e.g. 32x4096x11008")
    parser.add_argument("--engine", type=int, default=0,
                        help="samples of the LLaMA-7B int4 engine's admission wave and steps")
    parser.add_argument("--reorder", action="append", default=[],
                        help="LxSxKxHxTxd[:T_live] of a kernel 13 row (repeatable), e.g. "
                             "4x2x64x6x512x64:64")
    parser.add_argument("--t5-engine", type=int, default=0,
                        help="samples of the byt5-small streaming engine's admission wave and "
                             "steps")
    parser.add_argument("--fused", nargs="?", const="64x256,64x512,64x1024", default="",
                        help="comma-separated BxL of the fused elementwise rows (alone: the "
                             "re-index cell's 64x256,64x512,64x1024)")
    parser.add_argument("--iters", type=int, default=20)
    return parser


def main(argv: List[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    quant = parse_quant(args.quant)
    reorder = [parse_reorder(spec) for spec in args.reorder]

    checkout = os.path.abspath(args.checkout)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [checkout] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    from reprover_tpu_torch.generation import engine as te
    from reprover_tpu_torch.models import quantize as qz
    from reprover_tpu_torch.ops import beam_reorder as br
    from reprover_tpu_torch.ops import flash_attention as tfa
    from reprover_tpu_torch.ops import quant_matmul as qm

    for mod in (tfa, qm, qz, br, te):
        if not os.path.abspath(mod.__file__).startswith(checkout + os.sep):
            raise RuntimeError(f"imported {mod.__file__}, not the checkout {checkout}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    shapes: List[Tuple[int, int]] = [
        (int(s.split("x")[0]), int(s.split("x")[1])) for s in filter(None, args.shapes.split(","))]
    for i, (b, length) in enumerate(shapes):
        row = {"label": args.label, "card": card, "B": b, "L": length, "dtype": "bfloat16"}
        row.update(time_shape(tfa, b, length, args.iters, seed=i))
        print(json.dumps(row), flush=True)
    if args.decoder:
        b, t, s = (int(x) for x in args.decoder.split("x"))
        row = {"label": args.label, "card": card, "B": b, "T": t, "S": s, "dtype": "bfloat16"}
        row.update(time_decoder(tfa, b, t, s, args.iters, seed=len(shapes)))
        print(json.dumps(row), flush=True)
    for spec in filter(None, args.scaled.split(",")):
        b, t, heads, d = (int(x) for x in spec.split("x"))
        row = {"label": args.label, "card": card, "B": b, "T": t, "H": heads, "d": d,
               "dtype": "bfloat16"}
        row.update(time_scaled(tfa, b, t, heads, d, args.iters, seed=len(shapes)))
        print(json.dumps(row), flush=True)
    if args.long:
        b, length = (int(x) for x in args.long.split("x"))
        for row in time_long(tfa, b, length, 512, args.iters, seed=len(shapes)):
            print(json.dumps({"label": args.label, "card": card, "route": "long",
                              "dtype": "bfloat16", **row}), flush=True)
    for i, (m, k, n) in enumerate(quant):
        for bits in (8, 4):
            row = time_quant(qm, qz, m, k, n, bits, args.iters, seed=i)
            print(json.dumps({"label": args.label, "card": card, "kernel": "quant_matmul"
                              if bits == 8 else "quant4_matmul", **row}), flush=True)
    for i, (shape, t_live) in enumerate(reorder):
        row = time_reorder(br, te, shape, t_live, args.iters, seed=i)
        print(json.dumps({"label": args.label, "card": card, "kernel": "beam_reorder", **row}),
              flush=True)
        sys.modules["torch"].cuda.empty_cache()
    if args.engine:
        print(json.dumps({"label": args.label, "card": card,
                          **time_engine(args.engine, seed=0)}), flush=True)
    if args.t5_engine:
        print(json.dumps({"label": args.label, "card": card,
                          **time_t5_engine(args.t5_engine, seed=0)}), flush=True)
    if args.fused:
        from reprover_tpu_torch.models import t5
        from reprover_tpu_torch.ops import fused_elementwise as fe

        for i, spec in enumerate(filter(None, args.fused.split(","))):
            b, length = (int(x) for x in spec.split("x"))
            for row in time_fused(fe, t5, b, length, args.iters, seed=i):
                print(json.dumps({"label": args.label, "card": card, **row}), flush=True)


if __name__ == "__main__":
    main()
