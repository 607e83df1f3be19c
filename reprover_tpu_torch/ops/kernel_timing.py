"""Time the attention kernels (forward, dQ, dK/dV) of one checkout of this
repository on the card, for comparing two versions in one call.

    python reprover_tpu_torch/ops/kernel_timing.py --checkout DIR --label NAME \
        [--shapes 8x2304] [--decoder 8x512x2304] [--long 4x8192]

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
right-padded key masks, the fine-tuning data module's layout. Run the checkouts in turns (parent, change, change, parent), each
in its own process, on one card: times from two cards do not compare.
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


def main(argv: List[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", required=True, help="root of the checkout to time")
    parser.add_argument("--label", required=True)
    parser.add_argument("--shapes", default="8x2048,8x1024,40x1024",
                        help="comma-separated BxL")
    parser.add_argument("--decoder", default="", help="BxTxS of the decoder rows, e.g. 8x512x2304")
    parser.add_argument("--long", default="", help="BxL of the long-route rows, e.g. 4x8192")
    parser.add_argument("--scaled", default="",
                        help="comma-separated BxTxHxD of the scaled causal rows, e.g. 4x2048x32x128")
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)

    checkout = os.path.abspath(args.checkout)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [checkout] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    from reprover_tpu_torch.ops import flash_attention as tfa

    if not os.path.abspath(tfa.__file__).startswith(checkout + os.sep):
        raise RuntimeError(f"imported {tfa.__file__}, not the checkout {checkout}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    shapes: List[Tuple[int, int]] = [
        (int(s.split("x")[0]), int(s.split("x")[1])) for s in args.shapes.split(",")]
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


if __name__ == "__main__":
    main()
