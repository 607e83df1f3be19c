"""Time the encoder-attention kernels (forward, dQ, dK/dV) of one checkout of
this repository on the card, for comparing two versions in one call.

    python reprover_tpu_torch/ops/kernel_timing.py --checkout DIR --label NAME \
        [--shapes 8x2304] [--long 4x8192]

imports ``reprover_tpu_torch`` from ``DIR`` (which builds its own kernels into
``DIR/build/kernels``) and prints one JSON line per shape: bf16 q/k/v of
byt5-small attention (6 heads x 64) with ragged key masks, made from a seed.
The ``--shapes`` rows use only functions that every version of the port has
(``encoder_flash_attention``, ``encoder_attention_backward`` and
``encoder_attention_lse_reference``; keep their lengths within 4096, the
full-row route); each kernel's time is its device time from
``torch.profiler`` over ``--iters`` launches, beside the forward's time
from CUDA events. ``--long BxL`` adds the long route's kernels 2, 5, 6 and 7
(a checkout that has ``long_attention_backward``): the encoder at
``[B, L]`` and the cross-attention of ``[B, 512]`` queries (the
generator's target cap) over it. Run the checkouts in turns (parent, change, change, parent), each
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


# attn_<part>_kernel<T, mode> (versions before the long route) or
# attn_<part>_kernel<T, mode, route>.
_KERNEL = re.compile(r"attn_(fwd|bwd_dq|bwd_dkv)_kernel<[^,>]+,\s*\d(?:,\s*(\d))?>")


def _kernel_kind(name: str) -> str:
    """'fwd', 'dq' or 'dkv' for a full-row attention kernel's profiled name,
    'long', 'long_lse', 'long_dq' or 'long_dkv' for the long route's, else
    ''."""
    m = _KERNEL.search(name)
    if m is None:
        return ""
    part = {"fwd": "fwd", "bwd_dq": "dq", "bwd_dkv": "dkv"}[m.group(1)]
    route = int(m.group(2) or 0)
    if route == 0:
        return part
    if part == "fwd":
        return "long" if route == 1 else "long_lse"
    return f"long_{part}"


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


def time_long(tfa: object, b: int, length: int, queries: int, iters: int,
              seed: int) -> List[Dict[str, float]]:
    """Per-launch ms of the long route's kernels at ``[b, length]`` bf16:
    the encoder's (kernels 2, 5, 6, 7 with the relative-position bias), and
    the cross-attention's of ``[b, queries]`` over ``[b, length]``."""
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
        row = {"mode": tfa.KERNEL_NAMES[mode], "B": b, "Lq": lq, "Lk": length}
        row.update(_device_ms(step, iters))
        rows.append(row)
    return rows


def main(argv: List[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", required=True, help="root of the checkout to time")
    parser.add_argument("--label", required=True)
    parser.add_argument("--shapes", default="8x2048,8x1024,40x1024",
                        help="comma-separated BxL")
    parser.add_argument("--long", default="", help="BxL of the long-route rows, e.g. 4x8192")
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
    if args.long:
        b, length = (int(x) for x in args.long.split("x"))
        for row in time_long(tfa, b, length, 512, args.iters, seed=len(shapes)):
            print(json.dumps({"label": args.label, "card": card, "route": "long",
                              "dtype": "bfloat16", **row}), flush=True)


if __name__ == "__main__":
    main()
