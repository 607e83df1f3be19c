"""Time the encoder-attention kernels (forward, dQ, dK/dV) of one checkout of
this repository on the card, for comparing two versions in one call.

    python reprover_tpu_torch/ops/kernel_timing.py --checkout DIR --label NAME

imports ``reprover_tpu_torch`` from ``DIR`` (which builds its own kernels into
``DIR/build/kernels``) and prints one JSON line per shape: bf16 q/k/v of
byt5-small attention (6 heads x 64) with ragged key masks, made from a seed.
It uses only functions that every version of the port has
(``encoder_flash_attention``, ``encoder_attention_backward`` and
``encoder_attention_lse_reference``); each kernel's time is its device time
from ``torch.profiler`` over ``--iters`` launches, beside the forward's time
from CUDA events. Run the checkouts in turns (parent, change, change,
parent), each in its own process, on one card: times from two cards do not
compare.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List, Tuple


def _kernel_kind(name: str) -> str:
    """'dq', 'dkv' or 'fwd' for an attention kernel's profiled name, else ''."""
    if "attn" not in name or "kernel" not in name:
        return ""
    if "bwd_dq" in name:
        return "dq"
    if "bwd_dkv" in name:
        return "dkv"
    return "fwd"


def time_shape(tfa: object, b: int, length: int, iters: int, seed: int) -> Dict[str, float]:
    """Per-launch ms of the three encoder kernels at ``[b, length]`` bf16."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            forward()
            backward()
        torch.cuda.synchronize()
    sums: Dict[str, float] = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for e in prof.events():
        kind = _kernel_kind(e.name)
        if e.device_type == DeviceType.CUDA and kind:
            sums[kind] += e.time_range.elapsed_us()
    row.update({f"{kind}_ms": us / 1e3 / iters for kind, us in sums.items()})
    return row


def main(argv: List[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", required=True, help="root of the checkout to time")
    parser.add_argument("--label", required=True)
    parser.add_argument("--shapes", default="8x2048,8x1024,40x1024",
                        help="comma-separated BxL")
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


if __name__ == "__main__":
    main()
