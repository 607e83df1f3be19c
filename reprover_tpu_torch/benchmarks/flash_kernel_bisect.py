"""Ablation harness of the encoder flash-attention kernel (kernel 1): times
variants of it with pieces of its work removed, to show what each piece
costs. The counterpart of the JAX package's
``benchmarks/flash_kernel_bisect.py`` (its ``_kernel``, kernel 14), with the
variants compiled from the port's own forward source
(``csrc/encoder_attn.cu``, mode ``ENCODER``, route ``FULL_ROW``, a fifth
template parameter):

- ``production``: ``encoder_flash_attention`` as it ships (kernel 1, with its
  wrapper's checks and operand conversions);
- ``production_bk<N>`` (``--block-kv N``): the long route, kernel 2, at the
  same shape (its tiles are 64 keys whatever ``N`` is);
- ``full``: kernel 1's arithmetic (scores + bias + mask + softmax + PV)
  through the harness's entry point: the production instantiation itself;
- ``sharedcmp``: the same with the per-element bias-table gather dropped and
  the bias add kept (each (64-query, 64-key) tile pair adds one table entry,
  that of its first positions). The TPU harness's ``sharedcmp`` hoists the
  per-head bucket-compare chain, which the CUDA kernel does not have: it
  reads a bias table, and the gather is the piece of work that corresponds;
- ``nobias``: scores + mask + softmax + PV;
- ``nosoftmax``: ``(scores + bias + mask) * 1e-4``, then PV, a masked key
  adding ``-1e10`` as in the TPU harness;
- ``matmulonly``: ``(q k^T) * 1e-4``, then PV, no bias, no mask.

The variants are not the attention: this is a cost-attribution tool, not a
correctness check. Each variant still has a plain PyTorch version
(:func:`bisect_attention_reference`), and the card checks hold each kernel
to it (:func:`variant_error`), so that the harness is known to time what it
claims.

    python -m reprover_tpu_torch.benchmarks.flash_kernel_bisect [--batch 64] [--seq 1024]

prints one JSON line per variant: the best of ``--reps`` runs of
``--layers`` chained calls (each layer's output is the next layer's q), as
``ms_12layers`` (the chain, whatever ``--layers`` is) and ``ms_per_layer``,
timed with CUDA events, in bf16 with an all-ones mask and random bias
(:func:`make_inputs`), head width 64, as the TPU harness times them. Unlike the TPU harness, the runs go in rounds
(every variant once per round, after one warm-up round), so a drift of the
card's clock over the sweep reaches every variant alike. ``--device cpu``
runs the plain versions instead, timed by the host clock.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from reprover_tpu_torch.ops import flash_attention as tfa

# In the order of csrc/encoder_attn.cu's ``Variant`` (the kernel's index).
VARIANTS = ("full", "nobias", "sharedcmp", "nosoftmax", "matmulonly")
D = 64  # the encoder kernel's head width
NEG_INF = -1e10  # the TPU harness's additive mask
NO_SOFTMAX_SCALE = 1e-4
NB, MAXD = 32, 128  # byt5's relative-attention geometry

# Launches of each variant's kernel in this process (the wrapper adds one
# where it launches, and nowhere else).
KERNEL_LAUNCHES: Dict[str, int] = {f"bisect_{v}": 0 for v in VARIANTS}


def reset_launch_counts() -> None:
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0


def make_inputs(batch: int, seq: int, heads: int, device: torch.device,
                dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
    """The sweep's operands from seed 0: q, k, v ``[batch, seq, heads*64]``
    standard normal (drawn in float32, then cast to ``dtype``), an all-ones
    int32 mask and a standard-normal float32 ``[32, heads]`` bias table."""
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((batch, seq, heads * D), generator=gen, device=device).to(dtype)
               for _ in range(3))
    mask = torch.ones((batch, seq), dtype=torch.int32, device=device)
    rel = torch.randn((NB, heads), generator=gen, device=device)
    return [q, k, v, mask, rel]


def variant_error(got: torch.Tensor, want: torch.Tensor) -> Dict[str, Any]:
    """A variant's output against its plain version: the largest absolute
    error and the error's norm relative to the output's, each held to 1e-4
    (float32) or 2e-2 (bf16), the first times ``max|want|``. The limits
    scale with the output itself, never with a floor of 1: the ``nosoftmax``
    and ``matmulonly`` outputs are ~1e-2. An all-zero ``want`` proves
    nothing and fails."""
    tol = 1e-4 if want.dtype == torch.float32 else 2e-2
    diff, ref = (got.float() - want.float()), want.float()
    max_abs, scale = diff.abs().max().item(), ref.abs().max().item()
    rel = (diff.norm() / ref.norm().clamp_min(1e-30)).item()
    ok = (bool(torch.isfinite(got).all()) and scale > 0 and max_abs <= tol * scale
          and rel <= tol)
    return dict(max_abs_err=max_abs, rel_err=rel, ref_max_abs=scale, tol=tol, ok=ok)


def _tile_bias(rel_bias: torch.Tensor, length: int, num_buckets: int,
               max_distance: int) -> torch.Tensor:
    """fp32 ``[1, H, L, L]``: the ``sharedcmp`` bias, one table entry per
    (64-query, 64-key) tile pair, at ``clamp(k0 - q0)`` of its first
    positions."""
    start = torch.arange(length, device=rel_bias.device) // tfa.TILE * tfa.TILE
    rel = (start[None, :] - start[:, None]).clamp(-max_distance, max_distance) + max_distance
    table = tfa.bucket_table(num_buckets, max_distance, rel_bias.device).long()
    return rel_bias.float()[table[rel]].permute(2, 0, 1)[None]


def bisect_attention_reference(
    variant: str,
    q: torch.Tensor,  # [B, L, H*D]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, L] {0,1}
    rel_bias: torch.Tensor,  # [num_buckets, H] fp32
    num_heads: int,
    num_buckets: int = NB,
    max_distance: int = MAXD,
) -> torch.Tensor:
    """Plain PyTorch version of one ablation variant: fp32 over the full
    ``[B, H, L, L]`` score tensor, output in q's dtype. ``full`` is
    :func:`~reprover_tpu_torch.ops.flash_attention.encoder_attention_reference`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    length = q.shape[1]
    valid = mask.bool()[:, None, None, :]
    bias: Optional[torch.Tensor] = None
    if variant in ("full", "nosoftmax"):
        bias = tfa._bucket_bias(rel_bias, length, True, num_buckets, max_distance)
    elif variant == "sharedcmp":
        bias = _tile_bias(rel_bias, length, num_buckets, max_distance)
    if variant in ("full", "nobias", "sharedcmp"):
        return tfa._plain_attention(q, k, v, valid, bias, num_heads)
    scores = torch.matmul(tfa._heads(q, num_heads), tfa._heads(k, num_heads).transpose(-1, -2))
    if variant == "nosoftmax":
        scores = scores + bias
        scores = scores + torch.where(valid, 0.0, NEG_INF)
    p = scores * NO_SOFTMAX_SCALE
    return tfa._flat(torch.matmul(p, tfa._heads(v, num_heads)), q.dtype)


def bisect_attention(
    variant: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    rel_bias: torch.Tensor,
    num_heads: int,
    num_buckets: int = NB,
    max_distance: int = MAXD,
) -> torch.Tensor:
    """One ablation variant -> ``[B, L, H*D]``: on CPU tensors
    :func:`bisect_attention_reference`; on CUDA tensors the variant's kernel
    (``attn_bisect_forward``: fp32 or bf16, head width 64, contiguous q/k/v),
    or an error. Not differentiable."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if all(t.device.type == "cpu" for t in (q, k, v, mask, rel_bias)):
        return bisect_attention_reference(variant, q, k, v, mask, rel_bias, num_heads,
                                          num_buckets, max_distance)
    from reprover_tpu_torch.ops.native import load_library

    tfa._check_card(tfa.ENCODER, q, k, v, mask, rel_bias, num_heads, num_buckets)
    mask32, rel32, table = tfa._kernel_operands(tfa.ENCODER, mask, rel_bias, num_buckets,
                                                max_distance)
    out = torch.empty_like(q)
    b, length, _ = q.shape
    if b == 0 or length == 0:
        return out
    lib = load_library()
    name = f"bisect_{variant}"
    err = lib.attn_bisect_forward(
        tfa._ptr(q), tfa._ptr(k), tfa._ptr(v), tfa._ptr(mask32), tfa._ptr(rel32),
        tfa._ptr(table), tfa._ptr(out), b, length, num_heads, max_distance,
        VARIANTS.index(variant), int(q.dtype == torch.bfloat16),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    tfa._raise_on_error(lib, err, name)
    KERNEL_LAUNCHES[name] += 1
    return out


def variant_fn(name: str, num_heads: int) -> Callable[..., torch.Tensor]:
    """``fn(q, k, v, mask, rel_bias)`` of one harness variant: ``production``,
    ``production_bk<N>`` or one of :data:`VARIANTS`."""
    if name == "production":
        return lambda q, k, v, m, r: tfa.encoder_flash_attention(q, k, v, m, r, num_heads)
    if name.startswith("production_bk"):
        block_kv = int(name[len("production_bk"):])
        return lambda q, k, v, m, r: tfa.encoder_flash_attention(q, k, v, m, r, num_heads,
                                                                 block_kv=block_kv)
    return lambda q, k, v, m, r: bisect_attention(name, q, k, v, m, r, num_heads)


def run_layers(fn: Callable[..., torch.Tensor], layers: int, q: torch.Tensor,
               *operands: torch.Tensor) -> torch.Tensor:
    """``layers`` chained calls: each output is the next call's q (the TPU
    harness's scan over layers)."""
    x = q
    for _ in range(layers):
        x = fn(x, *operands)
    return x


def _run_ms(run: Callable[[], Any], cuda: bool) -> float:
    """One run's ms: CUDA events on the card, the host clock on the CPU."""
    if not cuda:
        t0 = time.perf_counter()
        run()
        return 1e3 * (time.perf_counter() - t0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--block-kv", type=int, default=0,
                    help="also time the long route (kernel 2) as production_bk<N>")
    ap.add_argument("--sweep-block-q", default="",
                    help="no counterpart here: the CUDA kernels' query tile is fixed at 64 "
                    "rows, so there is no block size to sweep; a value is refused")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Time every variant; prints and returns one row per variant."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.sweep_block_q:
        ap.error("--sweep-block-q has no counterpart: the query tile is fixed at 64 rows")
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to run the plain versions")
    q, k, v, mask, rel = make_inputs(args.batch, args.seq, args.heads, device)
    names = ["production"] + ([f"production_bk{args.block_kv}"] if args.block_kv else [])
    names += list(VARIANTS)
    runs = {name: (lambda fn=variant_fn(name, args.heads): run_layers(fn, args.layers, q, k, v,
                                                                      mask, rel))
            for name in names}
    best = {name: float("inf") for name in names}
    for round_ in range(args.reps + 1):  # round 0 warms up
        for name in names:
            ms = _run_ms(runs[name], cuda)
            if round_:
                best[name] = min(best[name], ms)
    rows = []
    for name in names:
        row = {"variant": name, "ms_12layers": best[name], "ms_per_layer": best[name] / args.layers,
               "device": torch.cuda.get_device_name(device) if cuda else "cpu"}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
