"""A served request's beam search on one checkout of this repository: ms a
decode step, to compare two checkouts on one card.

    python reprover_tpu_torch/benchmarks/beam_decode_step.py --checkout DIR --label NAME \
        [--beams 64] [--max-len 512] [--source-len 1833] [--repeats 3] [--groups 4] \
        [--device cuda|cpu] [--tiny]

A seeded random byt5-small generator (bf16 on the card; ``--tiny``: 2 layers
of width 32, fp32, for a seconds-long CPU run) encodes one seeded source of
``--source-len`` printable bytes once, then runs ``init_decode_state`` and
``generation/beam_search.py::beam_search`` over it at ``--beams`` x
``--max-len`` as a served request does: the classic call, with no group arguments. After one warm-up search,
each of ``--repeats`` searches prints its ms a decode step on the host
clock (a synchronize on either side of the search, over its steps); one more,
profiled (device events only), gives the device's ms and operations a step
and its busy share (device time of the profiled search over the wall time of
the last unprofiled one), and one more under a ``TorchFunctionMode`` counts
the calls into ``torch`` a step (the host's work: the model's step and the
search's selection). ``--groups G`` adds a search of ``G`` groups at
diversity penalty 1.0 where the checkout's ``beam_search`` takes groups.

The script imports the package of ``--checkout``, which builds its kernels
under ``<checkout>/build/kernels/``. To compare a change with its parent, run
both in one call to the card, in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

SEED = 0


def _search_row(device: Any, run: Any, steps: List[int]) -> Dict[str, float]:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()
    steps[0] = 0
    t0 = time.perf_counter()
    run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return dict(steps=steps[0], ms=ms, ms_per_step=ms / max(steps[0], 1))


def _profiled(device: Any, run: Any, steps: List[int], wall_ms: float) -> Dict[str, Any]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return {}
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _search_row(device, run, steps)
    except Exception as ex:  # a report, not a check
        return dict(profiler=f"not measured: {ex!r}")
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return dict(device_ms_per_step=device_ms / max(steps[0], 1),
                device_ops_per_step=len(events) / max(steps[0], 1),
                device_busy_share=device_ms / wall_ms if device_ms else None)


def _torch_calls(run: Any, steps: List[int]) -> float:
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        calls = 0

        def __torch_function__(self, func: Any, types: Any, args: Any = (),
                               kwargs: Any = None) -> Any:
            self.calls += 1
            return func(*args, **(kwargs or {}))

    steps[0] = 0
    with Count() as count:
        run()
    return count.calls / max(steps[0], 1)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkout", required=True, help="root of the checkout to time")
    parser.add_argument("--label", required=True)
    parser.add_argument("--beams", type=int, default=64)
    parser.add_argument("--max-len", type=int, default=512)
    parser.add_argument("--source-len", type=int, default=1833)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--groups", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true")
    args = parser.parse_args(argv)

    checkout = os.path.abspath(args.checkout)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [checkout] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    import numpy as np
    import torch

    from reprover_tpu_torch.models.t5 import (
        T5Config, byt5_small, decode_step, encode, fuse_mlp_params, init_decode_state,
        init_params, place_params, reorder_decode_state, resolve_device,
    )

    bs = importlib.import_module("reprover_tpu_torch.generation.beam_search")
    if not os.path.abspath(bs.__file__).startswith(checkout + os.sep):
        raise RuntimeError(f"imported {bs.__file__}, not the checkout {checkout}")
    device = resolve_device(args.device)
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    cfg = (T5Config(d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
                    num_decoder_layers=1) if args.tiny
           else byt5_small(compute_dtype=torch.bfloat16 if device.type == "cuda"
                           else torch.float32))
    params = place_params(fuse_mlp_params(init_params(cfg, torch.Generator().manual_seed(SEED))),
                          cfg, device)
    rng = np.random.default_rng(SEED)
    # Printable bytes, shifted past ByT5's 3 special ids, with the EOS closing.
    src = rng.integers(32, 127, size=args.source_len) + 3
    ids = torch.from_numpy(np.append(src, cfg.eos_token_id)[None]).to(device, torch.long)
    mask = torch.ones_like(ids, dtype=torch.bool)
    steps = [0]

    def step(cache: Any, tokens: torch.Tensor) -> Any:
        steps[0] += 1
        return decode_step(params, cfg, cache, tokens)

    with torch.inference_mode():
        enc = encode(params, cfg, ids, mask)  # builds the kernels; the searches share it

    def search(**kw: Any) -> Any:
        def run() -> None:
            with torch.inference_mode():
                cache = init_decode_state(params, cfg, enc, mask, args.max_len,
                                          num_beams=args.beams)
                res = bs.beam_search(step, reorder_decode_state, cache, 1, args.beams,
                                     args.max_len, cfg.eos_token_id, cfg.pad_token_id,
                                     cfg.decoder_start_token_id, 0.0, device, **kw)
                res.scores.cpu()
        return run

    cells = [("classic", {})]
    if args.groups > 1:
        if "num_beam_groups" not in inspect.signature(bs.beam_search).parameters:
            print(json.dumps(dict(label=args.label, groups="not in this checkout")), flush=True)
        else:
            cells.append((f"groups{args.groups}",
                          dict(num_beam_groups=args.groups, diversity_penalty=1.0)))
    for name, kw in cells:
        run = search(**kw)
        _search_row(device, run, steps)  # warm-up
        rows = [_search_row(device, run, steps) for _ in range(args.repeats)]
        row = dict(label=args.label, card=card, search=name, beams=args.beams,
                   max_len=args.max_len, source_len=int(ids.shape[1]), steps=rows[-1]["steps"],
                   ms_per_step=[r["ms_per_step"] for r in rows])
        row.update(_profiled(device, run, steps, rows[-1]["ms"]))
        row["torch_calls_per_step"] = _torch_calls(run, steps)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
