"""Encoder attention's share of its roofline in the traced shard: the least
time its shapes need on the card (per batch and layer, the larger of
operations at the bf16 peak and bytes at the HBM peak) over the device time
of the attention kernels, found by name."""

import re

# The port's attention forward kernel (``csrc/encoder_attn.cu``) and the
# plain fallbacks a library would launch for the same work.
PATTERN = re.compile(r"attn_fwd_kernel|flash_fwd|fmha|efficient_attention")


def read(w):
    ops = w.trace.get("op_seconds", {})
    spent = sum(s for name, s in ops.items() if PATTERN.search(name))
    bound = w.values.get("attention_bound_s")
    return 100.0 * bound / spent if spent and bound else None
