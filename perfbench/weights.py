"""Seeded random T5 weights, made on the device in a few large calls.

One ``torch.randn`` on the device fills a float32 buffer as large as every
matrix and bias table together; each leaf is a view of it, scaled by T5's
initialisation (q by ``(d_model * d_kv)^-1/2``, k, v and the MLP input by
``d_model^-1/2``, o by ``inner^-1/2``, the MLP output by ``d_ff^-1/2``,
the embedding by 1, the output projection and bias tables by
``d_model^-1/2``) and cast to the type it is served in: matrices in
``matmul_dtype``, norms (ones) and bias tables in float32. The layout is
the one both the port and the reference read: per-layer leaves stacked on a
leading axis, dense weights ``[in, out]``, the MLP input fused as gate | up.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

Params = Dict[str, Any]


def _plan(s: Dict[str, Any], encoder_only: bool) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, std) of every random leaf."""
    d, dk, h, f, v = s["d_model"], s["d_kv"], s["num_heads"], s["d_ff"], s["vocab_size"]
    inner, nb = h * dk, s["relative_attention_num_buckets"]

    def attn(prefix: Tuple[str, ...], n: int) -> list:
        return [(prefix + ("q",), (n, d, inner), (d * dk) ** -0.5),
                (prefix + ("k",), (n, d, inner), d ** -0.5),
                (prefix + ("v",), (n, d, inner), d ** -0.5),
                (prefix + ("o",), (n, inner, d), inner ** -0.5)]

    def mlp(prefix: Tuple[str, ...], n: int) -> list:
        return [(prefix + ("wi",), (n, d, 2 * f), d ** -0.5),
                (prefix + ("wo",), (n, f, d), f ** -0.5)]

    le = s["num_layers"]
    plan = [(("shared_embedding",), (v, d), 1.0),
            (("encoder", "rel_bias"), (nb, h), d ** -0.5)]
    plan += attn(("encoder", "layers", "attn"), le) + mlp(("encoder", "layers", "mlp"), le)
    if not encoder_only:
        ld = s["num_decoder_layers"]
        plan += [(("decoder", "rel_bias"), (nb, h), d ** -0.5)]
        plan += attn(("decoder", "layers", "self_attn"), ld)
        plan += attn(("decoder", "layers", "cross_attn"), ld)
        plan += mlp(("decoder", "layers", "mlp"), ld)
        plan += [(("lm_head",), (d, v), d ** -0.5)]
    return plan


def _norms(s: Dict[str, Any], encoder_only: bool) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    d, le = s["d_model"], s["num_layers"]
    out = [(("encoder", "layers", "attn_norm"), (le, d)), (("encoder", "layers", "mlp_norm"), (le, d)),
           (("encoder", "final_norm"), (d,))]
    if not encoder_only:
        ld = s["num_decoder_layers"]
        out += [(("decoder", "layers", n), (ld, d)) for n in ("self_norm", "cross_norm", "mlp_norm")]
        out += [(("decoder", "final_norm"), (d,))]
    return out


def _put(tree: Params, path: Tuple[str, ...], value: torch.Tensor) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make_t5(sizes: Dict[str, Any], seed: int, device: Any, matmul_dtype: torch.dtype,
            encoder_only: bool = False) -> Params:
    """The weight tree of ``sizes`` (a configuration file's keys), drawn
    from ``seed`` on ``device``; ``encoder_only`` leaves out the decoder and
    the output projection (the retriever)."""
    plan = _plan(sizes, encoder_only)
    total = sum(torch.Size(shape).numel() for _, shape, _ in plan)
    g = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    tree: Params = {}
    at = 0
    for path, shape, std in plan:
        n = torch.Size(shape).numel()
        leaf = buf[at: at + n].view(shape).mul_(std)
        at += n
        dtype = torch.float32 if path[-1] == "rel_bias" else matmul_dtype
        _put(tree, path, leaf.to(dtype).contiguous() if dtype != torch.float32 else leaf.clone())
    del buf
    for path, shape in _norms(sizes, encoder_only):
        _put(tree, path, torch.ones(shape, device=device, dtype=torch.float32))
    return tree


def parameter_count(sizes: Dict[str, Any], encoder_only: bool = False) -> int:
    """Parameters of the tree :func:`make_t5` makes."""
    n = sum(torch.Size(shape).numel() for _, shape, _ in _plan(sizes, encoder_only))
    return n + sum(torch.Size(shape).numel() for _, shape in _norms(sizes, encoder_only))


def to_float32(tree: Params) -> Params:
    """A float32 copy of a weight tree (the reference's operands)."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    return tree.float() if tree.dtype != torch.float32 else tree
