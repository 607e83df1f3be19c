"""HF T5 checkpoint import (local directories; no network): the counterpart
of :mod:`reprover_tpu.models.hf_import` (import only).

HF stores dense weights as ``[out, in]`` (``nn.Linear``); the port's layout
is the JAX package's ``[in, out]`` with per-layer weights stacked, so every
dense weight is transposed on the way in. Both full seq2seq checkpoints and
``T5EncoderModel`` exports load (``encoder_only=True`` reads only the
encoder).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import torch

from reprover_tpu_torch.models.t5 import Params, T5Config

def config_from_hf(hf_cfg: Mapping[str, Any], **overrides: Any) -> T5Config:
    d = dict(
        vocab_size=hf_cfg["vocab_size"],
        d_model=hf_cfg["d_model"],
        d_kv=hf_cfg["d_kv"],
        d_ff=hf_cfg["d_ff"],
        num_heads=hf_cfg["num_heads"],
        num_encoder_layers=hf_cfg["num_layers"],
        num_decoder_layers=hf_cfg.get("num_decoder_layers", hf_cfg["num_layers"]),
        relative_attention_num_buckets=hf_cfg.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=hf_cfg.get("relative_attention_max_distance", 128),
        layer_norm_epsilon=hf_cfg.get("layer_norm_epsilon", 1e-6),
        tie_word_embeddings=hf_cfg.get("tie_word_embeddings", True),
        pad_token_id=hf_cfg.get("pad_token_id", 0),
        eos_token_id=hf_cfg.get("eos_token_id", 1),
        decoder_start_token_id=hf_cfg.get("decoder_start_token_id", 0),
    )
    d.update(overrides)
    return T5Config(**d)


def _load_state_dict(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    st_path = os.path.join(ckpt_dir, "model.safetensors")
    bin_path = os.path.join(ckpt_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        try:
            from safetensors.torch import load_file
        except ImportError:
            if not os.path.exists(bin_path):
                raise ImportError(
                    f"{st_path} needs the 'safetensors' package, which is not installed; "
                    "install it or save the checkpoint as pytorch_model.bin"
                ) from None
        else:
            return load_file(st_path)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {ckpt_dir}")


def params_from_torch_state_dict(
    sd: Mapping[str, Any], cfg: T5Config, encoder_only: bool = False
) -> Params:
    """Map an HF T5 state dict to the port's stacked-layer tree (fp32, CPU)."""

    def g(name: str) -> torch.Tensor:
        return torch.as_tensor(sd[name]).detach().to("cpu", torch.float32)

    def dense(name: str) -> torch.Tensor:
        return g(name).t().contiguous()  # [out, in] -> [in, out]

    def attn(prefix: str) -> Params:
        return {x: dense(f"{prefix}.{x}.weight") for x in ("q", "k", "v", "o")}

    def mlp(prefix: str) -> Params:
        return {x: dense(f"{prefix}.{x}.weight") for x in ("wi_0", "wi_1", "wo")}

    def stack(dicts: list) -> Params:
        if isinstance(dicts[0], dict):
            return {key: stack([d[key] for d in dicts]) for key in dicts[0]}
        return torch.stack(dicts)

    enc_layers = []
    for i in range(cfg.num_encoder_layers):
        b = f"encoder.block.{i}"
        enc_layers.append(
            {
                "attn": attn(f"{b}.layer.0.SelfAttention"),
                "attn_norm": g(f"{b}.layer.0.layer_norm.weight"),
                "mlp": mlp(f"{b}.layer.1.DenseReluDense"),
                "mlp_norm": g(f"{b}.layer.1.layer_norm.weight"),
            }
        )
    params: Params = {
        "shared_embedding": g("shared.weight"),
        "encoder": {
            "rel_bias": g("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
            "layers": stack(enc_layers),
            "final_norm": g("encoder.final_layer_norm.weight"),
        },
    }
    if encoder_only:
        return params

    dec_layers = []
    for i in range(cfg.num_decoder_layers):
        b = f"decoder.block.{i}"
        dec_layers.append(
            {
                "self_attn": attn(f"{b}.layer.0.SelfAttention"),
                "self_norm": g(f"{b}.layer.0.layer_norm.weight"),
                "cross_attn": attn(f"{b}.layer.1.EncDecAttention"),
                "cross_norm": g(f"{b}.layer.1.layer_norm.weight"),
                "mlp": mlp(f"{b}.layer.2.DenseReluDense"),
                "mlp_norm": g(f"{b}.layer.2.layer_norm.weight"),
            }
        )
    params["decoder"] = {
        "rel_bias": g("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "layers": stack(dec_layers),
        "final_norm": g("decoder.final_layer_norm.weight"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense("lm_head.weight")
    return params


def load_hf_t5(
    ckpt_dir: str, encoder_only: bool = False, **config_overrides: Any
) -> Tuple[Params, T5Config]:
    """Load a local HF T5/ByT5 checkpoint directory -> (fp32 CPU params, config)."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = config_from_hf(hf_cfg, **config_overrides)
    sd = _load_state_dict(ckpt_dir)
    return params_from_torch_state_dict(sd, cfg, encoder_only=encoder_only), cfg
