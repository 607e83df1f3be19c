"""HF LLaMA-family checkpoint import for the causal LM: the counterpart of
:mod:`reprover_tpu.models.hf_import_causal`.

Loads a local HF directory (``LlamaForCausalLM`` / ``MistralForCausalLM``
layout) into :mod:`reprover_tpu_torch.models.causal_lm` params: dense
weights transposed from ``[out, in]`` to ``[in, out]``, per-layer weights
stacked. The state dict is read as the T5 import reads it (safetensors or
``pytorch_model.bin``), without ``transformers``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Tuple

import torch

from reprover_tpu_torch.models.causal_lm import CausalLMConfig, Params
from reprover_tpu_torch.models.hf_import import _load_state_dict


def causal_config_from_hf(hf_cfg: Mapping[str, Any], **overrides: Any) -> CausalLMConfig:
    fields = dict(
        vocab_size=hf_cfg["vocab_size"],
        d_model=hf_cfg["hidden_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"],
        num_kv_heads=hf_cfg.get("num_key_value_heads", hf_cfg["num_attention_heads"]),
        d_ff=hf_cfg["intermediate_size"],
        rope_theta=hf_cfg.get("rope_theta", 10000.0),
        rms_norm_eps=hf_cfg.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=hf_cfg.get("tie_word_embeddings", False),
        bos_token_id=hf_cfg.get("bos_token_id", 1) or 1,
        eos_token_id=hf_cfg.get("eos_token_id", 2) or 2,
        pad_token_id=hf_cfg.get("pad_token_id") or 0,
    )
    fields.update(overrides)
    return CausalLMConfig(**fields)


def causal_params_from_state_dict(sd: Mapping[str, Any], cfg: CausalLMConfig) -> Params:
    """An HF LLaMA-family state dict -> the port's stacked tree (fp32, CPU)."""

    def g(name: str) -> torch.Tensor:
        return torch.as_tensor(sd[name]).detach().to("cpu", torch.float32)

    def dense(name: str) -> torch.Tensor:
        return g(name).t().contiguous()  # [out, in] -> [in, out]

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        layers.append({
            "input_norm": g(f"{p}.input_layernorm.weight"),
            "q": dense(f"{p}.self_attn.q_proj.weight"),
            "k": dense(f"{p}.self_attn.k_proj.weight"),
            "v": dense(f"{p}.self_attn.v_proj.weight"),
            "o": dense(f"{p}.self_attn.o_proj.weight"),
            "post_norm": g(f"{p}.post_attention_layernorm.weight"),
            "gate": dense(f"{p}.mlp.gate_proj.weight"),
            "up": dense(f"{p}.mlp.up_proj.weight"),
            "down": dense(f"{p}.mlp.down_proj.weight"),
        })
    params: Params = {
        "embedding": g("model.embed_tokens.weight"),
        "layers": {key: torch.stack([lp[key] for lp in layers]) for key in layers[0]},
        "final_norm": g("model.norm.weight"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense("lm_head.weight")
    return params


def load_hf_causal_lm(ckpt_dir: str, **overrides: Any) -> Tuple[Params, CausalLMConfig]:
    """Load a local HF LLaMA-family directory -> (fp32 CPU params, config)."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = causal_config_from_hf(hf_cfg, **overrides)
    sd: Dict[str, Any] = _load_state_dict(ckpt_dir)
    return causal_params_from_state_dict(sd, cfg), cfg


def is_causal_lm_checkpoint(ckpt_dir: str) -> bool:
    """True if ``ckpt_dir`` holds a decoder-only model (the reference's
    try-seq2seq-except-causal probe, decided from config.json instead of
    loading weights twice)."""
    try:
        with open(os.path.join(ckpt_dir, "config.json")) as f:
            hf_cfg = json.load(f)
    except (OSError, ValueError):
        return False
    archs = hf_cfg.get("architectures") or []
    if any("CausalLM" in a for a in archs):
        return True
    if any("ConditionalGeneration" in a or "EncoderModel" in a for a in archs):
        return False
    return hf_cfg.get("model_type") in ("llama", "mistral", "qwen2", "gemma")
