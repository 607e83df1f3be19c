"""HF T5 checkpoint import and export (local directories; no network): the
counterpart of :mod:`reprover_tpu.models.hf_import`.

HF stores dense weights as ``[out, in]`` (``nn.Linear``); the port's layout
is the JAX package's ``[in, out]`` with per-layer weights stacked, so every
dense weight is transposed on the way in and out. Both full seq2seq
checkpoints and ``T5EncoderModel`` exports load (``encoder_only=True`` reads
only the encoder).

``model.safetensors`` is read and written here (:func:`load_safetensors`,
:func:`save_safetensors`), without the ``safetensors`` package: an 8-byte
little-endian header length, a JSON header giving each tensor's dtype,
shape and ``data_offsets``, then the raw buffers.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from reprover_tpu_torch.models.t5 import Params, T5Config

# safetensors' dtype names.
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_DTYPE_NAMES = {dtype: name for name, dtype in SAFETENSORS_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU. The tensors share
    one buffer read from the file (little-endian, as the format is)."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = bytearray(f.read())
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        if end > len(data) or end < begin:
            raise ValueError(f"{path}: {name}'s data_offsets {entry['data_offsets']} lie "
                             f"outside the {len(data)}-byte buffer")
        flat = (torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                 offset=begin) if end > begin else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(entry["shape"])
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; written from contiguous CPU copies) as a
    ``.safetensors`` file, in name order, the header padded with spaces to a
    multiple of 8 bytes as the ``safetensors`` package pads it."""
    cpu = {name: t.detach().to("cpu").contiguous() for name, t in sorted(tensors.items())}
    header: Dict[str, Any] = {"__metadata__": metadata} if metadata else {}
    offset = 0
    for name, t in cpu.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in cpu.values():
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


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
        return load_safetensors(st_path)
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


def export_hf_t5(params: Params, cfg: T5Config, out_dir: str, encoder_only: bool = False) -> None:
    """Write the port's tree as an HF-layout directory (``model.safetensors``
    and ``config.json``), as the JAX package's ``export_hf_t5`` writes it: the
    same key names, float32 ``[out, in]`` dense weights, a fused gate|up MLP
    split back into ``wi_0``/``wi_1``, the tied embedding under its three
    names, and the same ``config.json``."""
    os.makedirs(out_dir, exist_ok=True)
    sd: Dict[str, torch.Tensor] = {}

    def put(name: str, t: torch.Tensor) -> None:
        sd[name] = t.detach().to("cpu", torch.float32).contiguous()

    def put_dense(name: str, t: torch.Tensor) -> None:
        put(name, t.detach().to("cpu", torch.float32).t())

    def layer(stacked: Params, i: int) -> Params:
        lp = {k: (layer(v, i) if isinstance(v, dict) else v[i]) for k, v in stacked.items()}
        mlp = lp.get("mlp")
        if mlp is not None and "wi" in mlp:  # t5.fuse_mlp_params's inverse
            wi_0, wi_1 = mlp["wi"].chunk(2, dim=-1)
            lp["mlp"] = {"wi_0": wi_0, "wi_1": wi_1, "wo": mlp["wo"]}
        return lp

    put("shared.weight", params["shared_embedding"])
    put("encoder.embed_tokens.weight", params["shared_embedding"])
    put("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
        params["encoder"]["rel_bias"])
    for i in range(cfg.num_encoder_layers):
        lp = layer(params["encoder"]["layers"], i)
        b = f"encoder.block.{i}"
        for x in ("q", "k", "v", "o"):
            put_dense(f"{b}.layer.0.SelfAttention.{x}.weight", lp["attn"][x])
        put(f"{b}.layer.0.layer_norm.weight", lp["attn_norm"])
        for x in ("wi_0", "wi_1", "wo"):
            put_dense(f"{b}.layer.1.DenseReluDense.{x}.weight", lp["mlp"][x])
        put(f"{b}.layer.1.layer_norm.weight", lp["mlp_norm"])
    put("encoder.final_layer_norm.weight", params["encoder"]["final_norm"])

    if not encoder_only and "decoder" in params:
        put("decoder.embed_tokens.weight", params["shared_embedding"])
        put("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
            params["decoder"]["rel_bias"])
        for i in range(cfg.num_decoder_layers):
            lp = layer(params["decoder"]["layers"], i)
            b = f"decoder.block.{i}"
            for x in ("q", "k", "v", "o"):
                put_dense(f"{b}.layer.0.SelfAttention.{x}.weight", lp["self_attn"][x])
            put(f"{b}.layer.0.layer_norm.weight", lp["self_norm"])
            for x in ("q", "k", "v", "o"):
                put_dense(f"{b}.layer.1.EncDecAttention.{x}.weight", lp["cross_attn"][x])
            put(f"{b}.layer.1.layer_norm.weight", lp["cross_norm"])
            for x in ("wi_0", "wi_1", "wo"):
                put_dense(f"{b}.layer.2.DenseReluDense.{x}.weight", lp["mlp"][x])
            put(f"{b}.layer.2.layer_norm.weight", lp["mlp_norm"])
        put("decoder.final_layer_norm.weight", params["decoder"]["final_norm"])
        if not cfg.tie_word_embeddings:
            put_dense("lm_head.weight", params["lm_head"])

    save_safetensors(sd, os.path.join(out_dir, "model.safetensors"), {"format": "pt"})
    hf_cfg = {
        "architectures": ["T5EncoderModel" if encoder_only else "T5ForConditionalGeneration"],
        "model_type": "t5",
        "vocab_size": cfg.vocab_size,
        "d_model": cfg.d_model,
        "d_kv": cfg.d_kv,
        "d_ff": cfg.d_ff,
        "num_heads": cfg.num_heads,
        "num_layers": cfg.num_encoder_layers,
        "num_decoder_layers": cfg.num_decoder_layers,
        "relative_attention_num_buckets": cfg.relative_attention_num_buckets,
        "relative_attention_max_distance": cfg.relative_attention_max_distance,
        "layer_norm_epsilon": cfg.layer_norm_epsilon,
        "feed_forward_proj": "gated-gelu",
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "pad_token_id": cfg.pad_token_id,
        "eos_token_id": cfg.eos_token_id,
        "decoder_start_token_id": cfg.decoder_start_token_id,
        "is_encoder_decoder": not encoder_only,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
