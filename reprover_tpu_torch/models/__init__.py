"""T5 (ByT5) in PyTorch, HF checkpoint import and export, and the weight
bridge from the JAX package."""

from reprover_tpu_torch.models.t5 import (
    DecodeState,
    T5Config,
    byt5_small,
    cross_entropy_loss,
    decode,
    decode_step,
    encode,
    forward_loss,
    fuse_mlp_params,
    init_decode_state,
    init_params,
    place_master_params,
    place_params,
    shift_right,
)
from reprover_tpu_torch.models.hf_import import (
    export_hf_t5,
    load_hf_t5,
    params_from_torch_state_dict,
)
from reprover_tpu_torch.models.bridge import params_from_jax

__all__ = [
    "DecodeState",
    "T5Config",
    "byt5_small",
    "cross_entropy_loss",
    "decode",
    "decode_step",
    "encode",
    "forward_loss",
    "fuse_mlp_params",
    "init_decode_state",
    "init_params",
    "place_master_params",
    "place_params",
    "shift_right",
    "export_hf_t5",
    "load_hf_t5",
    "params_from_torch_state_dict",
    "params_from_jax",
]
