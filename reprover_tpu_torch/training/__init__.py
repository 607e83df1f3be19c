"""Training of the port: optimizer, train state, retrieval and generation
losses, train step, the trainer loop and training-health telemetry."""

from reprover_tpu_torch.training.optim import (
    AdamWClip,
    clip_by_global_norm_,
    constant_warmup_schedule,
)
from reprover_tpu_torch.training.tasks import (
    TrainState,
    generation_loss,
    init_train_state,
    make_eval_step,
    make_train_step,
    numeric_batch,
    offload_opt_state,
    param_leaves,
    retrieval_infonce_loss,
    retrieval_loss,
)
from reprover_tpu_torch.training.loop import Trainer, TrainerConfig

__all__ = [
    "AdamWClip",
    "clip_by_global_norm_",
    "constant_warmup_schedule",
    "TrainState",
    "generation_loss",
    "init_train_state",
    "make_eval_step",
    "make_train_step",
    "numeric_batch",
    "offload_opt_state",
    "param_leaves",
    "retrieval_infonce_loss",
    "retrieval_loss",
    "Trainer",
    "TrainerConfig",
]
