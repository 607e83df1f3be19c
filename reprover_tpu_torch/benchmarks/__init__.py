"""Scripts that time the port on the card: one decoder-only fine-tuning
step (:mod:`~reprover_tpu_torch.benchmarks.causal_finetune_step`) and the
ablation harness of the encoder attention kernel
(:mod:`~reprover_tpu_torch.benchmarks.flash_kernel_bisect`). Run each with
``python -m``."""
