"""The port's counterparts of the repository's ``scripts/`` that import the
JAX package, run as modules: ``python -m reprover_tpu_torch.scripts.data_stats``
and ``python -m reprover_tpu_torch.scripts.convert_checkpoint``."""
