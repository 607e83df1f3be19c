"""Utilities of the port: config parsing, metric writers, checkpoints.

Copies of the JAX package's host-side utilities, which cannot be imported
from there without JAX (``reprover_tpu/utils/__init__.py`` imports it and
Orbax); checkpoints are ``torch.save`` state dicts.
"""

from reprover_tpu_torch.utils.checkpoint import CheckpointManager
from reprover_tpu_torch.utils.config import config_to_dict, parse_config
from reprover_tpu_torch.utils.metrics import (
    JsonlWriter,
    MetricWriter,
    MultiWriter,
    StdoutWriter,
    make_writer,
)

__all__ = [
    "CheckpointManager",
    "config_to_dict",
    "parse_config",
    "JsonlWriter",
    "MetricWriter",
    "MultiWriter",
    "StdoutWriter",
    "make_writer",
]
