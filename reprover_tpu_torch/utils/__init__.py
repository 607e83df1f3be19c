"""Utilities of the port: config parsing, metric writers, checkpoints,
profiling and small glue.

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
from reprover_tpu_torch.utils.misc import set_logger, zip_strict
from reprover_tpu_torch.utils.profiling import SectionTimer, device_trace

__all__ = [
    "CheckpointManager",
    "config_to_dict",
    "parse_config",
    "JsonlWriter",
    "MetricWriter",
    "MultiWriter",
    "StdoutWriter",
    "make_writer",
    "set_logger",
    "zip_strict",
    "SectionTimer",
    "device_trace",
]
