"""Training checkpoints: the counterpart of
:class:`reprover_tpu.utils.CheckpointManager` without Orbax.

Same API (``save``, ``restore``, ``latest_step``, ``best_step``, ``wait``)
and the same keep rule, the reference's Lightning callbacks
(``save_top_k=1`` + ``save_last``): keep the best checkpoint by a monitored
metric and the latest ``keep_last_n``. A save whose metrics lack the
monitored key is kept as latest and never ranks as best (the JAX package's
missing-monitor rule, which replaced a KeyError that once lost 21k steps of
a pretrain).

Each checkpoint is a directory ``<step>/`` holding ``state.pt`` (a
``torch.save`` of the step, the parameters as CPU tensors and the
optimizer's state dict) and ``metrics.json``. A save is written under a
temporary name and renamed, so a reader never sees half a checkpoint; it is
synchronous, so :meth:`wait` has nothing to wait for.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Dict, List, Optional

import torch


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _copy_into(dst: Any, src: Any, path: str = "") -> None:
    """Copy a saved tree into the matching tree of tensors, in place."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise KeyError(f"checkpoint tree differs from the state at {path or '<root>'}")
        for k in dst:
            _copy_into(dst[k], src[k], f"{path}/{k}")
        return
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint shape {tuple(src.shape)} != {tuple(dst.shape)} at {path}")
    with torch.no_grad():
        dst.copy_(src)


class CheckpointManager:
    """Best-by-metric + latest checkpoints of a ``TrainState``."""

    def __init__(
        self,
        directory: str,
        monitor: Optional[str] = None,
        mode: str = "max",
        keep_last_n: int = 1,
    ) -> None:
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.directory = directory
        self.monitor = monitor
        self.mode = mode
        self.keep_last_n = keep_last_n
        os.makedirs(directory, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.exists(os.path.join(self.directory, name, "state.pt"))
        )

    def _metrics(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self.directory, str(step), "metrics.json")) as f:
            return json.load(f)

    def save(self, step: int, state: Any, metrics: Optional[Dict[str, float]] = None) -> None:
        """Write ``state`` (step, params, optimizer) as checkpoint ``step``,
        then drop every checkpoint that is neither best nor latest."""
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        optimizer = getattr(state, "optimizer", None)
        torch.save(
            {
                "step": int(state.step),
                "params": _to_cpu(state.params),
                "optimizer": None if optimizer is None else optimizer.state_dict(),
            },
            os.path.join(tmp, "state.pt"),
        )
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump(dict(metrics or {}), f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._prune()

    def _prune(self) -> None:
        steps = self._steps()
        keep = set(steps[-self.keep_last_n:]) if self.keep_last_n > 0 else set()
        best = self.best_step()
        if best is not None:
            keep.add(best)
        for step in steps:
            if step not in keep:
                shutil.rmtree(os.path.join(self.directory, str(step)))

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Load checkpoint ``step`` (default: the latest) into ``state_like``:
        parameters are copied into its tensors in place (bit-exact for equal
        dtypes), the optimizer's state is loaded, and the step is set."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        saved = torch.load(os.path.join(self.directory, str(step), "state.pt"),
                           map_location="cpu", weights_only=True)
        _copy_into(state_like.params, saved["params"])
        optimizer = getattr(state_like, "optimizer", None)
        if optimizer is not None and saved["optimizer"] is not None:
            optimizer.load_state_dict(saved["optimizer"])
        state_like.step = int(saved["step"])
        return state_like

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The step with the best monitored value (the earliest of equals);
        the latest step without a monitor; None when no checkpoint holds the
        monitored key."""
        if self.monitor is None:
            return self.latest_step()
        best, best_value = None, math.nan
        for step in self._steps():
            value = self._metrics(step).get(self.monitor)
            if value is None or math.isnan(value):
                continue
            if best is None or (value > best_value if self.mode == "max" else value < best_value):
                best, best_value = step, value
        return best

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""
