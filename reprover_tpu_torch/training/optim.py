"""Optimizer: global-norm clipping, then AdamW with a constant-with-warmup
schedule — the counterpart of :mod:`reprover_tpu.training.optim`, which
chains ``optax.clip_by_global_norm(grad_clip)`` and ``optax.adamw`` over
``constant_warmup_schedule``.

Three details make it match optax step for step:

- the schedule is evaluated at the 0-based update count, so with warmup the
  first update uses lr 0 (Adam's moments still take that step's gradient);
- clipping scales every gradient by ``min(1, max_norm / norm)`` of the
  global norm, as optax does, without ``clip_grad_norm_``'s ``+ 1e-6``;
- ``weight_decay`` is passed to ``torch.optim.AdamW`` explicitly (0 by
  default, DeepSpeed FusedAdam's default in the reference; torch's own
  default is 0.01).

Parameters are updated in place (the JAX package returns new arrays).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

Schedule = Callable[[int], float]


def constant_warmup_schedule(lr: float, warmup_steps: int) -> Schedule:
    """HF ``get_constant_schedule_with_warmup``: ``lr * min(1, count/warmup)``."""
    if warmup_steps <= 0:
        return lambda count: lr
    return lambda count: lr * min(1.0, count / warmup_steps)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / norm)`` of their global
    L2 norm; returns the norm (a device tensor: nothing syncs)."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


class AdamWClip:
    """``clip_by_global_norm(grad_clip)`` then AdamW at
    ``constant_warmup_schedule(lr, warmup_steps)``, over float32 leaves."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        lr: float,
        warmup_steps: int,
        weight_decay: float = 0.0,
        grad_clip: float = 1.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ) -> None:
        self.params: List[torch.Tensor] = list(params)
        self.schedule = constant_warmup_schedule(lr, warmup_steps)
        self.grad_clip = grad_clip
        self.count = 0  # updates applied so far
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=(b1, b2), eps=eps, weight_decay=weight_decay
        )

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the parameters' ``.grad``."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip is not None and self.grad_clip > 0 and grads:
            clip_by_global_norm_(grads, self.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])
