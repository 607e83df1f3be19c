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

After :meth:`AdamWClip.offload` (the JAX package's ``offload_opt_state``,
the reference's DeepSpeedCPUAdam role) Adam's two moments live in pinned host
memory: each update streams them to the device one parameter leaf at a
time, runs the same AdamW update there and copies them back, so the device
holds one leaf's moments at a time instead of all of them. The update is
the on-device one, leaf by leaf, so the parameters stay bit-equal to it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

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


MOMENTS = ("exp_avg", "exp_avg_sq")  # torch.optim.AdamW's names of Adam's two moments


class AdamWClip:
    """``clip_by_global_norm(grad_clip)`` then AdamW at
    ``constant_warmup_schedule(lr, warmup_steps)``, over float32 leaves;
    after :meth:`offload` the moments stay in host memory between updates."""

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
        self.offload_moments = False
        # Each leaf's pinned host buffers, written back in place every update.
        self._host: Dict[Tuple[int, str], torch.Tensor] = {}
        self.schedule = constant_warmup_schedule(lr, warmup_steps)
        self.grad_clip = grad_clip
        self.count = 0  # updates applied so far
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.schedule(0), betas=(b1, b2), eps=eps, weight_decay=weight_decay
        )

    def offload(self) -> None:
        """Keep the moments in host memory from now on (those already made
        move there now)."""
        self.offload_moments = True
        for p in self.params:
            self._moments_to_host(p)

    def _moments_to_host(self, p: torch.Tensor) -> None:
        """Copy ``p``'s moments into its host buffers (pinned when ``p`` is on
        a card; the copy is asynchronous, ordered on the stream)."""
        state = self.adamw.state.get(p)
        for key in MOMENTS if state else ():
            moment = state[key]
            host = self._host.get((id(p), key))
            if host is None:
                host = torch.empty(moment.shape, dtype=moment.dtype,
                                   pin_memory=moment.is_cuda)
                self._host[(id(p), key)] = host
            if host is not moment:
                host.copy_(moment, non_blocking=True)
            state[key] = host

    def _moments_to_device(self, p: torch.Tensor) -> None:
        state = self.adamw.state.get(p)
        for key in MOMENTS if state else ():
            state[key] = state[key].to(p.device, non_blocking=True)

    def _step_streamed(self) -> None:
        """One AdamW update per leaf: its moments in from host memory, the
        update (the others' gradients hidden, so AdamW skips them), its
        moments back out."""
        grads = {id(p): p.grad for p in self.params}
        for p in self.params:
            p.grad = None
        try:
            for p in self.params:
                if grads[id(p)] is None:
                    continue
                p.grad = grads[id(p)]
                self._moments_to_device(p)
                self.adamw.step()
                self._moments_to_host(p)
                p.grad = None
        finally:
            for p in self.params:
                p.grad = grads[id(p)]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the parameters' ``.grad``."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_clip is not None and self.grad_clip > 0 and grads:
            clip_by_global_norm_(grads, self.grad_clip)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        if self.offload_moments:
            self._step_streamed()
        else:
            self.adamw.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        if self.offload_moments and any(p.is_cuda for p in self.params):
            torch.cuda.synchronize()  # the host moments' last copies have landed
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a state dict of either placement; with ``offload_moments``
        the moments go back to host memory."""
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])
        if self.offload_moments:
            self.offload()
