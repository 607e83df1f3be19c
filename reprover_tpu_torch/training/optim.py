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

After :meth:`AdamWClip.shard` (ZeRO-2 over a mesh's ``data`` axis, the
JAX package's ZeRO-sharded moments) each rank keeps the moments of its own
shard of every leaf only: the axis :func:`~reprover_tpu_torch.parallel.
sharding.zero_partition_specs` picks, the largest one the ``data`` size
divides; a leaf with none stays whole on every rank. An update sums the
gradients over ``data``, clips them by their global norm (the one-device
clip, on the same whole gradients), updates this rank's shards in place and
gathers the shards, so every rank ends with the whole new parameters.

After :meth:`AdamWClip.split_model` (tensor parallelism over a mesh's
``model`` axis) the optimizer holds each rank's Megatron shards of the
parameters: the global-norm clip sums the split leaves' squares over
``model`` (the replicated leaves' gradients are the same on every rank and
count once), ZeRO adds ``data`` on an axis the ``model`` split leaves whole,
and :meth:`AdamWClip.state_dict` gathers the moments over both axes into
the one-card layout.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def constant_warmup_schedule(lr: float, warmup_steps: int) -> Schedule:
    """HF ``get_constant_schedule_with_warmup``: ``lr * min(1, count/warmup)``."""
    if warmup_steps <= 0:
        return lambda count: lr
    return lambda count: lr * min(1.0, count / warmup_steps)


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float,
                         split: Optional[Sequence[bool]] = None, mesh: Any = None
                         ) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / norm)`` of their global
    L2 norm; returns the norm (a device tensor: nothing syncs). Under a
    tensor-parallel ``mesh``, the gradients marked ``split`` are this rank's
    shards: their squares are summed over ``model``."""
    norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
    if mesh is None or not mesh.spans("model") or split is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        import torch.distributed as dist

        mask = torch.tensor(list(split), device=norms.device)
        parts = torch.stack([norms[~mask].square().sum(), norms[mask].square().sum()])
        shards = parts[1:].clone()
        dist.all_reduce(shards, group=mesh.group("model"))
        norm = torch.sqrt(parts[0] + shards[0])
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
        # Tensor parallelism (split_model): the mesh, and each leaf's spec
        # and the axis it splits over ``model`` (None: replicated).
        self.model_mesh: Any = None
        self.model_specs: Optional[List[Any]] = None
        self.model_axes: List[Optional[int]] = [None] * len(self.params)
        self.model_blocks: List[int] = [1] * len(self.params)
        # Each leaf's pinned host buffers, written back in place every update.
        self._host: Dict[Tuple[int, str], torch.Tensor] = {}
        self.schedule = constant_warmup_schedule(lr, warmup_steps)
        self.grad_clip = grad_clip
        self.count = 0  # updates applied so far
        self._hyper = dict(betas=(b1, b2), eps=eps, weight_decay=weight_decay)
        # ZeRO (shard): the mesh, each leaf's shard axis (None: whole) and the
        # tensors AdamW updates, this rank's shards as views of the leaves.
        self.mesh: Any = None
        self.shard_axes: List[Optional[int]] = [None] * len(self.params)
        self.targets: List[torch.Tensor] = self.params
        self.adamw = torch.optim.AdamW(self.targets, lr=self.schedule(0), **self._hyper)

    def shard(self, mesh: Any) -> None:
        """Keep only this rank's ZeRO shard of every leaf's moments from now
        on (moments already made are sliced); a mesh whose ``data`` axis is
        one rank changes nothing."""
        from reprover_tpu_torch.parallel.sharding import shard_axis, zero_partition_specs

        if mesh == self.mesh or not mesh.spans("data"):
            return
        if self.mesh is not None:
            raise ValueError("the optimizer is already sharded over another mesh")
        full = self.state_dict()
        specs = zero_partition_specs(self.params, mesh, param_specs=self.model_specs)
        self.mesh = mesh
        self.shard_axes = [shard_axis(s) for s in specs]
        self.targets = [self._shard_of(p.detach(), a) for p, a in zip(self.params, self.shard_axes)]
        self.adamw = torch.optim.AdamW(self.targets, lr=self.schedule(self.count), **self._hyper)
        self._host.clear()
        self.load_state_dict(full)

    def split_model(self, params: Sequence[torch.Tensor], specs: Sequence[Any],
                    mesh: Any, blocks: Optional[Sequence[int]] = None) -> None:
        """Rebind to ``params``, this rank's tensor-parallel shards of the
        leaves (same order; ``specs`` their legalized specs, ``blocks`` their
        part counts, :func:`~reprover_tpu_torch.parallel.sharding.model_part`),
        keeping the update count, the moments (sliced) and where they live;
        a ZeRO split over ``data`` is made again around the ``model`` one."""
        from reprover_tpu_torch.parallel.sharding import shard_axis

        full, data_mesh = self.state_dict(), self.mesh
        self.params = list(params)
        self.model_mesh, self.model_specs = mesh, list(specs)
        self.model_axes = [shard_axis(s, "model") for s in self.model_specs]
        self.model_blocks = list(blocks) if blocks is not None else [1] * len(self.params)
        self.mesh, self.shard_axes, self.targets = None, [None] * len(self.params), self.params
        self.adamw = torch.optim.AdamW(self.targets, lr=self.schedule(self.count), **self._hyper)
        self._host.clear()
        if data_mesh is not None:
            self.shard(data_mesh)
        self.load_state_dict(full)

    def _model_shard_of(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's ``model`` shard of a whole leaf-shaped ``t`` (leaf ``i``)."""
        from reprover_tpu_torch.parallel.sharding import model_part

        axis = self.model_axes[i]
        if axis is None:
            return t
        return model_part(t, axis, self.model_mesh, self.model_blocks[i])

    def _shard_of(self, t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        """This rank's shard of a leaf-shaped ``t`` (a view; ``t`` when whole)."""
        if axis is None:
            return t
        n = self.mesh.shape["data"]
        size = t.shape[axis] // n
        return t.narrow(axis, self.mesh.coord("data") * size, size)

    def moment_bytes(self) -> int:
        """Bytes of the moments this rank holds (host or device)."""
        return sum(state[key].numel() * state[key].element_size()
                   for state in self.adamw.state.values() for key in MOMENTS if key in state)

    def offload(self) -> None:
        """Keep the moments in host memory from now on (those already made
        move there now)."""
        self.offload_moments = True
        for p in self.targets:
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
        grads = {id(p): p.grad for p in self.targets}
        for p in self.targets:
            p.grad = None
        try:
            for p in self.targets:
                if grads[id(p)] is None:
                    continue
                p.grad = grads[id(p)]
                self._moments_to_device(p)
                self.adamw.step()
                self._moments_to_host(p)
                p.grad = None
        finally:
            for p in self.targets:
                p.grad = grads[id(p)]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the parameters' ``.grad`` (under :meth:`shard`,
        each rank's share of the global batch's gradient): its three parts
        in turn."""
        self.reduce_gradients()
        self.update()
        self.gather_shards()

    def reduce_gradients(self) -> None:
        """Under :meth:`shard`: sum the gradients over ``data`` in place."""
        from reprover_tpu_torch.parallel.collectives import reduce_gradients_

        if self.mesh is not None:
            reduce_gradients_([p.grad for p in self.params if p.grad is not None], self.mesh)

    def update(self) -> None:
        """Clip by the global norm, then AdamW on this rank's shards (the
        whole leaves without :meth:`shard`)."""
        have = [i for i, p in enumerate(self.params) if p.grad is not None]
        grads = [self.params[i].grad for i in have]
        if self.grad_clip is not None and self.grad_clip > 0 and grads:
            clip_by_global_norm_(grads, self.grad_clip,
                                 [self.model_axes[i] is not None for i in have], self.model_mesh)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        if self.mesh is not None:
            for p, t, axis in zip(self.params, self.targets, self.shard_axes):
                t.grad = None if p.grad is None else self._shard_of(p.grad, axis)
        if self.offload_moments:
            self._step_streamed()
        else:
            self.adamw.step()
        self.count += 1

    def gather_shards(self) -> None:
        """Under :meth:`shard`: every rank's updated shards, made whole on
        every rank."""
        from reprover_tpu_torch.parallel.collectives import gather_shards_

        if self.mesh is not None:
            for p, axis in zip(self.params, self.shard_axes):
                if axis is not None and p.grad is not None:
                    gather_shards_(p.detach(), axis, self.mesh)

    def state_dict(self) -> Dict[str, Any]:
        """The one-device layout: under :meth:`shard` every rank's moment
        shards are gathered, under :meth:`split_model` over ``model`` too (a
        collective: every rank calls it)."""
        from reprover_tpu_torch.parallel.collectives import gather_shards_
        from reprover_tpu_torch.parallel.sharding import model_whole

        if self.offload_moments and any(p.is_cuda for p in self.params):
            torch.cuda.synchronize()  # the host moments' last copies have landed
        inner = self.adamw.state_dict()
        if self.mesh is not None:
            state = {}
            for i, per in inner["state"].items():
                p, axis = self.params[i], self.shard_axes[i]
                per = dict(per)
                for key in MOMENTS if axis is not None else ():
                    whole = torch.zeros(p.shape, dtype=per[key].dtype, device=p.device)
                    self._shard_of(whole, axis).copy_(per[key])
                    per[key] = gather_shards_(whole, axis, self.mesh)
                state[i] = per
            inner = {"state": state, "param_groups": inner["param_groups"]}
        if self.model_mesh is not None:
            state = {}
            for i, per in inner["state"].items():
                per = dict(per)
                for key in MOMENTS if self.model_axes[i] is not None else ():
                    per[key] = model_whole(per[key], self.model_axes[i], self.model_mesh,
                                           self.model_blocks[i])
                state[i] = per
            inner = {"state": state, "param_groups": inner["param_groups"]}
        return {"count": self.count, "adamw": inner}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load a state dict of either placement (always the one-device
        layout; under :meth:`shard` each rank keeps its shards); with
        ``offload_moments`` the moments go back to host memory."""
        self.count = int(state["count"])
        inner = state["adamw"]
        if self.model_mesh is not None:
            inner = {"state": {i: {k: self._model_shard_of(v, int(i)).contiguous()
                                   if k in MOMENTS else v for k, v in per.items()}
                               for i, per in inner["state"].items()},
                     "param_groups": inner["param_groups"]}
        if self.mesh is not None:
            sliced = {}
            for i, per in inner["state"].items():
                per = dict(per)
                for key in MOMENTS if self.shard_axes[int(i)] is not None else ():
                    per[key] = self._shard_of(per[key], self.shard_axes[int(i)]).contiguous()
                sliced[i] = per
            inner = {"state": sliced, "param_groups": inner["param_groups"]}
        self.adamw.load_state_dict(inner)
        if self.offload_moments:
            self.offload()
