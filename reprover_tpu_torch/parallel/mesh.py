"""Device mesh over ``torch.distributed``: the counterpart of
:mod:`reprover_tpu.parallel.mesh`.

Axes, as in the JAX package:

- ``data``: data parallelism and ZeRO-style sharding of Adam's moments
  (the reference's DeepSpeed ZeRO-2 role);
- ``model``: tensor parallelism (Megatron column/row splits: the
  tensor-parallel streaming engines and ``model_parallel=True`` training);
- ``seq``: sequence parallelism (the encoder's sequence split over the
  ranks, attention as a ring: :mod:`reprover_tpu_torch.ops.ring_attention`).

Each process is one rank and drives one device. A mesh is a ``(data, seq,
model)`` grid of ranks with ``model`` innermost, so the rank at mesh
position ``i`` sits at ``data`` coordinate ``i // (seq * model)``, ``seq``
coordinate ``i // model % seq`` and ``model`` coordinate ``i % model``
(``coords`` is the ``(data, model)`` pair; ``seq`` is 1 unless asked
for); it carries the process group of this rank's line along each axis,
and a host ``control`` group (gloo, CPU tensors) over the whole grid, in
which the first rank of a tensor-parallel engine sends its calls to the
others.

Process groups are joined or formed by :func:`init_distributed`: one that
``torchrun`` describes in the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), else an explicit rendezvous
(``init_method``, rank, world size). The backend is the caller's: NCCL for
cards and gloo for the CPU unless one is named. A group that fails to form
raises; nothing falls back to one rank.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, seq, model)`` grid of ranks; ``coords`` is this rank's
    ``(data, model)`` position and ``seq_coord`` its ``seq`` one, ``groups``
    the process group of its line along each axis of more than one rank,
    and ``control`` over the grid (empty for a mesh of one rank, or one
    built only to compute sharding specs)."""

    data: int
    model: int = 1
    coords: Tuple[int, int] = (0, 0)
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict, compare=False)
    seq: int = 1
    seq_coord: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name (the JAX mesh's ``shape``)."""
        return {"data": self.data, "seq": self.seq, "model": self.model}

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if axis == "seq":
            return self.seq_coord
        return self.coords[("data", "model").index(axis)]

    def group(self, axis: str) -> Any:
        """The process group of this rank's line along ``axis`` (or the
        ``control`` group over the grid)."""
        size = self.size if axis == "control" else self.shape[axis]
        if size > 1 and axis not in self.groups:
            raise RuntimeError(f"this mesh has no process group for axis {axis!r}: build it "
                               "with make_mesh inside an initialized process group")
        return self.groups.get(axis)

    @property
    def size(self) -> int:
        return self.data * self.seq * self.model

    @property
    def is_leader(self) -> bool:
        """Whether this rank is the grid's first: the one that owns a
        tensor-parallel engine's host API."""
        return self.coords == (0, 0) and self.seq_coord == 0

    def spans(self, axis: str = "data") -> bool:
        """Whether ``axis`` has more than one rank (collectives to run)."""
        return self.shape[axis] > 1


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def in_torchrun_env() -> bool:
    """Whether the environment describes a process group (``torchrun``)."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def init_distributed(
    device: Any,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
) -> Tuple[int, int]:
    """Join this process's process group, forming it if needed; returns
    ``(rank, world_size)``.

    An initialized group is joined as it is. Otherwise ``init_method``,
    ``rank`` and ``world_size`` form one, or, with none of them, the
    ``torchrun`` environment does (``env://``); anything else raises.
    ``backend`` defaults to NCCL on a CUDA ``device`` and gloo on the CPU.
    On a CUDA device the rank takes card ``LOCAL_RANK % device_count``
    (ranks beyond the cards share them)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = torch.device(device)
    if init_method is None:
        if rank is not None or world_size is not None:
            raise ValueError("rank and world_size need an init_method")
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"no process group to join: pass init_method, rank and "
                               f"world_size, or run under torchrun (missing {missing})")
        init_method, rank, world_size = ("env://", int(os.environ["RANK"]),
                                         int(os.environ["WORLD_SIZE"]))
    elif rank is None or world_size is None:
        raise ValueError(f"init_method {init_method!r} needs rank and world_size")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return rank, world_size


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[int]] = None,
    seq: int = 1,
) -> Mesh:
    """Build a ``(data, seq, model)`` mesh over ``devices`` (the ranks, one
    device each; default: every rank of the initialized group).

    ``data=None`` uses every rank not consumed by ``seq`` and ``model``
    (``make_mesh(data=1, seq=n)`` is the JAX dry run's ``Mesh(devices,
    ("seq",))``). Every rank of the group must call this (it forms the axis
    groups), including ranks the mesh leaves out, which then get an error."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    ranks = list(devices) if devices is not None else list(range(world))
    n = len(ranks)
    if model < 1 or seq < 1 or n % (model * seq):
        raise ValueError(f"{n} devices are not divisible by seq={seq} x model={model}")
    if data is None:
        data = n // (model * seq)
    name = f"{data}x{model}" if seq == 1 else f"{data}x{seq}x{model}"
    if data < 1 or data * seq * model > n:
        raise ValueError(f"mesh {name} needs more than {n} devices")
    grid = ranks[: data * seq * model]
    if not dist.is_initialized():
        if len(grid) > 1:
            raise RuntimeError(f"a {name} mesh needs an initialized process group "
                               "(init_distributed)")
        return Mesh(1, 1)
    groups: Dict[str, Any] = {}

    def at(d: int, s: int, m: int) -> int:
        return grid[(d * seq + s) * model + m]

    lines = {
        "data": [[at(d, s, m) for d in range(data)] for s in range(seq) for m in range(model)],
        "model": [[at(d, s, m) for m in range(model)] for d in range(data) for s in range(seq)],
        "seq": [[at(d, s, m) for s in range(seq)] for d in range(data) for m in range(model)],
    }
    for axis, axis_lines in lines.items():
        for line in axis_lines:
            if len(line) < 2:
                continue
            group = (dist.group.WORLD if sorted(line) == list(range(world))
                     else dist.new_group(line))  # every rank of the group calls new_group
            if me in line:
                groups[axis] = group
    if len(grid) > 1:
        # Host messages between a tensor-parallel engine's ranks: gloo, so
        # they travel as CPU tensors whatever the ranks' backend.
        control = (dist.group.WORLD if sorted(grid) == list(range(world))
                   and dist.get_backend() == "gloo" else dist.new_group(grid, backend="gloo"))
        if me in grid:
            groups["control"] = control
    if me not in grid:
        raise ValueError(f"rank {me} is not in the {name} mesh over ranks {grid}")
    i = grid.index(me)
    return Mesh(data, model, (i // (seq * model), i % model), groups, seq, i // model % seq)


def is_first_rank(mesh: Optional[Mesh]) -> bool:
    """Whether this rank writes a fit's logs and checkpoints: no mesh, or
    the grid's first rank (coordinate 0 on every axis)."""
    return mesh is None or mesh.is_leader


def local_mesh() -> Mesh:
    """A 1x1 mesh on this rank's device: single-device paths without
    branches (the steps run no collective on it)."""
    return Mesh(1, 1)


# ------------------------------------------------------------------ #
# Data-parallel fits: how many ranks, and launching them
# ------------------------------------------------------------------ #


def launch_count(data_parallel: bool, batch_size: int, device: Any) -> int:
    """Ranks a ``fit`` launches itself: ``gcd(batch_size, cards)`` on a
    machine with several cards (the JAX package's rule), when data
    parallelism is on and this process is not already a rank of a group;
    else 1."""
    import torch.distributed as dist

    device = torch.device(device)
    if (not data_parallel or device.type != "cuda" or dist.is_initialized()
            or in_torchrun_env()):
        return 1
    return math.gcd(batch_size, torch.cuda.device_count())


def fit_mesh(data_parallel: bool, batch_size: int, device: Any) -> Optional[Mesh]:
    """The ``data`` mesh a ``fit`` trains on: every rank of this process's
    group (joined, or formed from the ``torchrun`` environment), or None
    for one process (or ``data_parallel`` off). The data axis must divide
    the batch size."""
    import torch.distributed as dist

    if not data_parallel or not (dist.is_initialized() or in_torchrun_env()):
        return None
    _, world = init_distributed(device)
    if world == 1:
        return None
    if batch_size % world:
        raise ValueError(f"the data axis ({world} ranks) must divide the batch size "
                         f"({batch_size})")
    return make_mesh(data=world)


def _rank_main(rank: int, main: Callable[[List[str]], Any], argv: List[str], world: int,
               init_method: str, device: str) -> None:
    init_distributed(device, init_method=init_method, rank=rank, world_size=world)
    try:
        main(argv)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def launch_ranks(main: Callable[[List[str]], Any], argv: List[str], n: int, device: Any) -> None:
    """Run ``main(argv)`` on ``n`` spawned ranks, one per card, in a process
    group formed through a rendezvous file of this launch; returns when
    every rank has finished and raises if one failed."""
    import torch.multiprocessing as mp

    logger.info("data parallelism: launching %d ranks", n)
    with tempfile.TemporaryDirectory(prefix="reprover_rendezvous_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, args=(main, list(argv), n, init_method, str(device)), nprocs=n,
                 join=True)
