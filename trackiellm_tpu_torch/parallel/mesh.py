"""The device mesh on ``torch.distributed``: axes, coordinates, collectives.

Port of ``trackiellm_tpu/parallel/mesh.py``. JAX builds its mesh over the
devices one controller sees and lets GSPMD place the collectives; here each
rank is a process, the mesh is this rank's view of the grid (the axis sizes,
its coordinates, one process group per axis) and the forward calls the
collectives itself (``parallel/infer.py``).

The axes factor exactly as the JAX package's: ``(dp, fsdp, tp)`` with tp
the largest power of two up to ``max_tp`` that divides the world, or
``(dp, fsdp, ep, tp)`` with an expert axis. Ranks map onto the grid in row
order, as ``np.array(devices).reshape(dims)`` does there, so tp is the
innermost (fastest-varying) axis.

The backend is the caller's choice and nothing changes it: ``"nccl"`` for
one rank per card, ``"gloo"`` for ranks that share a card (NCCL refuses two
ranks on one GPU) or run on the CPU. Every verb takes a tensor on the rank's
device; gloo stages a CUDA tensor through the host (its all-reduce,
all-gather and broadcast all take one).
"""

from __future__ import annotations

import datetime
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from trackiellm_tpu_torch.utils.errors import ErrorCode, TrackieError

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 120.0


def _factor(n: int, max_tp: int) -> tuple[int, int, int]:
    """Split n devices into (dp, fsdp, tp): tp gets the largest power of
    two <= max_tp dividing n (tensor-parallel collectives are the most
    latency-sensitive, so tp stays small and contiguous on the ICI);
    fsdp takes the next factor of up to 4; dp absorbs the rest."""
    tp = 1
    while tp * 2 <= max_tp and n % (tp * 2) == 0:
        tp *= 2
    rem = n // tp
    fsdp = 1
    while fsdp * 2 <= 4 and rem % (fsdp * 2) == 0:
        fsdp *= 2
    dp = rem // fsdp
    return dp, fsdp, tp


def mesh_shape(n: int, tp: Optional[int] = None, max_tp: int = 4,
               ep: Optional[int] = None) -> Dict[str, int]:
    """The axis sizes of the JAX package's ``build_mesh`` over n devices
    (its single-host branch), in axis order."""
    if ep is not None:
        if n % ep:
            raise ValueError(f"{n} devices not divisible by ep={ep}")
        rem = n // ep
        if tp is None:
            _, _, tp = _factor(rem, max_tp)
        if rem % tp:
            raise ValueError(f"{rem} devices not divisible by tp={tp}")
        dp, fsdp, _ = _factor(rem // tp, 1)
        return dict(zip(("dp", "fsdp", "ep", "tp"), (dp, fsdp, ep, tp)))
    if tp is not None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        _, fsdp, _ = _factor(n // tp, 1)
        dims = (n // tp // fsdp, fsdp, tp)
    else:
        dims = _factor(n, max_tp)
    return dict(zip(("dp", "fsdp", "tp"), dims))


class Mesh:
    """This rank's view of the mesh: ``shape`` (axis -> size), ``coords``
    (axis -> this rank's index), and per axis the global ranks of the group
    this rank belongs to and its process group (None for a size-1 axis,
    whose verbs are the identity)."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 backend: Optional[str], device: torch.device,
                 groups: Dict[str, object],
                 members: Dict[str, List[int]], host_group=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.world = int(np.prod(list(shape.values())))
        index = np.unravel_index(rank, tuple(shape.values()))
        self.coords = dict(zip(self.axis_names, (int(c) for c in index)))
        self.backend = backend
        self.device = device
        self.groups = groups
        self.members = members
        self._host_group = host_group

    @property
    def tp(self) -> int:
        return self.shape.get("tp", 1)

    @property
    def tp_rank(self) -> int:
        return self.coords.get("tp", 0)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        at = ", ".join(f"{a}={c}" for a, c in self.coords.items())
        return (f"Mesh({axes}; rank {self.rank} at {at}; {self.backend} on "
                f"{self.device})")

    # -- collectives on one axis -------------------------------------------

    def all_reduce(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """The sum of ``t`` over the axis, in place; every rank of the group
        gets the same bits."""
        group = self.groups.get(axis)
        if group is None:
            return t
        t = t.contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = -1,
                   axis: str = "tp") -> torch.Tensor:
        """The axis's tensors concatenated along ``dim`` in coordinate
        order. The gather moves each tensor's bytes (a uint8 view: gloo
        gathers no 16-bit integers), so it copies and never rounds."""
        group = self.groups.get(axis)
        if group is None:
            return t
        t = t.contiguous()
        raw = t.view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in self.members[axis]]
        dist.all_gather(parts, raw, group=group)
        return torch.cat([p.view(t.dtype) for p in parts], dim=dim)

    def broadcast(self, t: torch.Tensor, src: int = 0,
                  axis: str = "tp") -> torch.Tensor:
        """``t`` of the axis's coordinate ``src``, in place."""
        group = self.groups.get(axis)
        if group is None:
            return t
        t = t.contiguous()
        dist.broadcast(t, src=self.members[axis][src], group=group)
        return t

    # -- host objects over the whole world ---------------------------------

    def broadcast_object(self, obj=None, src: int = 0):
        """A picklable host object of global rank ``src`` on every rank (a
        gloo group on the CPU, whatever the tensors' backend)."""
        if self.world == 1:
            return obj
        if self.rank == src:
            data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                    dtype=torch.uint8)
            size = torch.tensor([data.numel()], dtype=torch.int64)
        else:
            size = torch.zeros(1, dtype=torch.int64)
        dist.broadcast(size, src=src, group=self._host_group)
        if self.rank != src:
            data = torch.empty(int(size), dtype=torch.uint8)
        dist.broadcast(data, src=src, group=self._host_group)
        if self.rank == src:
            return obj
        return pickle.loads(data.numpy().tobytes())

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable host object, in rank order, on every rank
        (the host group, as :meth:`broadcast_object`)."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self._host_group)
        return out

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self._host_group)


def _axis_groups(shape: Dict[str, int], rank: int
                 ) -> Tuple[Dict[str, object], Dict[str, List[int]]]:
    """One process group per axis of size > 1. Every rank creates every
    group in the same order (``new_group`` is collective) and keeps the one
    holding it."""
    dims = tuple(shape.values())
    grid = np.arange(int(np.prod(dims))).reshape(dims)
    groups: Dict[str, object] = {}
    members: Dict[str, List[int]] = {}
    for i, axis in enumerate(shape):
        moved = np.moveaxis(grid, i, -1).reshape(-1, dims[i])
        for row in moved:
            ranks = [int(r) for r in row]
            group = dist.new_group(ranks=ranks) if dims[i] > 1 else None
            if rank in ranks:
                groups[axis], members[axis] = group, ranks
    return groups, members


def _rank_device(device, backend: str, rank: int, world: int) -> torch.device:
    """The rank's device: the caller's, else a CUDA card (ranks spread over
    the cards in rank order; several ranks share a card when the world
    exceeds them, which NCCL refuses)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        if not torch.cuda.is_available():
            raise TrackieError(
                ErrorCode.DEVICE_UNAVAILABLE,
                "no CUDA device: pass device='cpu' to build the mesh on the "
                "CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if backend == "nccl":
        if dev.type != "cuda":
            raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                               "nccl runs on CUDA devices only: use gloo on "
                               "the CPU")
        if world > torch.cuda.device_count():
            raise TrackieError(
                ErrorCode.INVALID_ARGUMENT,
                f"nccl puts one rank on a card: {world} ranks, "
                f"{torch.cuda.device_count()} cards (use gloo to share one)")
    return dev


def build_mesh(world: Optional[int] = None, tp: Optional[int] = None,
               max_tp: int = 4, ep: Optional[int] = None, *,
               backend: Optional[str] = None, device=None,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This rank's :class:`Mesh` over ``world`` ranks, factored as the JAX
    package's ``build_mesh`` factors ``world`` devices.

    ``backend`` ("gloo" or "nccl") must be given. When the default process
    group is not up yet it is started here from ``init_method`` (for
    example ``tcp://localhost:<port>``), ``rank`` and ``world``, with
    ``timeout_s`` on every collective: a rank that never enters one fails
    the others instead of hanging them. A world of one needs no process
    group. ``device``: the rank's device, a CUDA card by default;
    ``"cpu"`` for CPU ranks."""
    if backend not in BACKENDS:
        raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                           f"backend must be one of {BACKENDS}, got "
                           f"{backend!r}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise TrackieError(
                ErrorCode.INVALID_ARGUMENT,
                f"the process group runs {dist.get_backend()}, not {backend}")
        if world is not None and world != dist.get_world_size():
            raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                               f"world={world} but the process group has "
                               f"{dist.get_world_size()} ranks")
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = 1 if world is None else int(world)
        rank = 0 if rank is None else int(rank)
        if world > 1:
            if init_method is None:
                raise TrackieError(ErrorCode.INVALID_ARGUMENT,
                                   "init_method is needed to start a "
                                   f"{world}-rank process group")
            dev = _rank_device(device, backend, rank, world)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                backend, init_method=init_method, world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    dev = _rank_device(device, backend, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    shape = mesh_shape(world, tp=tp, max_tp=max_tp, ep=ep)
    if world == 1:
        return Mesh(shape, 0, backend, dev, {a: None for a in shape},
                    {a: [0] for a in shape})
    groups, members = _axis_groups(shape, rank)
    host = (dist.new_group(backend="gloo") if backend == "nccl"
            else dist.group.WORLD)
    return Mesh(shape, rank, backend, dev, groups, members, host_group=host)


def close_mesh(mesh: Mesh) -> None:
    """End this rank's process group (after every rank is done with it)."""
    if mesh.world > 1 and dist.is_initialized():
        dist.destroy_process_group()
