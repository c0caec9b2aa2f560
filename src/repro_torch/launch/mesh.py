"""Mesh construction for the port — the counterpart of the JAX package's
`launch/mesh.py`, over the ranks of a `torch.distributed` process group.

The reference's mesh is a `jax.sharding.Mesh`: one controller places
arrays on its devices and XLA inserts the collectives.  The port runs one
process per device of the mesh (a rank), each the same program on its own
shard, and a `Mesh` here is one rank's view: the axes' sizes, this rank's
coordinate on each axis, and a process group per axis through which the
rank talks to the ranks that share its other coordinates.  Ranks are laid
out row-major over the shape, as `jax.make_mesh` lays out devices, so on
a (data, model) mesh rank ``d * tp + m`` holds model shard ``m`` of
replica ``d``.

`make_production_mesh` is a FUNCTION: importing this module touches no
process group.  Without an initialised group the world is this one
process, so only a one-device shape such as (1, 1) builds there, and a
larger explicit shape raises the reference's explicit-shape error.
``multi_pod=True`` prepends a ``pod`` axis of 2, as the reference's does;
the data axes are then ``("pod", "data")`` and a rank also gets one group
over both of them (`Mesh.groups[("pod", "data")]`).

`fake_world` joins this process to a world of any size through
torch's ``fake`` backend, whose collectives move nothing: the dry run
(`launch.dryrun`) builds rank 0's (or any rank's) mesh of a 16 x 16 pod or
of two pods there, with every group a real mesh has, and traces the
rank's step on fake tensors.

`spawn_ranks` starts the ranks of a run itself (`torch.multiprocessing`,
one fresh interpreter per rank, a free local port); `init_rank` also
joins ranks started by ``torchrun``.  The collective backend follows from
the layout (`collective_backend`): NCCL when every rank has a card of its
own, gloo when ranks share a card or run on the CPU (NCCL refuses two
ranks on one device).  Rank ``r`` runs on ``cuda:(r % device_count)``, or
on the CPU when asked.
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import math
import os
import socket
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails the run instead of
# hanging it (a rank that died leaves its peers waiting)
COLLECTIVE_TIMEOUT_S = 600.0


def factor_devices(n: int) -> Tuple[int, int]:
    """Factor n into (data, model) with model the largest divisor of n
    that does not exceed sqrt(n) — so data >= model and data*model == n
    (n=8 -> (4, 2), n=256 -> (16, 16), a prime n -> (n, 1))."""
    model = 1
    for d in range(1, int(n**0.5) + 1):
        if n % d == 0:
            model = d
    return n // model, model


def data_axes(mesh) -> tuple:
    """The axes batch-like dimensions shard over ('pod' included if present)."""
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)


def axis_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


class Mesh:
    """One rank's view of a device mesh.

    ``shape`` maps each axis name to its size, in axis order (the
    reference's ``mesh.shape``); ``coords`` maps it to this rank's
    coordinate.  ``groups[axis]`` is the process group of the ranks that
    differ from this one only along ``axis`` (None where the axis has one
    rank: nothing to talk to).  ``backend`` is the groups' collective
    backend and ``device`` the rank's device (None for a mesh built
    outside a launched run).  With ``check`` on, `sharding.ctx.check`
    compares a digest of every host decision the ranks must agree on and
    records it in ``log``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], rank: int = 0,
                 groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None, device=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = int(rank)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, tuple(shape)))))
        self.groups = dict(groups or {})
        self.backend = backend
        self.device = device
        self.check = False
        self.log: List[tuple] = []

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_ranks(self, axis) -> List[int]:
        """Global ranks of this rank's group along `axis` (a name, or a
        tuple of names: the ranks that differ from this one only along
        them), by their block index over those axes, counted in mesh order
        with the last axis fastest (the first is the group's deciding
        rank)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        names = self.axis_names
        dims = tuple(self.shape[a] for a in names)
        free = [a for a in names if a in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[a]) for a in free)):
            at = dict(zip(free, fixed))
            idx = tuple(at.get(a, self.coords[a]) for a in names)
            out.append(int(np.ravel_multi_index(idx, dims)))
        return out

    def info(self) -> dict:
        """What a run reports of its mesh (`launch.serve`'s ``mesh``)."""
        return {"tp": self.shape["model"],
                "dp": self.size // self.shape["model"],
                "shape": list(self.shape.values()), "axis_names": list(self.axis_names),
                "backend": self.backend}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend!r})"


# process groups cannot be created twice over the same ranks for free (every
# rank must take part in each creation), so a process builds each mesh once
_BUILT: Dict[tuple, Mesh] = {}


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, shape: Optional[Sequence[int]] = None,
                         axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """This rank's `Mesh` over the initialised process group (the world is
    this one process when none is initialised).  Without `shape` the
    world is factored into (data, model) (`factor_devices`), with
    `multi_pod` into (2, data, model) over ("pod", "data", "model").  An
    explicit shape must cover exactly the world's ranks."""
    n_avail = _world()
    if shape is None:
        if multi_pod:
            if n_avail % 2:
                raise RuntimeError(f"multi-pod mesh needs an even device count to split "
                                   f"across 2 pods, found {n_avail}")
            shape = (2,) + factor_devices(n_avail // 2)
        else:
            shape = factor_devices(n_avail)
    shape = tuple(int(s) for s in shape)
    if axis_names is None:
        axis_names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    axis_names = tuple(axis_names)
    if len(axis_names) != len(shape):
        raise ValueError(f"mesh shape {shape} has {len(shape)} dims but axis_names="
                         f"{axis_names} has {len(axis_names)}")
    n = math.prod(shape)
    if n_avail < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {n_avail}; start {n} ranks "
            f"(launch.serve spawns them for --config mesh.tp=..., or run it under "
            f"torchrun --nproc-per-node {n})")
    if n_avail > n:
        raise RuntimeError(f"mesh {shape} covers {n} devices but the process group has "
                           f"{n_avail} ranks: give every rank a place on the mesh")
    rank = dist.get_rank() if dist.is_initialized() else 0
    key = (shape, axis_names, n_avail, rank)
    if key in _BUILT:
        return _BUILT[key]
    mesh = Mesh(shape, axis_names, rank=rank,
                backend=dist.get_backend() if dist.is_initialized() else None)
    if n > 1:
        # every rank takes part in creating every group, in one order: one
        # per axis, and on a pod mesh one over both data axes
        keys = list(axis_names)
        if "pod" in axis_names:
            keys.append(data_axes(mesh))
        for key_axes in keys:
            free = (key_axes,) if isinstance(key_axes, str) else key_axes
            others = [a for a in axis_names if a not in free]
            for fixed in itertools.product(*(range(mesh.shape[a]) for a in others)):
                at = Mesh(shape, axis_names, rank=int(np.ravel_multi_index(
                    tuple(fixed[others.index(a)] if a in others else 0
                          for a in axis_names), shape)))
                ranks = at.axis_ranks(free)
                group = dist.new_group(ranks) if len(ranks) > 1 else None
                if mesh.rank in ranks:
                    mesh.groups[key_axes] = group
    _BUILT[key] = mesh
    return mesh


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as rank `rank` of a `world`-rank process group on
    torch's ``fake`` backend (collectives complete at once and move
    nothing) while the block runs; the group and every mesh built over it
    are dropped on exit.  Meshes are built inside with
    `make_production_mesh`."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a fake world needs a process with no process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
        for k in [k for k in _BUILT if k[2] == world]:
            del _BUILT[k]


# ------------------------------------------------------------ launching ranks
def collective_backend(world: int, device_type: str) -> str:
    """NCCL when each of `world` ranks has a card of its own; gloo when
    ranks share a card (NCCL refuses two ranks on one device) or run on
    the CPU."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank `rank`'s device: ``cuda:(rank % device_count)``, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank} needs a CUDA device and this process sees none "
                           "(run with --device cpu on a machine without one)")
    return torch.device("cuda", rank % torch.cuda.device_count())


def under_torchrun() -> bool:
    """Was this process started by ``torchrun`` (its rank in the env)?"""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_rank(rank: int, world: int, device_type: str,
              init_method: str = "env://") -> Tuple[str, torch.device]:
    """Join rank `rank` of `world` to the default process group and bind
    its device.  -> (collective backend, device)."""
    backend = collective_backend(world, device_type)
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return backend, device


def free_port() -> int:
    """A free TCP port on this host's loopback."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, device_type: str,
               queue, args: tuple) -> None:
    if device_type == "cpu":
        # the ranks share the host's cores (torchrun gives each one thread)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    backend, device = init_rank(rank, world, device_type,
                                init_method=f"tcp://127.0.0.1:{port}")
    try:
        out = fn(rank, world, backend, device, *args)
        queue.put((rank, out))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, device_type: str, args: tuple = ()) -> list:
    """Run ``fn(rank, world, backend, device, *args)`` in `world` fresh
    processes, the ranks of one process group on a free local port.  ->
    the ranks' return values, in rank order.  A rank that raises fails the
    run: the others are terminated and its error is raised here.  `fn`
    and `args` travel by pickle (`fn` by its import path).  The ranks get
    one hash seed, so every set and dict of strings iterates alike in all
    of them."""
    mp = torch.multiprocessing
    queue = mp.get_context("spawn").SimpleQueue()
    seed = os.environ.get("PYTHONHASHSEED")
    os.environ["PYTHONHASHSEED"] = seed or "0"
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, world, free_port(), device_type,
                                                   queue, args),
                                 nprocs=world, join=False, start_method="spawn")
    finally:
        if seed is None:
            del os.environ["PYTHONHASHSEED"]
    out: Dict[int, object] = {}

    def drain():
        while not queue.empty():
            rank, value = queue.get()
            out[rank] = value
    # drain while joining: a rank blocked on a full pipe never exits
    while not ctx.join(timeout=0.05):
        drain()
    drain()
    missing = sorted(set(range(world)) - set(out))
    if missing:
        raise RuntimeError(f"ranks {missing} exited without a result")
    return [out[r] for r in range(world)]
