"""Client meshes over ``torch.distributed`` process groups, and the
runner that starts their processes: the PyTorch port of
``repro/launch/mesh.py`` for the sharded round (DESIGN.md §3, §14).

A ``ClientMesh`` names axes over the ranks of the default process
group, laid out rank-major in axis order (the last axis fastest), as
``jax.make_mesh`` lays out devices: on ``make_edge_mesh(E, K)`` rank
e·K + k is client shard k of edge e. For every set of axes the mesh
holds the process group of this rank's line along them: a collective
over ("data",) runs among the ranks of one edge, over ("edge",) among
the ranks at one intra-edge position, over ("edge", "data") among all.
The groups are made with ``dist.new_group``, every one on every rank in
the same order, as ``torch.distributed`` requires.

``spawn(world, fn, ...)`` runs ``fn(rank, device, *args)`` in ``world``
new processes (the ``spawn`` start method), each a rank of one process
group whose rendezvous is a ``FileStore`` in a temporary directory (no
port to collide on), and returns their results in rank order. The
backend and each rank's device are the caller's: nothing here picks or
switches them.

``make_production_mesh`` returns a ``MeshShape``: the axis names and
sizes of the TPU v5e pod layout that the reference plans its sharding
rules for, with no devices and no process group behind them. The
sharding rules (``launch/sharding.py``), the activation context
(``models/partitioning.py``) and the dry run (``launch/dryrun.py``) read
only a mesh's ``shape`` and ``axis_names``, so they take it as the
reference's take ``jax.make_mesh``'s mesh.
"""
from __future__ import annotations

import itertools
import math
import os
import pickle
import tempfile
import time
from collections import OrderedDict
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.kernels.backend import resolve_device


class ClientMesh:
    """Named axes over the ranks of the default process group, with the
    process group of this rank's line along every set of axes, and this
    rank's device."""

    def __init__(self, axes: Sequence[Tuple[str, int]], device=None):
        if not dist.is_initialized():
            raise RuntimeError("a ClientMesh needs an initialized default "
                               "process group (spawn, or "
                               "torch.distributed.init_process_group)")
        self.axis_names = tuple(name for name, _ in axes)
        self.shape = dict(axes)
        world, self.rank = dist.get_world_size(), dist.get_rank()
        if math.prod(self.shape.values()) != world:
            raise ValueError(f"mesh {self.shape} does not cover the "
                             f"{world} ranks of the process group")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = dist.get_backend()
        sizes = tuple(self.shape.values())
        coords = list(itertools.product(*(range(n) for n in sizes)))
        self.coords = dict(zip(self.axis_names, coords[self.rank]))
        self._groups: Dict[Tuple[str, ...], object] = {}
        for k in range(1, len(sizes) + 1):
            for sub in itertools.combinations(range(len(sizes)), k):
                names = tuple(self.axis_names[i] for i in sub)
                if math.prod(sizes[i] for i in sub) == world:
                    self._groups[names] = dist.group.WORLD
                    continue
                # one group per line: the ranks that share their
                # coordinates off the axes `sub`
                lines: Dict[tuple, list] = {}
                for r, c in enumerate(coords):
                    key = tuple(c[i] for i in range(len(sizes))
                                if i not in sub)
                    lines.setdefault(key, []).append(r)
                for ranks in lines.values():
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[names] = group

    def canonical(self, axes) -> Tuple[str, ...]:
        """``axes`` as a tuple of mesh axes in mesh order (raises
        otherwise)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if (not axes or set(axes) - set(self.axis_names)
                or sorted(axes, key=self.axis_names.index) != list(axes)):
            raise ValueError(f"axes {axes} are not mesh axes of "
                             f"{self.axis_names} in mesh order")
        return axes

    def group(self, axes):
        """The process group of this rank's line along ``axes``."""
        return self._groups[self.canonical(axes)]

    def size(self, axes) -> int:
        """Ranks along ``axes``."""
        return math.prod(self.shape[a] for a in self.canonical(axes))

    def index(self, axes) -> int:
        """This rank's place along ``axes`` (row-major in mesh order):
        the order in which an all-gather over them stacks the ranks."""
        i = 0
        for a in self.canonical(axes):
            i = i * self.shape[a] + self.coords[a]
        return i


class MeshShape:
    """A mesh's axis names and sizes, and nothing else: no devices, no
    process group. ``shape`` is an ordered dict, as a JAX mesh's is."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        if len(sizes) != len(axis_names):
            raise ValueError(f"{len(sizes)} sizes for axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, map(int, sizes)))

    def __repr__(self) -> str:
        return f"MeshShape({dict(self.shape)})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production layout, a TPU v5e pod of 16 x 16 = 256
    chips as (data, model), or two pods, 512 chips, with a leading
    ``pod`` axis. A description for the sharding rules and the dry run:
    no H100 machine has this mesh, and nothing runs on it."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh(data: Optional[int] = None, *, device=None) -> ClientMesh:
    """One ``"data"`` axis over the ranks of the process group (``data``,
    when given, must be their number)."""
    return ClientMesh((("data", data or dist.get_world_size()),), device)


def make_edge_mesh(num_edges: int, clients_per_edge: int, *,
                   device=None) -> ClientMesh:
    """The two-level federation mesh (DESIGN.md §14): a leading
    ``"edge"`` axis of E edge shards in front of the intra-edge client
    axis ``"data"``, edge-major. Hand ``client_axes=("edge", "data")``
    to ``make_sharded_round`` with ``HierarchyConfig(num_edges=E)``: the
    robust family's aggregate stage then gathers C/E rows within each
    edge and E candidate rows across the edges, and the linear family
    keeps its one all-reduce over both axes."""
    return ClientMesh((("edge", num_edges), ("data", clients_per_edge)),
                      device)


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch/client axes: ("pod", "data") on multi-pod, else
    ("data",)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def client_axes(mesh) -> Tuple[str, ...]:
    """The federated client axes in hop order: the outer axis first
    ("edge" on an edge mesh, "pod" multi-pod), then "data"."""
    return tuple(a for a in mesh.axis_names if a in ("edge", "pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]


def _rank_devices(world: int, device) -> list:
    """Each rank's device: ``cuda:<rank>`` when ``device`` is None, the
    one device given, or one of a sequence per rank; a CUDA device with
    no index is the current one (a rank sets its device by index). A
    CUDA device the machine lacks raises."""
    if device is None:
        devices = [torch.device("cuda", r) for r in range(world)]
    elif isinstance(device, (str, torch.device)):
        devices = [torch.device(device)] * world
    else:
        devices = [torch.device(d) for d in device]
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    for d in devices:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank device {d} is not on this machine "
                f"({torch.cuda.device_count()} CUDA devices)")
    return devices


def _rank_main(rank: int, world: int, backend: str, devices: list,
               tmp: str, timeout: float) -> None:
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend,
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout))
    result = fn(rank, device, *args)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(world: int, fn: Callable, *args, backend: str, device=None,
          timeout: float = 300.0, deadline: float = 900.0) -> list:
    """Run ``fn(rank, device, *args)`` on ``world`` new processes, each a
    rank of one process group of ``backend`` with ``timeout`` seconds
    for a collective, and return their results in rank order. ``fn``
    and ``args`` must pickle (a module-level function). ``device``: each
    rank's device (one for all, one per rank, or None: ``cuda:<rank>``).

    Raises ``torch.multiprocessing.ProcessException`` when a rank raises
    or dies (the other ranks are then stopped), and ``TimeoutError``
    when the ranks have not all finished ``deadline`` seconds after the
    start (they are then killed)."""
    devices = _rank_devices(world, device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        # the call goes through a file, not the start pipe: a process
        # that dies before it reads a large start message would block
        # the parent's write into the pipe for good
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(
            _rank_main, args=(world, backend, devices, tmp, timeout),
            nprocs=world, join=False, start_method="spawn")
        end = time.monotonic() + deadline
        try:
            while not ctx.join(timeout=max(end - time.monotonic(), 0.01)):
                if time.monotonic() >= end:
                    raise TimeoutError(f"spawn: the {world} ranks did not "
                                       f"finish within {deadline} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
