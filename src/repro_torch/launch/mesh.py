"""Meshes, port of ``repro/launch/mesh.py`` (:20-60): the LM zoo's SPMD
meshes (``make_production_mesh``, ``make_test_mesh``) and the CAPSim
inference engine's data mesh (``make_data_mesh``), with
``mesh_axis_sizes`` and ``num_chips`` for both.

A ``Mesh`` is the zoo's: named axes over the ranks of the default
``torch.distributed`` process group, one process (one device) a rank,
built on ``torch.distributed.device_mesh.init_device_mesh``.  Each
named axis has its process group (the device mesh's), and each tuple of
two or more axes one group whose group ranks are the row-major combined
coordinate over those axes, as ``_flash_decode_local`` numbers its
shards (``repro/models/attention.py:166-168``).  Collectives over the
groups are ``distributed/collectives.py``.  A mesh of one device needs
no process group: without one it is a local mesh whose collectives are
all of size 1 (and skipped).  A mesh whose size differs from the
group's raises and says how many ranks it needs.  Rendezvous is the
caller's (``init_process_group`` with a free port or a ``file://``
store; ``launch/train.py`` reads ``torchrun``'s environment).

A ``DataMesh`` is a 1-D "data" axis of shards: a tuple of
``torch.device``s and one CUDA stream per shard (``None`` on the CPU).
``EngineConfig.mesh_shape = (n,)`` splits every predict dispatch and every
RT-cache encode pass of the engine over n shards
(``predictor.sharded_*``): the parameters, the RT table and the serving
plan are copied once to each distinct device, and each shard runs its
rows on its own device and stream (``shard``), ordered after its
device's current stream and joined back into it after (``join``).

- On ``cuda`` the n shards are n distinct cards, ``cuda:k..k+n-1`` from
  the index asked for (0 by default); fewer visible cards raise.
- On ``cpu`` the n shards share the one CPU, as the reference reaches n
  host devices with ``XLA_FLAGS=--xla_force_host_platform_device_count``.
- Several shards on one card, each on its own stream, only when asked:
  ``make_data_mesh(n, "cuda:0", on_one_device=True)``.  The engine never
  builds such a mesh by itself; a caller passes it in (``mesh=``).

"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

AXIS = "data"


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """n shards: ``devices[i]`` and ``streams[i]`` (None on the CPU)."""

    devices: Tuple[torch.device, ...]
    streams: Tuple[Optional["torch.cuda.Stream"], ...]
    axis_names: Tuple[str, ...] = (AXIS,)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """Each device once, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    @contextlib.contextmanager
    def shard(self, i: int):
        """Run the body on shard i's device and stream.  The shard's
        stream first waits on its device's current stream, so everything
        enqueued there before (the RT table's writes, the plan) is
        ordered before the shard's work."""
        stream = self.streams[i]
        if stream is None:
            yield
            return
        dev = self.devices[i]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            yield

    def join(self) -> None:
        """Each device's current stream waits on its shards' streams, so
        the shards' outputs are used, and what they read is freed or
        rewritten, in stream order after them."""
        for dev, stream in zip(self.devices, self.streams):
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)

    def replicate(self, tree):
        """One copy of a tensor tree per shard: shards on the tree's own
        device share it, every other distinct device gets one copy."""
        # deferred import: core.engine imports this module
        from repro_torch.core.engine import params_to_device
        copies: Dict[torch.device, object] = {}

        def on(dev):
            if dev not in copies:
                copies[dev] = params_to_device(tree, dev)
            return copies[dev]
        return tuple(on(d) for d in self.devices)

    def synchronize(self) -> None:
        """Wait for every shard's work on every device of the mesh."""
        for dev in self.distinct_devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


def make_data_mesh(n_shards: int, device: DeviceLike = "cuda", *,
                   on_one_device: bool = False) -> DataMesh:
    """1-D data mesh of ``n_shards`` shards (``EngineConfig.mesh_shape``).

    ``device`` ``cuda`` (or ``cuda:k``): shards on ``cuda:k..k+n-1``,
    raising when fewer cards are visible; ``cpu``: n shards on the CPU.
    ``on_one_device=True`` puts every shard on the one card ``device``
    names, each on a stream of its own."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return DataMesh((dev,) * n_shards, (None,) * n_shards)
    first = dev.index if dev.index is not None else 0
    if on_one_device:
        devices = (torch.device("cuda", first),) * n_shards
    else:
        have = torch.cuda.device_count()
        if first + n_shards > have:
            raise ValueError(
                f"mesh of {n_shards} devices from cuda:{first} requested "
                f"but only {have} visible; several shards on one card "
                "must be asked for (make_data_mesh(n, 'cuda:0', "
                "on_one_device=True))")
        devices = tuple(torch.device("cuda", first + i)
                        for i in range(n_shards))
    streams = tuple(torch.cuda.Stream(device=d) for d in devices)
    return DataMesh(devices, streams)


def resolve_mesh(n_shards: int, device: DeviceLike,
                 mesh: Optional[DataMesh] = None) -> Optional[DataMesh]:
    """The mesh an engine runs on: ``mesh`` when the caller passed one
    (its size must be ``n_shards``), else ``make_data_mesh(n_shards,
    device)``; None when ``n_shards`` is 0 (the unsharded path)."""
    if mesh is not None:
        if mesh.n_shards != n_shards:
            raise ValueError(
                f"mesh of {mesh.n_shards} shards passed with a config of "
                f"mesh_shape size {n_shards}")
        return mesh
    if not n_shards:
        return None
    return make_data_mesh(n_shards, device)


# --------------------------------------------------------------------------- #
# The LM zoo's SPMD mesh
# --------------------------------------------------------------------------- #

Axes = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes of ``shape`` over the process group's ranks (row-major:
    rank r sits at ``coords``, r's unravelled index).  ``device`` is this
    rank's; ``groups`` maps each tuple of axes (in mesh order) to its
    process group, and is empty on a local mesh of one device."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    coords: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], object]
    device_mesh: Optional[object] = None

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} not in mesh axes "
                                 f"{self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes: Axes) -> int:
        """Total size of ``axes`` (1 for none)."""
        sizes = dict(zip(self.axis_names, self.shape))
        return math.prod(sizes[a] for a in self._axes(axes))

    def index(self, axes: Axes) -> int:
        """This rank's row-major combined coordinate over ``axes``."""
        where = dict(zip(self.axis_names, zip(self.coords, self.shape)))
        i = 0
        for a in self._axes(axes):
            c, n = where[a]
            i = i * n + c
        return i

    def group(self, axes: Axes):
        """The process group of ``axes``; None where their size is 1."""
        axes = self._axes(axes)
        if self.size(axes) == 1:
            return None
        return self.groups[axes]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: DeviceLike = "cuda") -> Mesh:
    """A ``Mesh`` of ``shape`` named ``axis_names`` over the default
    process group, which must hold exactly prod(shape) ranks (none is
    needed for one device).  ``device`` ``cuda``: rank r on
    ``cuda:(r % cards)``; ``cpu``: every rank on the CPU (gloo)."""
    import torch.distributed as dist
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axes {axis_names} differ "
                         "in length")
    n = math.prod(shape)
    dev = resolve_device(device)
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if n != world or (n > 1 and not initialized):
        raise ValueError(
            f"a mesh of shape {shape} needs {n} ranks, but the process "
            f"group has {world if initialized else 'none (not initialized)'}"
            f"; start {n} processes (e.g. torchrun --nproc-per-node {n}) "
            "and init_process_group before building it")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (dist.get_rank() if initialized else 0)
                           % torch.cuda.device_count())
    if not initialized:
        return Mesh(shape, axis_names, dev, (0,) * len(shape), {})
    from torch.distributed.device_mesh import init_device_mesh
    rank = dist.get_rank()
    coords = []
    for size in reversed(shape):
        coords.append(rank % size)
        rank //= size
    coords = tuple(reversed(coords))
    dmesh = init_device_mesh(dev.type, shape, mesh_dim_names=axis_names)
    groups = {(a,): dmesh.get_group(a) for a in axis_names}
    ranks = torch.arange(n).reshape(shape)
    # every rank creates every multi-axis group, in one order
    for k in range(2, len(shape) + 1):
        for axes in itertools.combinations(range(len(shape)), k):
            rest = [d for d in range(len(shape)) if d not in axes]
            grid = ranks.permute(*rest, *axes).reshape(-1, math.prod(
                shape[d] for d in axes))
            for members in grid.tolist():
                g = dist.new_group(members)
                if dist.get_rank() in members:
                    groups[tuple(axis_names[d] for d in axes)] = g
    return Mesh(shape, axis_names, dev, coords, groups, dmesh)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda") -> Mesh:
    """Single pod: (16, 16) = 256 devices (data, model).  Multi-pod:
    (2, 16, 16) = 512 (pod, data, model)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), ("data", "model"), device)


def make_test_mesh(device: DeviceLike = "cuda") -> Mesh:
    """1-device mesh with the standard axis names (the reference's CPU
    tests, and its launchers on one process)."""
    return make_mesh((1, 1), ("data", "model"), device)


def mesh_axis_sizes(mesh) -> dict:
    if isinstance(mesh, Mesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return {mesh.axis_names[0]: mesh.n_shards}


def num_chips(mesh) -> int:
    """Devices under the mesh: a ``Mesh``'s ranks; a ``DataMesh``'s
    distinct devices (shards on one card count once)."""
    if isinstance(mesh, Mesh):
        return math.prod(mesh.shape)
    return len(mesh.distinct_devices)
