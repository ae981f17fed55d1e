"""The CAPSim inference engine's data mesh (port of
``repro/launch/mesh.py``'s ``make_data_mesh``, ``mesh_axis_sizes`` and
``num_chips``).

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

The LM zoo's meshes (``make_production_mesh``, ``make_test_mesh``) and
its SPMD collectives are ROADMAP item 6b, with ``torch.distributed``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

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


def mesh_axis_sizes(mesh: DataMesh) -> dict:
    return {mesh.axis_names[0]: mesh.n_shards}


def num_chips(mesh: DataMesh) -> int:
    """Distinct devices under the mesh (shards on one card count once)."""
    return len(mesh.distinct_devices)
