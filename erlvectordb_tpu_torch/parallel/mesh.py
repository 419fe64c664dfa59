"""Device meshes — the "cluster" of the port.

Counterpart of ``erlvectordb_tpu/parallel/mesh.py``.  A mesh is a
``(replica, data)`` grid of *mesh devices*:

  * ``data``    — the rows of every store are sharded across this axis;
                  a per-shard local top-k and a merge of the candidates
                  give exact global results;
  * ``replica`` — full copies for availability and query throughput; the
                  query batch is split across the replica groups.

A mesh device is an id (its position in the device list the mesh or the
cluster was built from) and a ``torch.device``; ``fail_device`` and
``probe_devices`` speak of those ids, as the JAX package speaks of
``jax.Device.id``.  A ``torch.device`` may appear more than once in a list:
several logical shards on ``cpu`` are the counterpart of JAX's virtual CPU
devices, and ``cuda:0`` repeated runs several shards on one card.

``make_mesh()`` takes every visible card (``cuda:0 ... cuda:n-1``, never
repeated) and raises without one.  The logical CPU devices
(:func:`cpu_devices`) are there for callers that ask for the CPU; their
count is :func:`set_cpu_device_count`'s (default 1), the counterpart of
``jax_num_cpu_devices``.

Multi-process membership (``init_distributed``) is not ported: it waits for
ROADMAP Queue A item 3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
REPLICA_AXIS = "replica"

MULTI_PROCESS_NOT_PORTED = (
    "multi-process clusters are not ported to erlvectordb_tpu_torch yet "
    "(ROADMAP Queue A item 3, multi-process)")

_cpu_device_count = 1


@dataclass(frozen=True)
class MeshDevice:
    """One mesh position's device: ``id`` is its index in the device list,
    ``device`` the torch device it computes on."""

    id: int
    device: torch.device

    @property
    def platform(self) -> str:
        return self.device.type

    def __str__(self) -> str:
        return f"{self.device}#{self.id}"


class Mesh:
    """A named grid of mesh devices (``devices`` is an object ndarray).
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``
    does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-d grid needs "
                             f"{self.devices.ndim} axis names")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def set_cpu_device_count(n: int) -> None:
    """How many logical CPU devices :func:`cpu_devices` lists."""
    global _cpu_device_count
    if n < 1:
        raise ValueError("the CPU device count must be positive")
    _cpu_device_count = int(n)


def cpu_device_count() -> int:
    return _cpu_device_count


def cpu_devices() -> List[MeshDevice]:
    """The logical CPU devices: ids 0..n-1, all on ``cpu``."""
    cpu = torch.device("cpu")
    return [MeshDevice(i, cpu) for i in range(_cpu_device_count)]


def cuda_devices() -> List[MeshDevice]:
    """Every visible card, once each; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: erlvectordb_tpu_torch's meshes take every "
            "visible card unless the caller names the devices "
            "(devices=cpu_devices())")
    return [MeshDevice(i, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def devices_of_kind(device) -> List[MeshDevice]:
    """The mesh devices a Database on ``device`` builds its meshes from:
    every card for a CUDA device, the logical CPU devices for the CPU."""
    return cpu_devices() if torch.device(device).type == "cpu" else cuda_devices()


def as_mesh_devices(devices: Sequence) -> List[MeshDevice]:
    """Mesh devices from a list of mesh devices, torch devices or device
    strings; a plain device takes its position in the list as its id."""
    return [d if isinstance(d, MeshDevice) else MeshDevice(i, torch.device(d))
            for i, d in enumerate(devices)]


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Joining a multi-process group waits for ROADMAP Queue A item 3."""
    raise NotImplementedError(MULTI_PROCESS_NOT_PORTED)


def make_mesh(n_data: Optional[int] = None, n_replica: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (replica, data) mesh.  Defaults: every visible card, one replica
    group.  ``n_replica`` is the ``replication_factor`` analogue."""
    devices = as_mesh_devices(devices) if devices is not None else cuda_devices()
    if n_data is None:
        if len(devices) % n_replica:
            raise ValueError(
                f"{len(devices)} devices not divisible by n_replica={n_replica}")
        n_data = len(devices) // n_replica
    need = n_data * n_replica
    if need > len(devices):
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty((n_replica, n_data), dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i // n_data, i % n_data] = d
    return Mesh(grid, (REPLICA_AXIS, DATA_AXIS))


def single_device_mesh(device=None) -> Mesh:
    """A 1 x 1 mesh of ``device`` (default: the first card)."""
    d = as_mesh_devices([device])[0] if device is not None else cuda_devices()[0]
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = d
    return Mesh(grid, (REPLICA_AXIS, DATA_AXIS))


def mesh_shape(mesh: Mesh) -> dict:
    return {
        "replica": mesh.shape[REPLICA_AXIS],
        "data": mesh.shape[DATA_AXIS],
        "devices": int(np.prod(list(mesh.shape.values()))),
    }
