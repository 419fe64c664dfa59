"""Cluster manager — placement, health and replica failover on a device mesh.

Counterpart of ``erlvectordb_tpu/parallel/cluster.py``:

  reference                         port
  ---------                         ----
  distributed-Erlang node           a mesh device (an id and a torch device)
  replication_factor node copies    the mesh's replica axis
  distribute_store (rpc start)      ShardedVectorStore on the mesh
  per-vector rpc migration          bulk re-insertion (from_store)
  nodedown -> log + prune           fail_device -> rebuild the mesh WITHOUT
                                    the dead replica group and reshard every
                                    store onto it
  heartbeats                        an on-demand per-device liveness probe
                                    (a tiny computation on each device)

One process holds the whole cluster.  Multi-process membership
(``join_cluster``) waits for ROADMAP Queue A item 3.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from erlvectordb_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MULTI_PROCESS_NOT_PORTED,
    REPLICA_AXIS,
    Mesh,
    MeshDevice,
    as_mesh_devices,
    cuda_devices,
)
from erlvectordb_tpu_torch.parallel.sharded_store import ShardedVectorStore


class ClusterError(RuntimeError):
    pass


class ClusterManager:
    """Single-controller cluster state: mesh, placements and health.
    ``devices`` default to every visible card; a CPU cluster names its
    devices (``devices=cpu_devices()``)."""

    def __init__(self, devices: Optional[Sequence] = None,
                 replication_factor: int = 1, n_data: Optional[int] = None):
        self._all_devices: List[MeshDevice] = (
            as_mesh_devices(devices) if devices is not None else cuda_devices())
        self.replication_factor = replication_factor
        if n_data is None:
            n_data = len(self._all_devices) // replication_factor
        if n_data < 1:
            raise ClusterError(
                f"replication_factor {replication_factor} exceeds the "
                f"{len(self._all_devices)} available device(s): no complete "
                "replica group can form")
        self.n_data = n_data
        self._failed: set = set()  # ids of devices marked dead
        self._stores: Dict[str, ShardedVectorStore] = {}
        self._lock = threading.RLock()
        self._state_version = 0
        self._mesh = self._build_mesh()

    # ------------------------------------------------------------- topology

    def _healthy_devices(self) -> List[MeshDevice]:
        return [d for d in self._all_devices if d.id not in self._failed]

    def _build_mesh(self) -> Mesh:
        """Mesh of (healthy replica groups) x n_data.  A replica group is a
        contiguous run of ``n_data`` devices; a failed member poisons its
        whole group (its shards are incomplete)."""
        groups = []
        for i in range(0, len(self._all_devices) - self.n_data + 1, self.n_data):
            row = self._all_devices[i:i + self.n_data]
            if all(d.id not in self._failed for d in row):
                groups.append(row)
        if not groups:
            raise ClusterError("no complete replica group of healthy devices remains")
        grid = np.empty((len(groups), self.n_data), dtype=object)
        for r, row in enumerate(groups):
            for s, d in enumerate(row):
                grid[r, s] = d
        return Mesh(grid, (REPLICA_AXIS, DATA_AXIS))

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    # --------------------------------------------------- membership analogue

    def join_cluster(self, coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> dict:
        """Joining a multi-process group waits for ROADMAP Queue A item 3."""
        raise NotImplementedError(MULTI_PROCESS_NOT_PORTED)

    def leave_cluster(self) -> dict:
        """Collapse every store onto this process's own devices (in one
        process: all of them) with every device healthy again; stores are
        rebuilt by bulk copy, since the data-axis size may change."""
        with self._lock:
            self.n_data = max(1, len(self._all_devices)
                              // max(self.replication_factor, 1))
            self._failed.clear()
            old_stores = dict(self._stores)
            self._mesh = self._build_mesh()
            for name, sh in old_stores.items():
                self._stores[name] = ShardedVectorStore.from_store(
                    sh, self._mesh, name)
            self._state_version += 1
        return self.get_cluster_stats()

    # ------------------------------------------------------------- placement

    def distribute_store(self, store, name: Optional[str] = None
                         ) -> ShardedVectorStore:
        """Place a store onto the mesh: a ShardedVectorStore on this mesh
        as it is, any other store (or one on another mesh) by migrating its
        rows, a name as a new empty store."""
        with self._lock:
            if isinstance(store, ShardedVectorStore):
                sharded = store
                if sharded.mesh is not self._mesh:
                    sharded = ShardedVectorStore.from_store(store, self._mesh, name)
            elif isinstance(store, str):
                sharded = ShardedVectorStore(store, self._mesh)
            else:
                sharded = ShardedVectorStore.from_store(store, self._mesh, name)
            self._stores[sharded.name] = sharded
            self._state_version += 1
            return sharded

    def undistribute_store(self, name: str) -> bool:
        with self._lock:
            hit = self._stores.pop(name, None) is not None
            if hit:
                self._state_version += 1
            return hit

    def get_store(self, name: str) -> Optional[ShardedVectorStore]:
        return self._stores.get(name)

    def get_store_location(self, name: str) -> Optional[dict]:
        """Which devices hold each shard."""
        sh = self._stores.get(name)
        if sh is None:
            return None
        devs = self._mesh.devices
        return {
            "store": name,
            "shards": sh.n_shards,
            "replicas": sh.n_replicas,
            "placement": {
                f"shard_{s}": [str(devs[r, s]) for r in range(sh.n_replicas)]
                for s in range(sh.n_shards)
            },
        }

    def get_store_distribution(self) -> Dict[str, dict]:
        return {name: self.get_store_location(name) for name in self._stores}

    # ---------------------------------------------------------------- health

    def get_cluster_nodes(self) -> List[str]:
        return [str(d) for d in self._healthy_devices()]

    def get_node_status(self) -> List[dict]:
        return [{"device": str(d), "id": d.id, "platform": d.platform,
                 "process_index": 0, "healthy": d.id not in self._failed}
                for d in self._all_devices]

    def probe_devices(self) -> Dict[int, bool]:
        """Liveness probe: a tiny computation on every device."""
        results: Dict[int, bool] = {}
        for d in self._all_devices:
            try:
                x = torch.ones((8,), dtype=torch.float32, device=d.device)
                results[d.id] = bool(abs(float(x.sum()) - 8.0) < 1e-6)
            except RuntimeError:
                results[d.id] = False
        return results

    # ---------------------------------------------------------- failover

    def fail_device(self, device_id: int) -> dict:
        """Mark a device dead and re-protect: rebuild the mesh without its
        replica group and reshard every store onto the survivors."""
        with self._lock:
            if device_id not in {d.id for d in self._all_devices}:
                raise ClusterError(f"unknown device id {device_id}")
            self._failed.add(device_id)
            self._mesh = self._build_mesh()
            self._resync_stores()
            self._state_version += 1
            return self.get_cluster_stats()

    def recover_device(self, device_id: int) -> dict:
        with self._lock:
            self._failed.discard(device_id)
            self._mesh = self._build_mesh()
            self._resync_stores()
            self._state_version += 1
            return self.get_cluster_stats()

    def _resync_stores(self) -> None:
        for sh in list(self._stores.values()):
            if sh.n_shards == self._mesh.shape[DATA_AXIS]:
                sh.reshard_to(self._mesh)
            else:  # the topology changed shape: bulk re-distribute
                self._stores[sh.name] = ShardedVectorStore.from_store(
                    sh, self._mesh, sh.name)

    # ------------------------------------------------------------------ sync

    def sync_cluster_state(self) -> dict:
        """Single-controller state is consistent by construction; returns
        the current version."""
        return {"state_version": self._state_version, "stores": sorted(self._stores)}

    def get_cluster_stats(self) -> dict:
        healthy = self._healthy_devices()
        return {
            "total_devices": len(self._all_devices),
            "healthy_devices": len(healthy),
            "failed_devices": sorted(self._failed),
            "replica_groups": self._mesh.shape[REPLICA_AXIS],
            "data_shards": self._mesh.shape[DATA_AXIS],
            "replication_factor": self.replication_factor,
            "stores": {n: s.count for n, s in self._stores.items()},
            "state_version": self._state_version,
            "timestamp": time.time(),
        }
