"""Store builder ``sharded``: the configuration's store as a user's
distributed store, a ``ShardedVectorStore`` on the mesh of the
Application's own cluster (``Database.cluster``), streamed from the drawn
corpus by ``ShardedVectorStore.from_chunks`` in chunks of the
configuration's ``store.chunk`` rows and registered with the cluster
(``ClusterManager.distribute_store``), as
``Database.create_distributed_store`` registers one; the frontends reach it
through ``Database.any_store``'s cluster route.  The build raises unless
the cluster's mesh is the configuration's ``mesh`` (replica groups x
shards) on the run's device, so that another layout is never measured
under this configuration's name.  Warmed by a search of each of the
traffic's batch sizes, the first of which fills the store's id table."""

from __future__ import annotations

import numpy as np
import torch


def check_mesh(mesh, config: dict, device) -> None:
    from erlvectordb_tpu_torch.parallel.mesh import DATA_AXIS, REPLICA_AXIS

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    shape = (mesh.shape[REPLICA_AXIS], mesh.shape[DATA_AXIS])
    on = sorted({str(d.device) for d in mesh.devices.flat})
    want = config["mesh"]
    if shape != (want["replicas"], want["shards"]) or on != [str(device)]:
        raise RuntimeError(
            f"the cluster's mesh is {shape[0]} replica group(s) x {shape[1]} "
            f"shard(s) on {on}; {config['name']} is deployed as "
            f"{want['replicas']} x {want['shards']} on {device}")


def build(app, config: dict, data, device):
    from erlvectordb_tpu_torch.parallel.sharded_store import ShardedVectorStore

    cluster = app.db.cluster
    check_mesh(cluster.mesh, config, device)
    st = config["store"]
    n, chunk = int(data.shape[0]), int(st["chunk"])
    store = ShardedVectorStore.from_chunks(
        config["name"], cluster.mesh,
        (data[r0:r0 + chunk] for r0 in range(0, n, chunk)), n,
        int(config["dim"]), metric=config["metric"], dtype=st["dtype"])
    cluster.distribute_store(store)
    return store


def warm(store, config: dict, traffic: dict) -> None:
    rng = np.random.default_rng(0)
    for b in traffic["warm_batches"]:
        q = rng.standard_normal((int(b), int(config["dim"])), np.float32)
        store.search_batch_complete_raw(
            store.search_batch_submit(q, k=config["k"]))
