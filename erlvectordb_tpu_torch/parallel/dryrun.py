"""Multi-device dry run of the sharded path on logical CPU devices.

Counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py``: builds an ``n_devices`` (replica, data) mesh of
logical CPU devices and runs the whole sharded pipeline once at tiny
shapes, in both dtypes: scatter insert, the per-shard scan and candidate
merge with the batch split over the replica axis, delete, the exactness
check against a single-device store, the streaming bulk build and both
expert-parallel indexes.

    python -m erlvectordb_tpu_torch.parallel.dryrun [n_devices]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def dryrun_multichip(n_devices: int) -> None:
    """Run the sharded step over ``n_devices`` logical CPU devices; raises
    on a wrong answer."""
    from erlvectordb_tpu_torch.core.store import VectorStore
    from erlvectordb_tpu_torch.parallel.ep_cell_probe import EPCellProbeIndex
    from erlvectordb_tpu_torch.parallel.ep_ivf import EPIVFIndex
    from erlvectordb_tpu_torch.parallel.mesh import (
        cpu_device_count,
        cpu_devices,
        make_mesh,
        set_cpu_device_count,
    )
    from erlvectordb_tpu_torch.parallel.sharded_store import ShardedVectorStore

    held = cpu_device_count()
    set_cpu_device_count(n_devices)
    try:
        # the replica axis splits the query batch, the data axis the rows
        n_replica = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
        mesh = make_mesh(n_data=n_devices // n_replica, n_replica=n_replica,
                         devices=cpu_devices())
        rng = np.random.default_rng(0)
        d, n, b, k = 64, 512, 8, 4
        data = rng.standard_normal((n, d)).astype(np.float32)
        ids = [f"v{i}" for i in range(n)]

        for dtype in ("float32", "int8"):
            store = ShardedVectorStore(f"dry_{dtype}", mesh, metric="cosine",
                                       dtype=dtype)
            store.insert_batch(ids, data)
            queries = rng.standard_normal((b, d)).astype(np.float32)
            results = store.search_batch(queries, k=k)
            if not (len(results) == b and all(len(r) == k for r in results)):
                raise AssertionError(f"{dtype}: short results {results}")
            store.delete("v0")
            if store.search(data[0], k=1)[0][0] == "v0":
                raise AssertionError(f"{dtype}: a deleted row answered")

        # exactness against a single-device scan
        cpu = torch.device("cpu")
        ref = VectorStore("ref", device=cpu)
        ref.insert_batch(ids, data)
        sh = ShardedVectorStore("exact", mesh)
        sh.insert_batch(ids, data)
        q = data[3]
        got = [r[0] for r in sh.search(q, k=5)]
        want = [r[0] for r in ref.search(q, k=5)]
        if got != want:
            raise AssertionError(f"sharded {got} != single-device {want}")

        # streaming chunked bulk build into the shard buffers
        st = ShardedVectorStore.from_chunks("dry_stream", mesh,
                                            [data[:256], data[256:]], n=n,
                                            dim=d, dtype="int8")
        hit = st.search(data[7], k=1)
        if hit[0][0] != "7":
            raise AssertionError(f"streaming build: {hit[:1]}")

        # expert-parallel IVF: cells sharded over the data axis
        norms = np.linalg.norm(data, axis=1).astype(np.float32)
        ep = EPIVFIndex.build(data, np.arange(n, dtype=np.int32), norms, mesh,
                              n_cells=mesh.shape["data"] * 2, iters=4)
        _, rows = ep.search(data[:4], k=3, nprobe=2, metric="euclidean")
        if rows.shape != (4, 3):
            raise AssertionError(f"ep_ivf rows {rows.shape}")

        # expert-parallel cell probe: probing every cell makes the search
        # exhaustive, so the self row must win
        dp = np.pad(data, ((0, 0), (0, 128 - d % 128 if d % 128 else 0)))
        epc = EPCellProbeIndex.build(dp, np.arange(n, dtype=np.int64), mesh,
                                     cell_rows=24, cell_cap=32, iters=4)
        _, rows = epc.search(data[:4], k=3, nprobe=epc.n_cells, metric="cosine")
        if rows.shape != (4, 3) or rows[0][0] != 0:
            raise AssertionError(f"ep_cellprobe rows {rows}")
    finally:
        set_cpu_device_count(held)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) ok")
