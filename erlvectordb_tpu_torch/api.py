"""Public API facade — the verbs of the JAX package's ``Database``.

One :class:`Database` wires the store registry, persistence (snapshots,
deltas and index artifacts under ``persistence_dir``), backup, compression,
the OAuth server, the query batcher and the index manager together on one
``torch.device``; the MCP server calls through it.  ``start()`` reloads the
persisted stores and indexes onto that device and starts the sync loop;
``stop()`` syncs and saves the indexes.  The cluster layer (distributed and
dim-sharded stores over the devices of the Database's kind) is ported, except
multi-process membership (``join_cluster``).
"""

from __future__ import annotations

import logging
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple

import torch

from erlvectordb_tpu_torch.core.index_manager import IndexManager
from erlvectordb_tpu_torch.core.registry import (
    StoreExists,
    StoreNotFound,
    StoreRegistry,
)
from erlvectordb_tpu_torch.core.store import VectorStore, default_device
from erlvectordb_tpu_torch.infra.config import Config, load_config
from erlvectordb_tpu_torch.parallel.mesh import devices_of_kind
from erlvectordb_tpu_torch.persist import backup as backup_mod
from erlvectordb_tpu_torch.persist.snapshot import (
    PersistenceManager,
    get_store_info,
    list_persisted,
)
from erlvectordb_tpu_torch.quant import compression as compression_mod
from erlvectordb_tpu_torch.serve.batcher import QueryBatcher
from erlvectordb_tpu_torch.serve.oauth import OAuthServer
from erlvectordb_tpu_torch.utils.metrics import metrics

LOG = logging.getLogger(__name__)


class Database:
    """A running erlvectordb instance on one device: the CUDA card unless
    the caller names another (``device="cpu"``)."""

    def __init__(self, config: Optional[Config] = None,
                 device: Optional[torch.device] = None):
        self.config = config or load_config()
        self.device = torch.device(device) if device is not None else default_device()
        self.registry = StoreRegistry(self.device)
        self.persistence: Optional[PersistenceManager] = None
        if self.config.persistence_enabled:
            self.persistence = PersistenceManager(
                self.config.persistence_dir,
                sync_interval=self.config.sync_interval,
                compression=(self.config.compression_algorithm
                             if self.config.compression_enabled else None),
                device=self.device)
            # maintenance tick: staleness-driven cell refits and the
            # persistence of lazily computed calibration curves
            self.persistence.maintenance_cb = self._maintenance_tick
        self.oauth = OAuthServer(
            enabled=self.config.oauth_enabled,
            access_lifetime=self.config.access_token_lifetime,
            refresh_lifetime=self.config.refresh_token_lifetime,
            default_client=(
                self.config.default_client_id,
                self.config.default_client_secret,
                ["read", "write", "admin"],
            ),
        )
        self.indexes = IndexManager(self.registry)
        self.batcher = QueryBatcher(self.any_store)
        self._cluster = None  # lazy: the ClusterManager over this kind's devices
        self._lock = threading.RLock()
        self._started = False

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Database":
        """Load the persisted stores and indexes onto this Database's device
        and start the sync loop and the batcher."""
        with self._lock:
            if self._started:
                return self
            if self.persistence is not None:
                from erlvectordb_tpu_torch.parallel.sharded_store import (
                    ShardedVectorStore,
                )

                for name in list_persisted(self.config.persistence_dir):
                    if self.registry.exists(name):
                        continue
                    info = get_store_info(name, self.config.persistence_dir) or {}
                    mesh = self.cluster.mesh if info.get("sharded") else None
                    store = self.persistence.open_store(name, mesh=mesh)
                    if isinstance(store, ShardedVectorStore):
                        self.cluster.distribute_store(store)
                    elif store is not None:
                        self.registry.adopt(store)
                self.persistence.start()
                self.indexes.load_indexes(self._index_dir())
            self.batcher.start()
            if self.config.warmup_on_start:
                self.warmup()
            self._started = True
            return self

    def stop(self) -> None:
        """Stop the batcher, sync every changed store and save the built
        indexes."""
        with self._lock:
            self.batcher.stop()
            if self.persistence is not None:
                self.persistence.close()
                self.indexes.save_all(self._index_dir())
            self._started = False

    def _index_dir(self) -> Path:
        return Path(self.config.persistence_dir) / "indexes"

    def _track(self, store) -> None:
        if self.persistence is not None:
            self.persistence.track(store)

    def _check_free(self, name: str) -> None:
        """A name must be free among the local AND the distributed stores."""
        if self.registry.exists(name) or (
                self._cluster is not None
                and self._cluster.get_store(name) is not None):
            raise StoreExists(f"store {name!r} already exists")

    # ------------------------------------------------------------ store ops

    def create_store(self, name: str, dim: Optional[int] = None,
                     metric: str = "cosine", dtype: str = "float32",
                     intkey: bool = False) -> dict:
        if self._cluster is not None and self._cluster.get_store(name) is not None:
            raise StoreExists(f"store {name!r} already exists (distributed)")
        store = self.registry.create(name, dim=dim, metric=metric,
                                     dtype=dtype, intkey=intkey)
        self._track(store)
        return store.get_stats()

    def create_store_streaming(self, name: str, chunks, *, n: int,
                               dim: int, metric: str = "cosine",
                               **build_kw) -> dict:
        """Bulk build of an int4r store from a stream of [CH, dim] f32
        chunks (host arrays or tensors) through the device-side cell build
        (VectorStore.from_chunks): the corpus never exists as one host array.
        Ids are implicit "0".."n-1" by arrival order.  Extra kwargs reach
        ops/cell_build.py (cell_rows, cell_cap, aniso_eta...)."""
        self._check_free(name)
        store = VectorStore.from_chunks(name, chunks, n=n, dim=dim,
                                        metric=metric, device=self.device,
                                        **build_kw)
        self.registry.adopt(store)
        self._track(store)
        return store.get_stats()

    def delete_store(self, name: str) -> bool:
        """Drop a store and its indexes, with their snapshot and artifacts
        (the JAX package keeps the snapshot, so its next start reloads a
        deleted store)."""
        doomed = self.indexes.drop_for_store(name)
        if self.persistence is not None:
            self.persistence.forget(name)
            for idx in doomed:
                shutil.rmtree(self._index_dir() / f"idx_{idx}",
                              ignore_errors=True)
        hit = self.registry.drop(name)
        if self._cluster is not None:
            hit = self._cluster.undistribute_store(name) or hit
        return hit

    def list_stores(self) -> List[str]:
        names = set(self.registry.list())
        if self._cluster is not None:
            names.update(self._cluster.get_cluster_stats()["stores"])
        return sorted(names)

    def get_store(self, name: str) -> VectorStore:
        return self.registry.get(name)

    def insert(self, store: str, vector_id: str, vector,
               metadata: Optional[dict] = None) -> None:
        self.any_store(store).insert(vector_id, vector, metadata)

    def insert_batch(self, store: str, ids: Sequence[str], vectors,
                     metadatas: Optional[Sequence[Optional[dict]]] = None) -> None:
        self.any_store(store).insert_batch(ids, vectors, metadatas)

    def search(self, store: str, query, k: int = 10,
               metric: Optional[str] = None, nprobe: Optional[int] = None,
               recall_target: Optional[float] = None,
               ) -> List[Tuple[str, Any, float]]:
        """``nprobe`` (int4r stores) switches to the sub-linear multiprobe
        search; ``recall_target`` picks the smallest calibrated nprobe
        meeting it (VectorStore.calibrate_nprobe; lazily calibrated on
        first use)."""
        st = self.any_store(store)
        return st.search(query, k=k, metric=metric,
                         **self._probe_kw(st, nprobe, recall_target))

    def search_batch(self, store: str, queries, k: int = 10,
                     metric: Optional[str] = None,
                     nprobe: Optional[int] = None,
                     recall_target: Optional[float] = None):
        st = self.any_store(store)
        return st.search_batch(queries, k=k, metric=metric,
                               **self._probe_kw(st, nprobe, recall_target))

    def calibrate_store(self, store: str, queries=None, n_sample: int = 256,
                        k: int = 10, metric: Optional[str] = None,
                        ground_truth=None) -> dict:
        """Measure an int4r store's recall-vs-nprobe curve (see
        VectorStore.calibrate_nprobe); returns {nprobe: recall}.  Pass
        ``queries`` + ``ground_truth`` (exact rows over the original f32
        data, core/calibration.exact_ground_truth) for an exact-mode curve
        whose recall_target guarantee is absolute; without it the curve is
        ceiling-relative."""
        st = self.any_store(store)
        self._check_nprobe(st)
        return st.calibrate_nprobe(queries=queries, n_sample=n_sample, k=k,
                                   metric=metric, ground_truth=ground_truth)

    @classmethod
    def _probe_kw(cls, st, nprobe, recall_target) -> dict:
        kw = {}
        if nprobe is not None:
            cls._check_nprobe(st)
            kw["nprobe"] = nprobe
        if recall_target is not None:
            cls._check_nprobe(st)
            kw["recall_target"] = recall_target
        return kw

    @staticmethod
    def _check_nprobe(st) -> None:
        """Multiprobe search rides VectorStore's dispatch (which checks the
        int4r layout itself); any other store class gets the domain error,
        not a TypeError from its signature."""
        if not isinstance(st, VectorStore):
            raise ValueError(
                "nprobe requires a local int4r store; distributed stores "
                "do not support multiprobe")

    def delete(self, store: str, vector_id: str) -> bool:
        return self.any_store(store).delete(vector_id)

    def get_stats(self, store: str) -> dict:
        return self.any_store(store).get_stats()

    def get_all_vectors(self, store: str):
        return self.any_store(store).get_all_vectors()

    def warmup(self, store: Optional[str] = None) -> int:
        """Run each store's search path once (kernel build included)."""
        names = [store] if store else self.registry.list()
        stores = [self.registry.get_or_none(name) for name in names]
        return sum(s.warmup() for s in stores if hasattr(s, "warmup"))

    def any_store(self, name: str):
        """A store by name, local or distributed (search/insert routing for
        the frontends)."""
        local = self.registry.get_or_none(name)
        if local is not None:
            return local
        if self._cluster is not None:
            sharded = self._cluster.get_store(name)
            if sharded is not None:
                return sharded
        raise StoreNotFound(f"store {name!r} not found")

    def sync(self, store: str) -> bool:
        """Force a persistence sync of one store (False when persistence is
        off)."""
        self.any_store(store)  # raises StoreNotFound if absent
        if self.persistence is None:
            return False
        return self.persistence.sync(store)

    # --------------------------------------------------------------- backup

    def backup_store(self, store: str, backup_name: str) -> str:
        return backup_mod.backup_store(self.any_store(store), backup_name,
                                       self.config.backup_dir)

    def restore_store(self, backup_file: str,
                      new_name: Optional[str] = None) -> dict:
        path = Path(self.config.backup_dir) / Path(backup_file).name
        if not path.exists():
            path = Path(backup_file)
        from erlvectordb_tpu_torch.parallel.sharded_store import ShardedVectorStore

        store = backup_mod.restore_store(path, new_name=new_name,
                                         device=self.device,
                                         mesh=self.cluster.mesh)
        if isinstance(store, ShardedVectorStore):
            self._check_free(store.name)
            self.cluster.distribute_store(store)
        else:
            self.registry.adopt(store)
        self._track(store)
        return store.get_stats()

    def list_backups(self) -> List[dict]:
        return backup_mod.list_backups(self.config.backup_dir)

    def delete_backup(self, backup_file: str) -> bool:
        return backup_mod.delete_backup(backup_file, self.config.backup_dir)

    def export_store(self, store: str, path: str) -> str:
        return backup_mod.export_store(self.any_store(store), path)

    def import_store(self, path: str, new_name: Optional[str] = None) -> dict:
        store = backup_mod.import_store(path, new_name=new_name,
                                        device=self.device)
        self.registry.adopt(store)
        self._track(store)
        return store.get_stats()

    # -------------------------------------------------------------- cluster

    @property
    def cluster(self):
        """The ClusterManager over every device of this Database's kind
        (every card; the logical CPU devices for a CPU Database)."""
        with self._lock:
            if self._cluster is None:
                from erlvectordb_tpu_torch.parallel.cluster import ClusterManager

                self._cluster = ClusterManager(
                    devices=devices_of_kind(self.device),
                    replication_factor=self.config.replication_factor)
            return self._cluster

    def create_distributed_store(self, name: str, dim: Optional[int] = None,
                                 metric: str = "cosine",
                                 dtype: str = "float32") -> dict:
        """Create a store sharded across the cluster's mesh."""
        from erlvectordb_tpu_torch.parallel.sharded_store import ShardedVectorStore

        self._check_free(name)
        sharded = ShardedVectorStore(name, self.cluster.mesh, dim=dim,
                                     metric=metric, dtype=dtype)
        self.cluster.distribute_store(sharded)
        self._track(sharded)
        return sharded.get_stats()

    def create_dim_sharded_store(self, name: str, dim: Optional[int] = None,
                                 metric: str = "cosine",
                                 n_model: Optional[int] = None) -> dict:
        """Create a store whose FEATURE dimension is split across devices
        (``n_model`` of this Database's kind, default all of them); the full
        store API applies."""
        from erlvectordb_tpu_torch.parallel.dim_sharded import (
            DimShardedVectorStore,
            make_dim_mesh,
        )

        self._check_free(name)
        devs = devices_of_kind(self.device)
        store = DimShardedVectorStore(
            name, make_dim_mesh(n_model or len(devs), devices=devs), dim=dim,
            metric=metric)
        self.registry.adopt(store)
        self._track(store)
        return store.get_stats()

    def distribute_store(self, name: str) -> dict:
        """Move an existing local store onto the cluster's mesh."""
        local = self.registry.get(name)
        sharded = self.cluster.distribute_store(local)
        self.registry.drop(name)
        if self.persistence is not None:
            self.persistence.untrack(name)
            self.persistence.track(sharded)
        return sharded.get_stats()

    def get_store_location(self, name: str):
        return self.cluster.get_store_location(name)

    def get_cluster_nodes(self):
        return self.cluster.get_cluster_nodes()

    def get_cluster_stats(self):
        return self.cluster.get_cluster_stats()

    def join_cluster(self, coordinator_address=None, num_processes=None,
                     process_id=None):
        """Multi-process membership waits for ROADMAP Queue A item 3."""
        return self.cluster.join_cluster(coordinator_address, num_processes,
                                         process_id)

    def leave_cluster(self):
        return self.cluster.leave_cluster()

    # ---------------------------------------------------------- maintenance

    def _maintenance_tick(self) -> None:
        """Runs on the persistence thread every sync interval."""
        self._refit_stale_stores()
        self._persist_dirty_calibrations()

    def _persist_dirty_calibrations(self) -> int:
        """Re-save index artifacts whose recall_target curves were lazily
        computed since the last write, so a restart keeps them."""
        if self.persistence is None:
            return 0
        n = 0
        for name in self.indexes.dirty_calibrations():
            try:
                self.indexes.save_index(name, self._index_dir())
                n += 1
            except Exception:  # noqa: BLE001 — keep the tick alive
                LOG.exception("persisting calibration for index %r", name)
        return n

    def _refit_stale_stores(self) -> int:
        """Refit an int4r store whose cell-layout churn crossed
        ``refit_threshold`` (VectorStore.is_stale); one store a tick bounds
        the pause."""
        threshold = getattr(self.config, "refit_threshold", 0.0)
        if not threshold:
            return 0
        for name in self.registry.list():
            store = self.registry.get_or_none(name)
            if isinstance(store, VectorStore) and store.is_stale(threshold):
                drift = store.drift()
                store.rebuild_cells()
                metrics.inc("store.cell_refit_total")
                LOG.info("refit stale int4r store %r (churn %.0f%%)",
                         store.name, 100 * drift["fraction"])
                return 1
        return 0

    # --------------------------------------------------------------- indexes

    def create_index(self, name: str, store: str, index_type: str,
                     parameters: Optional[dict] = None) -> dict:
        return self.indexes.create_index(name, store, index_type, parameters)

    def build_index(self, name: str, wait: bool = True) -> dict:
        info = self.indexes.build_index(name, wait=wait)
        if (self.persistence is not None and info.get("built")
                and info.get("type") != "flat"):
            self.indexes.save_index(name, self._index_dir())
        return info

    def list_indexes(self) -> List[dict]:
        return self.indexes.list_indexes()

    def get_index_info(self, name: str):
        return self.indexes.get_index_info(name)

    def drop_index(self, name: str) -> bool:
        hit = self.indexes.drop_index(name)
        if hit and self.persistence is not None:
            shutil.rmtree(self._index_dir() / f"idx_{name}", ignore_errors=True)
        return hit

    def search_index(self, name: str, query, k: int = 10,
                     nprobe: Optional[int] = None,
                     recall_target: Optional[float] = None):
        """``nprobe`` overrides the build-time probe width per request
        (ivf/cellprobe families); ``recall_target`` picks the smallest
        calibrated nprobe (cellprobe family; absolute after
        calibrate_index(mode='exact'), deep-probe-relative otherwise)."""
        return self.indexes.search(name, query, k=k, nprobe=nprobe,
                                   recall_target=recall_target)

    def calibrate_index(self, name: str, queries=None, n_sample: int = 256,
                        k: int = 10, mode: str = "exact",
                        metric: Optional[str] = None) -> dict:
        """Calibrate a cellprobe-family index's recall_target curve:
        ``mode="exact"`` (default) measures absolute recall@k against exact
        f32 ground truth from the backing store and enforces the
        quantization ceiling; ``mode="ceiling"`` is the cheap self-relative
        curve (IndexManager.calibrate_index).  The curve persists with the
        index artifact."""
        out = self.indexes.calibrate_index(
            name, queries=queries, n_sample=n_sample, k=k, mode=mode,
            metric=metric)
        if self.persistence is not None:
            self.indexes.save_index(name, self._index_dir())
        return out

    # ----------------------------------------------------------- compression

    def compress_vector(self, vector, algorithm: str, **kw):
        return compression_mod.compress_vector(vector, algorithm,
                                               device=self.device, **kw)

    def decompress_vector(self, compressed, **kw):
        return compression_mod.decompress_vector(compressed,
                                                 device=self.device, **kw)

    def get_supported_algorithms(self):
        return compression_mod.get_supported_algorithms()

    def benchmark_compression(self, vector, algorithm: str, **kw):
        return compression_mod.benchmark_compression(
            vector, algorithm, device=self.device, **kw)

    # ---------------------------------------------------------------- oauth

    def register_oauth_client(self, client_id: str, secret: str,
                              scopes: Optional[List[str]] = None) -> dict:
        return self.oauth.register_client(client_id, secret, scopes)

    def get_access_token(self, client_id: str, secret: str,
                         scopes: Optional[List[str]] = None) -> dict:
        return self.oauth.grant_client_credentials(client_id, secret, scopes)

    def validate_token(self, token: str):
        return self.oauth.validate_token(token)
