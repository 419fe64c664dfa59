"""Public API facade — the store verbs of the JAX package's ``Database``.

One :class:`Database` wires the store registry, the OAuth server and the
query batcher and the index manager together on one ``torch.device``; the
MCP server calls through it.  Persistence (of stores and of indexes),
backup, the cluster layer and compression are not ported yet: a
configuration that enables persistence is refused with ``ConfigError``
rather than silently run without durability.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence, Tuple

import torch

from erlvectordb_tpu_torch.core.index_manager import IndexManager
from erlvectordb_tpu_torch.core.registry import (
    StoreExists,
    StoreNotFound,
    StoreRegistry,
)
from erlvectordb_tpu_torch.core.store import VectorStore, default_device
from erlvectordb_tpu_torch.infra.config import Config, ConfigError, load_config
from erlvectordb_tpu_torch.serve.batcher import QueryBatcher
from erlvectordb_tpu_torch.serve.oauth import OAuthServer


class Database:
    """A running erlvectordb instance on one device: the CUDA card unless
    the caller names another (``device="cpu"``)."""

    def __init__(self, config: Optional[Config] = None,
                 device: Optional[torch.device] = None):
        self.config = config or load_config()
        if self.config.persistence_enabled:
            raise ConfigError(
                "persistence_enabled=True needs the snapshot layer "
                "(erlvectordb_tpu/persist/snapshot.py), which is not yet "
                "ported to erlvectordb_tpu_torch; set persistence_enabled="
                "False")
        self.device = torch.device(device) if device is not None else default_device()
        self.registry = StoreRegistry(self.device)
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
        self._lock = threading.RLock()
        self._started = False

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "Database":
        with self._lock:
            if self._started:
                return self
            self.batcher.start()
            if self.config.warmup_on_start:
                self.warmup()
            self._started = True
            return self

    def stop(self) -> None:
        with self._lock:
            self.batcher.stop()
            self._started = False

    # ------------------------------------------------------------ store ops

    def create_store(self, name: str, dim: Optional[int] = None,
                     metric: str = "cosine", dtype: str = "float32",
                     intkey: bool = False) -> dict:
        store = self.registry.create(name, dim=dim, metric=metric,
                                     dtype=dtype, intkey=intkey)
        return store.get_stats()

    def create_store_streaming(self, name: str, chunks, *, n: int,
                               dim: int, metric: str = "cosine",
                               **build_kw) -> dict:
        """Bulk build of an int4r store from a stream of [CH, dim] f32
        chunks (host arrays or tensors) through the device-side cell build
        (VectorStore.from_chunks): the corpus never exists as one host array.
        Ids are implicit "0".."n-1" by arrival order.  Extra kwargs reach
        ops/cell_build.py (cell_rows, cell_cap, aniso_eta...)."""
        if self.registry.exists(name):
            raise StoreExists(f"store {name!r} already exists")
        store = VectorStore.from_chunks(name, chunks, n=n, dim=dim,
                                        metric=metric, device=self.device,
                                        **build_kw)
        self.registry.adopt(store)
        return store.get_stats()

    def delete_store(self, name: str) -> bool:
        self.indexes.drop_for_store(name)
        return self.registry.drop(name)

    def list_stores(self) -> List[str]:
        return self.registry.list()

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
        names = [store] if store else self.list_stores()
        return sum(self.registry.get(name).warmup() for name in names)

    def any_store(self, name: str) -> VectorStore:
        """A store by name (search/insert routing for the frontends)."""
        local = self.registry.get_or_none(name)
        if local is None:
            raise StoreNotFound(f"store {name!r} not found")
        return local

    # --------------------------------------------------------------- indexes

    def create_index(self, name: str, store: str, index_type: str,
                     parameters: Optional[dict] = None) -> dict:
        return self.indexes.create_index(name, store, index_type, parameters)

    def build_index(self, name: str, wait: bool = True) -> dict:
        return self.indexes.build_index(name, wait=wait)

    def list_indexes(self) -> List[dict]:
        return self.indexes.list_indexes()

    def get_index_info(self, name: str):
        return self.indexes.get_index_info(name)

    def drop_index(self, name: str) -> bool:
        return self.indexes.drop_index(name)

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
        curve (IndexManager.calibrate_index)."""
        return self.indexes.calibrate_index(
            name, queries=queries, n_sample=n_sample, k=k, mode=mode,
            metric=metric)

    # ---------------------------------------------------------------- oauth

    def register_oauth_client(self, client_id: str, secret: str,
                              scopes: Optional[List[str]] = None) -> dict:
        return self.oauth.register_client(client_id, secret, scopes)

    def get_access_token(self, client_id: str, secret: str,
                         scopes: Optional[List[str]] = None) -> dict:
        return self.oauth.grant_client_credentials(client_id, secret, scopes)

    def validate_token(self, token: str):
        return self.oauth.validate_token(token)
