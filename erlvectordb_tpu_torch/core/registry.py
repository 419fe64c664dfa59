"""Store registry — the dynamic-supervisor analogue.

The reference manages store lifecycles with a one_for_one dynamic supervisor
(`start_store`/`stop_store`, reference: src/vector_store_sup.erl:16-41).
Here that is a thread-safe name->VectorStore registry whose stores all live
on the registry's torch device.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

from erlvectordb_tpu_torch.core.store import VectorStore, default_device


class StoreExists(ValueError):
    pass


class StoreNotFound(KeyError):
    pass


class StoreRegistry:
    def __init__(self, device: Optional[torch.device] = None):
        self.device = torch.device(device) if device is not None else default_device()
        self._stores: Dict[str, VectorStore] = {}
        self._lock = threading.RLock()

    def create(
        self,
        name: str,
        dim: Optional[int] = None,
        metric: str = "cosine",
        dtype: str = "float32",
        intkey: bool = False,
    ) -> VectorStore:
        with self._lock:
            if name in self._stores:
                raise StoreExists(f"store {name!r} already exists")
            store = VectorStore(name, dim=dim, metric=metric, dtype=dtype,
                                device=self.device, intkey=intkey)
            self._stores[name] = store
            return store

    def adopt(self, store: VectorStore) -> VectorStore:
        """Register an externally constructed store (restore/import path)."""
        with self._lock:
            if store.name in self._stores:
                raise StoreExists(f"store {store.name!r} already exists")
            self._stores[store.name] = store
            return store

    def get(self, name: str) -> VectorStore:
        with self._lock:
            store = self._stores.get(name)
            if store is None:
                raise StoreNotFound(f"store {name!r} not found")
            return store

    def get_or_none(self, name: str) -> Optional[VectorStore]:
        with self._lock:
            return self._stores.get(name)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._stores

    def drop(self, name: str) -> bool:
        with self._lock:
            return self._stores.pop(name, None) is not None

    def list(self) -> List[str]:
        with self._lock:
            return sorted(self._stores)

    def stats(self) -> List[dict]:
        with self._lock:
            return [s.get_stats() for s in self._stores.values()]

    def clear(self) -> None:
        with self._lock:
            self._stores.clear()
