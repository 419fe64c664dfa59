"""Snapshot persistence — device -> host checkpoint and restore of stores.

Counterpart of ``erlvectordb_tpu/persist/snapshot.py``, with its on-disk
format, so a snapshot written by either package loads in the other:

  * ``save_store`` writes a generation-numbered ``state_<gen>.npz`` +
    ``meta_<gen>.json`` pair (write to a temp file, rename, npz first).  The
    npz holds a ``__saved_at__`` echo of the meta's timestamp, so the loader
    can prove a pair consistent: it takes the newest pair whose meta parses,
    whose npz opens and whose echo matches.  Older generations are removed
    only after the new pair is committed, so a crash at any point leaves a
    previous consistent pair;
  * ``save_delta`` writes ``delta_<seq>.{json,npz}`` with only the rows
    touched since the last sync, anchored to the base's ``saved_at``;
  * ``PersistenceManager`` runs the dirty-flag sync loop on a background
    thread (delta or full base) and re-hydrates stores on open.

Divergences from the JAX package, each readable by its loader:

  * every array of the exported state goes into the npz.  The JAX
    ``save_store`` moves five named arrays and leaves the rest in the JSON
    meta, where ``json.dumps`` fails on an int4r store's ``rq_codes``,
    ``rq_books`` and ``rq_rot`` (``rq_m``) and on a spilled streaming
    store's ``perm``; its loader copies every npz key into the state;
  * an intkey store's key plane (``codes_unit``) is saved with the state and
    its touched rows with each delta, so a restored store keys rows as the
    live one did (a plane re-derived from the int8 codes keys some rows one
    step apart); the JAX loader ignores it;
  * a delta also carries the touched rows' ``rq_codes`` and an int4r
    store's ``cell_next``/``cell_free``, which the JAX delta leaves out (a
    reload there serves stale stage-2 codes and hands out slots already
    taken);
  * a deleted store's snapshot is deleted with it (``forget``); the JAX
    ``Database.delete_store`` leaves it, and the next start reloads it.

Stores sharded over a device mesh (``sharded``/``dim_sharded`` states, in
the JAX package's format) load onto a mesh of the devices of the loader's
kind (parallel/), and are written as the JAX package writes them.

Optional at-rest compression (``compression="zlib"``) uses numpy's deflate
container.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from erlvectordb_tpu_torch.core.store import VectorStore

SNAPSHOT_FORMAT = 1
DEFAULT_SYNC_INTERVAL = 30.0

# per-row arrays a delta carries and applies, when the state has them
_ROW_KEYS = ("vectors", "norms", "valid", "scales", "rq_codes", "codes_unit")


def store_from_state(state: dict, device=None, mesh=None):
    """The store an exported state describes, on ``device`` (default: the
    CUDA card): a ShardedVectorStore on ``mesh`` (default: every device of
    that kind) for a sharded state, a DimShardedVectorStore over
    ``n_model`` devices of that kind for a dim-sharded one, else a
    VectorStore."""
    from erlvectordb_tpu_torch.core.store import default_device
    from erlvectordb_tpu_torch.parallel.mesh import devices_of_kind, make_mesh

    device = torch.device(device) if device is not None else default_device()
    if state.get("sharded"):
        from erlvectordb_tpu_torch.parallel.sharded_store import ShardedVectorStore

        return ShardedVectorStore.from_state(
            state, mesh or make_mesh(devices=devices_of_kind(device)))
    if state.get("dim_sharded"):
        from erlvectordb_tpu_torch.parallel.dim_sharded import (
            DimShardedVectorStore,
            make_dim_mesh,
        )

        return DimShardedVectorStore.from_state(state, make_dim_mesh(
            int(state.get("n_model", 1)), devices=devices_of_kind(device)))
    return VectorStore.from_state(state, device=device)


def split_arrays(state: dict) -> dict:
    """Move every ndarray of an exported state into the returned dict (the
    npz part); the rest of ``state`` is the JSON part."""
    return {k: state.pop(k) for k in list(state)
            if isinstance(state[k], np.ndarray)}


def _store_dir(root: Path, name: str) -> Path:
    # store names are validated by the API; this guards against traversal
    safe = name.replace("/", "_").replace("\\", "_").replace("..", "_")
    return root / safe


def _pair_gen(p: Path) -> int:
    try:
        return int(p.stem.rsplit("_", 1)[1])
    except (IndexError, ValueError):
        return -1


def resolve_pair(sdir: Path, npz_stem: str):
    """Newest provably consistent (meta path, npz path, meta dict) of the
    ``meta_<gen>.json`` + ``<npz_stem>_<gen>.npz`` pairs in ``sdir``, else
    the legacy unversioned ``meta.json`` + ``<npz_stem>.npz`` pair (npz
    path None if absent), else None.  A pair is consistent when the meta
    parses, the npz opens, and the npz's ``__saved_at__`` echo equals the
    meta's ``saved_at``: torn renames, truncated npz files and meta/state
    skew fall through to the previous generation."""
    for mp in sorted(sdir.glob("meta_*.json"), key=_pair_gen, reverse=True):
        npz = sdir / f"{npz_stem}_{mp.stem.rsplit('_', 1)[1]}.npz"
        try:
            meta = json.loads(mp.read_text())
        except (json.JSONDecodeError, OSError):
            continue
        if not npz.exists():
            continue
        try:
            with np.load(npz) as z:
                if "__saved_at__" not in z.files:
                    continue
                echo = float(z["__saved_at__"][0])
        except Exception:  # noqa: BLE001 — truncated or corrupt zip
            continue
        if meta.get("saved_at") != echo:
            continue  # skewed pair (new arrays + old meta, or the reverse)
        return mp, npz, meta
    mp = sdir / "meta.json"
    if mp.exists():
        try:
            meta = json.loads(mp.read_text())
        except (json.JSONDecodeError, OSError):
            return None
        npz = sdir / f"{npz_stem}.npz"
        return mp, (npz if npz.exists() else None), meta
    return None


def write_pair(sdir: Path, npz_stem: str, arrays: dict, meta: dict,
               compressed: bool = False) -> int:
    """Commit ``arrays`` + ``meta`` as the next generation pair in ``sdir``
    (npz renamed first: the loader keys on meta files, so a meta implies its
    npz landed) and then retire the older generations, the legacy pair and
    orphan temp files.  Returns the generation."""
    sdir.mkdir(parents=True, exist_ok=True)
    meta["saved_at"] = time.time()
    arrays["__saved_at__"] = np.asarray([meta["saved_at"]], np.float64)
    buf = io.BytesIO()
    (np.savez_compressed if compressed else np.savez)(buf, **arrays)
    old_metas = list(sdir.glob("meta_*.json"))
    gen = max((_pair_gen(p) for p in old_metas), default=0) + 1
    tmp_npz = sdir / f".{npz_stem}_{gen:08d}.npz.tmp"
    tmp_meta = sdir / f".meta_{gen:08d}.json.tmp"
    tmp_npz.write_bytes(buf.getvalue())
    tmp_meta.write_text(json.dumps(meta))
    os.replace(tmp_npz, sdir / f"{npz_stem}_{gen:08d}.npz")
    os.replace(tmp_meta, sdir / f"meta_{gen:08d}.json")
    for p in old_metas:
        p.unlink(missing_ok=True)
    for p in sdir.glob(f"{npz_stem}_*.npz"):
        if _pair_gen(p) < gen:
            p.unlink(missing_ok=True)
    (sdir / "meta.json").unlink(missing_ok=True)
    (sdir / f"{npz_stem}.npz").unlink(missing_ok=True)
    for p in sdir.glob(".*.tmp"):
        p.unlink(missing_ok=True)
    return gen


def save_store(store: VectorStore, root: str | os.PathLike,
               compression: Optional[str] = None) -> str:
    """Snapshot one store under ``root/<name>/`` as a new generation pair
    (the previous pair survives until this one is committed)."""
    sdir = _store_dir(Path(root), store.name)
    # clear BEFORE export: a row touched after this clear is recorded again
    # by its own mutation (which the export's read lock holds off until
    # done), so at worst a row lands in both the base and the next delta
    # (a sharded store has no delta chain: every sync is a full base)
    local = isinstance(store, VectorStore)
    if local:
        store._touched_rows.clear()
    state = store.export_state()
    arrays = split_arrays(state)
    state["snapshot_format"] = SNAPSHOT_FORMAT
    state["compression"] = compression or "none"
    write_pair(sdir, "state", arrays, state, compressed=compression == "zlib")
    clear_deltas(sdir)
    if local:
        store._touched_reliable = True
    return str(sdir)


def save_delta(store: VectorStore, root: str | os.PathLike, seq: int) -> int:
    """Write an incremental snapshot of the rows touched since the last
    sync — an O(delta) device gather and disk write.  Returns the number of
    rows written.  The caller guarantees a base snapshot exists."""
    sdir = _store_dir(Path(root), store.name)
    resolved = resolve_pair(sdir, "state")
    if resolved is None:
        raise FileNotFoundError(f"no base snapshot under {sdir}")
    base_meta = resolved[2]  # anchor to the pair the loader will resolve
    with store._lock.read():
        rows = np.fromiter(sorted(store._touched_rows), np.int64,
                           len(store._touched_rows))
        rows_t = torch.from_numpy(rows).to(store.device)
        arrays = {"rows": rows}
        for key in _ROW_KEYS:
            t = getattr(store, "_" + key)
            if t is not None:
                arrays[key] = t[rows_t].cpu().numpy()
        ids = store._ids_view()[rows]
        meta = {
            "version": store.version,
            "base_saved_at": base_meta["saved_at"],
            "next_row": store._next_row,
            "free_rows": list(store._free_rows),
            "ids": [None if v is None else str(v) for v in ids.tolist()],
            "metadata": {str(v): store._metadata.get(str(v), {})
                         for v in ids.tolist() if v is not None},
        }
        if store._cell_next is not None:
            meta["cell_next"] = [int(x) for x in store._cell_next]
            meta["cell_free"] = {str(c): list(v)
                                 for c, v in store._cell_free.items()}
        store._touched_rows.clear()
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp_npz = sdir / f".delta_{seq:06d}.npz.tmp"
    tmp_meta = sdir / f".delta_{seq:06d}.json.tmp"
    tmp_npz.write_bytes(buf.getvalue())
    tmp_meta.write_text(json.dumps(meta))
    # json first: a crash between the renames leaves an npz-less delta that
    # the loader skips, never a half-described one
    os.replace(tmp_meta, sdir / f"delta_{seq:06d}.json")
    os.replace(tmp_npz, sdir / f"delta_{seq:06d}.npz")
    return int(rows.size)


def _delta_files(sdir: Path):
    return sorted(sdir.glob("delta_*.json"))


def clear_deltas(sdir: Path) -> None:
    for p in list(sdir.glob("delta_*.json")) + list(sdir.glob("delta_*.npz")):
        p.unlink(missing_ok=True)


def _apply_deltas(state: dict, sdir: Path) -> None:
    """Fold delta files into a loaded base state (arrays, ids, metadata)."""
    base_saved_at = state.get("saved_at")
    row_to_id = {int(r): i for i, r in state.get("id_to_row", {}).items()}
    for jpath in _delta_files(sdir):
        npz_path = jpath.with_suffix(".npz")
        if not npz_path.exists():
            continue  # torn write: the json landed, the npz did not
        dmeta = json.loads(jpath.read_text())
        if dmeta.get("base_saved_at") != base_saved_at:
            continue  # stale delta of a previous base
        with np.load(npz_path) as z:
            rows = z["rows"]
            for key in _ROW_KEYS:
                if key in z.files and key in state:
                    state[key][rows] = z[key]
        id_to_row = state.setdefault("id_to_row", {})
        metadata = state.setdefault("metadata", {})
        for r, vid in zip(rows.tolist(), dmeta["ids"]):
            old = row_to_id.get(r)
            if old is not None and old != vid:
                id_to_row.pop(old, None)
                metadata.pop(old, None)
            if vid is None:
                row_to_id.pop(r, None)
            else:
                id_to_row[vid] = r
                row_to_id[r] = vid
                metadata[vid] = dmeta["metadata"].get(vid, {})
        for key in ("next_row", "free_rows", "version", "cell_next",
                    "cell_free"):
            if key in dmeta:
                state[key] = dmeta[key]
        state["contig"] = 0  # deltas imply targeted mutations happened


def read_state(npz_path: Optional[Path], meta: dict) -> dict:
    """The state dict of a resolved pair: the meta plus every npz array."""
    state = dict(meta)
    if npz_path is not None and npz_path.exists():
        with np.load(npz_path) as z:
            for k in z.files:
                if k != "__saved_at__":
                    state[k] = z[k]
    return state


def load_store(name: str, root: str | os.PathLike,
               device: Optional[torch.device] = None, mesh=None):
    """Re-hydrate a store (base + deltas) onto ``device`` (default: the CUDA
    card); a sharded snapshot onto ``mesh`` (see store_from_state).  None if
    no snapshot exists."""
    sdir = _store_dir(Path(root), name)
    if not sdir.exists():
        return None
    resolved = resolve_pair(sdir, "state")
    if resolved is None:
        return None
    state = read_state(resolved[1], resolved[2])
    if not state.get("sharded"):  # sharded stores write no deltas
        _apply_deltas(state, sdir)
    return store_from_state(state, device=device, mesh=mesh)


def list_persisted(root: str | os.PathLike) -> List[str]:
    root = Path(root)
    if not root.exists():
        return []
    return sorted(
        p.name for p in root.iterdir()
        if p.is_dir() and ((p / "meta.json").exists()
                           or any(p.glob("meta_*.json"))))


def delete_persisted(name: str, root: str | os.PathLike) -> bool:
    sdir = _store_dir(Path(root), name)
    if not sdir.exists():
        return False
    for f in list(sdir.iterdir()):
        f.unlink()
    sdir.rmdir()
    return True


def get_store_info(name: str, root: str | os.PathLike) -> Optional[dict]:
    """Snapshot header without loading arrays."""
    sdir = _store_dir(Path(root), name)
    if not sdir.exists():
        return None
    resolved = resolve_pair(sdir, "state")
    if resolved is None:
        return None
    meta = resolved[2]
    return {
        "name": meta.get("name", name),
        "dimension": meta.get("dim"),
        "count": len(meta.get("id_to_row") or meta.get("id_to_slot") or {})
        + int(meta.get("contig", 0)),
        "metric": meta.get("metric"),
        "dtype": meta.get("dtype"),
        "sharded": bool(meta.get("sharded", False)),
        "saved_at": meta.get("saved_at"),
        "compression": meta.get("compression", "none"),
    }


class PersistenceManager:
    """Dirty-flag periodic sync of a set of stores.

    Tracks (store, last synced version); the background thread snapshots
    any store whose version moved since its last sync, as a delta while the
    touched rows are few and the chain is anchored, else as a full base.
    ``sync`` forces one store; ``close`` does a final sync and stops the
    thread.  Stores opened here land on ``device``.
    """

    MAX_DELTAS = 64            # compaction: a full base after this many
    MAX_DELTA_FRACTION = 0.25  # a delta only while touched <= 25% of rows

    # optional maintenance hook, run each tick before the sync (Database
    # wires cell refits and calibration saves here)
    maintenance_cb = None

    def __init__(self, root: str | os.PathLike,
                 sync_interval: float = DEFAULT_SYNC_INTERVAL,
                 compression: Optional[str] = None,
                 device: Optional[torch.device] = None):
        self.root = Path(root)
        self.sync_interval = float(sync_interval)
        self.compression = compression
        self.device = device
        self._tracked: Dict[str, VectorStore] = {}
        self._synced_version: Dict[str, int] = {}
        self._delta_seq: Dict[str, int] = {}   # deltas written since base
        # one writer a store: an explicit sync() racing the background loop
        # must not interleave generation writes
        self._save_locks: Dict[str, threading.Lock] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="evdb-persist",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.sync_interval + 5)
            self._thread = None
        self.sync_all()

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_interval):
            if self.maintenance_cb is not None:
                try:
                    self.maintenance_cb()
                except Exception:  # noqa: BLE001 — keep the loop alive
                    pass
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001 — keep the loop alive
                pass

    # -- tracking ----------------------------------------------------------

    def track(self, store: VectorStore) -> None:
        with self._lock:
            self._tracked[store.name] = store
            self._synced_version.setdefault(store.name, -1)

    def untrack(self, name: str) -> None:
        with self._lock:
            self._tracked.pop(name, None)
            self._synced_version.pop(name, None)

    def forget(self, name: str) -> bool:
        """Stop tracking a deleted store and delete its snapshot, after any
        save of it in flight, so a restart does not bring it back."""
        with self._lock:
            self.untrack(name)
            self._delta_seq.pop(name, None)
            save_lock = self._save_locks.setdefault(name, threading.Lock())
        with save_lock:
            return delete_persisted(name, self.root)

    def open_store(self, name: str, mesh=None):
        """Load a snapshot if present (a sharded one onto ``mesh``) and
        start tracking the store."""
        store = load_store(name, self.root, device=self.device, mesh=mesh)
        if store is not None:
            self.track(store)
            with self._lock:
                self._synced_version[name] = store.version
                # continue the existing delta chain where it left off
                self._delta_seq[name] = len(_delta_files(
                    _store_dir(self.root, name)))
            if isinstance(store, VectorStore):
                store._touched_reliable = True
        return store

    # -- syncing -----------------------------------------------------------

    def _sync_store(self, store: VectorStore) -> None:
        with self._lock:
            save_lock = self._save_locks.setdefault(store.name,
                                                    threading.Lock())
        with save_lock:
            self._sync_store_locked(store)

    def _sync_store_locked(self, store: VectorStore) -> None:
        name = store.name
        # the version BEFORE the (possibly seconds-long) save: a write that
        # lands during the save moves store.version past it, so the next
        # cycle syncs again instead of marking unsaved state as synced
        ver = store.version
        seq = self._delta_seq.get(name, 0)
        local = isinstance(store, VectorStore)
        touched = len(store._touched_rows) if local else 0
        use_delta = (
            local
            and store._touched_reliable
            and not store._contig
            and 0 < touched <= max(1, int(self.MAX_DELTA_FRACTION
                                          * max(store.count, 1)))
            and seq < self.MAX_DELTAS
            # deltas carry no calibration curves: a fresh (lazily computed)
            # curve forces one full base so it survives a restart
            and not store._calib.dirty
        )
        if use_delta:
            save_delta(store, self.root, seq)
            with self._lock:
                self._delta_seq[name] = seq + 1
        else:
            save_store(store, self.root, compression=self.compression)
            with self._lock:
                self._delta_seq[name] = 0
        with self._lock:
            self._synced_version[name] = ver
        if store.version == ver:  # no write raced the save
            store.dirty = False

    def sync(self, name: str) -> bool:
        with self._lock:
            store = self._tracked.get(name)
        if store is None:
            return False
        self._sync_store(store)
        return True

    def sync_all(self) -> int:
        with self._lock:
            pending = [
                s for s in self._tracked.values()
                if s.version != self._synced_version.get(s.name, -1)
                or isinstance(s, VectorStore) and s._calib.dirty
            ]
        for store in pending:
            self._sync_store(store)
        return len(pending)
