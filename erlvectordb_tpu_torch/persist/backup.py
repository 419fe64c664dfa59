"""Backups and portable JSON export/import.

Counterpart of ``erlvectordb_tpu/persist/backup.py``, in its file formats:

  * ``backup_store``  -> one ``<store>_<name>_<ts>.backup`` file: a zip of
    ``manifest.json`` and a compressed ``state.npz`` of the exported state;
  * ``restore_store`` -> a fresh store from a backup (optionally renamed);
  * ``list_backups`` / ``delete_backup``;
  * ``export_store`` / ``import_store`` — JSON of the shape
    ``{"store_name", "dimension", "vector_count", "vectors":
    [{"id", "vector", "metadata"}]}``.

As in snapshots (persist/snapshot.py), every array of the exported state
goes into the npz: the JAX package's five named arrays leave an int4r
store's ``rq_*`` arrays in the manifest, where ``json.dumps`` fails.  A
sharded store's backup restores onto a mesh; a dim-sharded one, as in the
JAX package, restores as a single-device store.
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from erlvectordb_tpu_torch.core.store import VectorStore
from erlvectordb_tpu_torch.persist.snapshot import split_arrays, store_from_state

BACKUP_SUFFIX = ".backup"


def backup_store(store: VectorStore, backup_name: str,
                 backup_dir: str | os.PathLike) -> str:
    """Write a point-in-time backup file; returns its path."""
    bdir = Path(backup_dir)
    bdir.mkdir(parents=True, exist_ok=True)
    ts = int(time.time())
    path = bdir / f"{store.name}_{backup_name}_{ts}{BACKUP_SUFFIX}"

    manifest = store.export_state()
    arrays = split_arrays(manifest)
    manifest["backup_name"] = backup_name
    manifest["timestamp"] = ts
    manifest["store_info"] = store.get_stats()

    npz_buf = io.BytesIO()
    np.savez_compressed(npz_buf, **arrays)
    tmp = path.with_suffix(".tmp")
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED) as z:
        z.writestr("manifest.json", json.dumps(manifest))
        z.writestr("state.npz", npz_buf.getvalue())
    os.replace(tmp, path)
    return str(path)


def read_backup_manifest(path: str | os.PathLike) -> dict:
    with zipfile.ZipFile(path) as z:
        return json.loads(z.read("manifest.json"))


def restore_store(path: str | os.PathLike, new_name: Optional[str] = None,
                  device: Optional[torch.device] = None, mesh=None):
    """Materialize a store from a backup file (optionally renamed) on
    ``device`` (default: the CUDA card); a sharded backup onto ``mesh``
    (default: every device of that kind)."""
    with zipfile.ZipFile(path) as z:
        state = json.loads(z.read("manifest.json"))
        with np.load(io.BytesIO(z.read("state.npz"))) as npz:
            for k in npz.files:
                state[k] = npz[k]
    state.pop("store_info", None)
    if new_name:
        state["name"] = new_name
    state.pop("dim_sharded", None)
    return store_from_state(state, device=device, mesh=mesh)


def list_backups(backup_dir: str | os.PathLike) -> List[dict]:
    """Backup inventory with per-file header info."""
    bdir = Path(backup_dir)
    if not bdir.exists():
        return []
    out = []
    for p in sorted(bdir.glob(f"*{BACKUP_SUFFIX}")):
        try:
            m = read_backup_manifest(p)
        except (zipfile.BadZipFile, KeyError, json.JSONDecodeError):
            continue
        out.append({
            "file": p.name,
            "path": str(p),
            "store_name": m.get("name"),
            "backup_name": m.get("backup_name"),
            "timestamp": m.get("timestamp"),
            "vector_count": len(m.get("id_to_row") or m.get("id_to_slot")
                                or {}) + int(m.get("contig", 0)),
            "size_bytes": p.stat().st_size,
        })
    return out


def delete_backup(file_name: str, backup_dir: str | os.PathLike) -> bool:
    p = Path(backup_dir) / Path(file_name).name
    if p.exists() and p.suffix == BACKUP_SUFFIX:
        p.unlink()
        return True
    return False


# ---------------------------------------------------------------- JSON export


def export_store(store: VectorStore, path: str | os.PathLike) -> str:
    """Portable JSON export of the live vectors (dequantized)."""
    entries = [
        {"id": vid, "vector": [float(x) for x in vec], "metadata": meta}
        for vid, vec, meta in store.get_all_vectors()
    ]
    doc = {
        "store_name": store.name,
        "dimension": store.dim,
        "metric": store.metric,
        "vector_count": len(entries),
        "exported_at": time.time(),
        "vectors": entries,
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(doc))
    os.replace(tmp, path)
    return str(path)


def import_store(path: str | os.PathLike, new_name: Optional[str] = None,
                 dtype: str = "float32",
                 device: Optional[torch.device] = None) -> VectorStore:
    """Create a store on ``device`` from a JSON export."""
    doc = json.loads(Path(path).read_text())
    store = VectorStore(new_name or doc["store_name"],
                        dim=doc.get("dimension"),
                        metric=doc.get("metric", "cosine"), dtype=dtype,
                        device=device)
    vectors = doc.get("vectors", [])
    if vectors:
        store.insert_batch([e["id"] for e in vectors],
                           np.asarray([e["vector"] for e in vectors],
                                      np.float32),
                           [e.get("metadata", {}) for e in vectors])
    return store
