"""Durability of the port: snapshots with deltas (snapshot.py), backups and
JSON export/import (backup.py), in the JAX package's on-disk formats."""

from erlvectordb_tpu_torch.persist.snapshot import (  # noqa: F401
    PersistenceManager,
    delete_persisted,
    get_store_info,
    list_persisted,
    load_store,
    save_store,
)
from erlvectordb_tpu_torch.persist.backup import (  # noqa: F401
    backup_store,
    delete_backup,
    export_store,
    import_store,
    list_backups,
    read_backup_manifest,
    restore_store,
)
