"""tests/test_full_lifecycle.py re-pointed at the port's Database on the CPU
(8 logical CPU devices): local stores of every dtype, a distributed store,
built indexes, a backup and an export survive a stop and a restart, and
answer correctly afterwards."""

import numpy as np
import torch

from erlvectordb_tpu_torch.api import Database
from erlvectordb_tpu_torch.infra.config import load_config
from erlvectordb_tpu_torch.parallel.mesh import cpu_device_count, set_cpu_device_count

CPU = torch.device("cpu")
torch.set_num_threads(2)


def test_everything_survives_restart(rng, tmp_path):
    held = cpu_device_count()
    set_cpu_device_count(8)
    try:
        _lifecycle(rng, tmp_path)
    finally:
        set_cpu_device_count(held)


def _lifecycle(rng, tmp_path):
    cfg = load_config(overrides={
        "persistence_dir": str(tmp_path / "data"),
        "backup_dir": str(tmp_path / "backups"),
        "sync_interval": 9999,
    }, env={})

    db = Database(cfg, device=CPU).start()
    data = {}
    for dtype in ("float32", "int8", "int4"):
        name = f"s_{dtype}"
        db.create_store(name, metric="euclidean", dtype=dtype)
        data[name] = rng.standard_normal((120, 16)).astype(np.float32)
        db.insert_batch(name, [f"v{i}" for i in range(120)], data[name],
                        [{"i": i} for i in range(120)])
        db.delete(name, "v7")
        db.sync(name)

    # distributed store
    db.create_distributed_store("s_dist", dtype="int8")
    data["s_dist"] = rng.standard_normal((90, 16)).astype(np.float32)
    db.insert_batch("s_dist", [f"v{i}" for i in range(90)], data["s_dist"])
    db.sync("s_dist")

    # indexes over a local store
    db.create_index("idx_i8", "s_float32", "int8")
    db.build_index("idx_i8")
    db.create_index("idx_pq", "s_float32", "pq", {"m": 8, "iters": 6})
    db.build_index("idx_pq")

    # a backup + an export
    bpath = db.backup_store("s_int8", "pre_restart")
    bfile = bpath.rsplit("/", 1)[-1]
    db.export_store("s_int4", str(tmp_path / "s4.json"))

    db.stop()  # graceful: final sync + index save

    # ---- restart ------------------------------------------------------------
    db2 = Database(cfg, device=CPU).start()
    try:
        names = db2.list_stores()
        for dtype in ("float32", "int8", "int4"):
            name = f"s_{dtype}"
            assert name in names
            assert db2.any_store(name).count == 119  # v7 deleted pre-restart
            hit = db2.search(name, data[name][42], k=1)[0]
            assert hit[0] == "v42" and hit[1] == {"i": 42}
            assert db2.search(name, data[name][7], k=1)[0][0] != "v7"
        assert "s_dist" in names
        assert db2.any_store("s_dist").count == 90
        assert db2.any_store("s_dist").n_shards == 8
        assert db2.search("s_dist", data["s_dist"][9], k=1)[0][0] == "v9"

        # indexes rebuilt from persisted artifacts
        assert db2.get_index_info("idx_i8")["built"]
        assert db2.search_index("idx_i8", data["s_float32"][42], k=1)[0][0] == "v42"
        assert db2.get_index_info("idx_pq")["built"]

        # backups still restorable; exports importable
        assert db2.restore_store(bfile, new_name="s_int8_restored")["count"] == 119
        assert db2.import_store(str(tmp_path / "s4.json"),
                                new_name="s4_imp")["count"] == 119

        # post-restart mutations work on every store
        for name in ("s_float32", "s_int8", "s_int4", "s_dist"):
            db2.insert(name, "fresh", np.ones(16, np.float32))
            assert db2.search(name, np.ones(16, np.float32), k=1)[0][0] == "fresh"
    finally:
        db2.stop()
