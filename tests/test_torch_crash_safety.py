"""tests/test_crash_safety.py re-pointed at the port's snapshots
(erlvectordb_tpu_torch/persist/snapshot.py): a crash at any point of a sync
leaves a previous consistent snapshot pair for the loader.  Injected:

  * kill -9 mid-sync (a real subprocess running the port on the CPU, killed
    at a moment in a tight mutate+sync loop) -> the survivor load parses and
    is internally consistent;
  * torn rename windows (npz landed / meta did not, and the reverse);
  * meta/state skew (new arrays paired with old metadata);
  * truncated npz (a partial write or disk corruption);
  * orphan tmp files.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.core.store import VectorStore
from erlvectordb_tpu_torch.persist.snapshot import (
    load_store,
    save_delta,
    save_store,
)

CPU = torch.device("cpu")


def _mk_store(name="cs", n=300, d=12, seed=3):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    st = VectorStore(name, dim=d, device=CPU)
    st.insert_batch([f"v{i}" for i in range(n)], data,
                    [{"i": i} for i in range(n)])
    return st, data


def _pair_paths(sdir):
    metas = sorted(sdir.glob("meta_*.json"))
    npzs = sorted(sdir.glob("state_*.npz"))
    return metas, npzs


class TestTornWindows:
    def test_npz_only_generation_falls_back(self, tmp_path):
        """Crash between the npz and meta renames: the new generation is
        npz-only and the previous pair still loads."""
        st, data = _mk_store()
        save_store(st, tmp_path)
        sdir = tmp_path / "cs"
        # simulate the torn window of a NEWER save: npz landed, meta didn't
        (sdir / "state_00000099.npz").write_bytes(
            (sdir / next(iter(_pair_paths(sdir)[1])).name).read_bytes())
        loaded = load_store("cs", tmp_path, device=CPU)
        assert loaded is not None and loaded.count == st.count
        assert loaded.get("v7")[1] == {"i": 7}

    def test_meta_only_generation_falls_back(self, tmp_path):
        """Meta without its npz (manual deletion / historic writer order):
        skipped, previous pair loads."""
        st, data = _mk_store()
        save_store(st, tmp_path)
        sdir = tmp_path / "cs"
        meta = json.loads(next(iter(_pair_paths(sdir)[0])).read_text())
        meta["saved_at"] = meta["saved_at"] + 1.0
        meta["next_row"] = 10_000  # poison: loading THIS meta would skew
        (sdir / "meta_00000099.json").write_text(json.dumps(meta))
        loaded = load_store("cs", tmp_path, device=CPU)
        assert loaded is not None and loaded.count == st.count

    def test_meta_state_skew_detected(self, tmp_path):
        """New arrays + old metadata (the exact round-4 crash window): the
        saved_at echo mismatch rejects the pair."""
        st, data = _mk_store()
        save_store(st, tmp_path)
        sdir = tmp_path / "cs"
        metas, npzs = _pair_paths(sdir)
        good_meta = json.loads(metas[0].read_text())
        # gen 2: real npz from gen 1 (echo = old saved_at) but a NEW meta
        # claiming a different timestamp and poisoned row bookkeeping
        (sdir / "state_00000002.npz").write_bytes(npzs[0].read_bytes())
        bad_meta = dict(good_meta)
        bad_meta["saved_at"] = good_meta["saved_at"] + 5.0
        bad_meta["id_to_row"] = {}
        (sdir / "meta_00000002.json").write_text(json.dumps(bad_meta))
        loaded = load_store("cs", tmp_path, device=CPU)
        assert loaded is not None
        assert loaded.count == st.count  # the consistent gen-1 pair won
        assert loaded.get("v7")[1] == {"i": 7}

    def test_truncated_npz_falls_back_or_none(self, tmp_path):
        """Truncated npz (partial write): pair rejected without raising."""
        st, data = _mk_store()
        save_store(st, tmp_path)
        sdir = tmp_path / "cs"
        metas, npzs = _pair_paths(sdir)
        # gen 2 with a valid meta but a truncated npz
        blob = npzs[0].read_bytes()
        (sdir / "state_00000002.npz").write_bytes(blob[: len(blob) // 3])
        meta = json.loads(metas[0].read_text())
        (sdir / "meta_00000002.json").write_text(json.dumps(meta))
        loaded = load_store("cs", tmp_path, device=CPU)  # must not raise
        assert loaded is not None and loaded.count == st.count

    def test_all_pairs_corrupt_returns_none(self, tmp_path):
        st, data = _mk_store()
        save_store(st, tmp_path)
        sdir = tmp_path / "cs"
        for p in sdir.glob("state_*.npz"):
            blob = p.read_bytes()
            p.write_bytes(blob[: len(blob) // 4])
        assert load_store("cs", tmp_path, device=CPU) is None  # graceful, no raise

    def test_orphan_tmp_files_ignored_and_cleaned(self, tmp_path):
        st, data = _mk_store()
        save_store(st, tmp_path)
        sdir = tmp_path / "cs"
        (sdir / ".state_00000009.npz.tmp").write_bytes(b"partial garbage")
        (sdir / ".meta_00000009.json.tmp").write_text('{"half": ')
        assert load_store("cs", tmp_path, device=CPU).count == st.count
        save_store(st, tmp_path)  # next sync sweeps orphans
        assert not list(sdir.glob(".*.tmp"))

    def test_new_generation_supersedes_and_cleans(self, tmp_path):
        st, data = _mk_store()
        save_store(st, tmp_path)
        st.insert("extra", data[0] * 0.5, {"fresh": True})
        save_store(st, tmp_path)
        sdir = tmp_path / "cs"
        metas, npzs = _pair_paths(sdir)
        assert len(metas) == 1 and len(npzs) == 1  # old gen retired
        loaded = load_store("cs", tmp_path, device=CPU)
        assert loaded.get("extra")[1] == {"fresh": True}

    def test_delta_anchors_to_resolved_base(self, tmp_path):
        """A delta written while a TORN newer generation exists must anchor
        to the pair the loader resolves, or it would never apply."""
        st, data = _mk_store()
        save_store(st, tmp_path)
        sdir = tmp_path / "cs"
        # torn newer generation (npz only)
        (sdir / "state_00000099.npz").write_bytes(
            next(iter(_pair_paths(sdir)[1])).read_bytes())
        st.insert("post", data[1] * 2.0, {"late": True})
        save_delta(st, tmp_path, seq=0)
        loaded = load_store("cs", tmp_path, device=CPU)
        assert loaded.get("post")[1] == {"late": True}

    def test_legacy_unversioned_pair_still_loads(self, tmp_path):
        """Pre-round-5 snapshots (state.npz + meta.json, no echo) load."""
        st, data = _mk_store()
        save_store(st, tmp_path)
        sdir = tmp_path / "cs"
        metas, npzs = _pair_paths(sdir)
        # demote to the legacy layout
        with np.load(npzs[0]) as z:
            arrays = {k: z[k] for k in z.files if k != "__saved_at__"}
        buf_path = sdir / "state.npz"
        with open(buf_path, "wb") as f:
            np.savez(f, **arrays)
        os.replace(metas[0], sdir / "meta.json")
        npzs[0].unlink()
        loaded = load_store("cs", tmp_path, device=CPU)
        assert loaded is not None and loaded.count == st.count


_WORKER = textwrap.dedent("""
    import sys, time
    import numpy as np
    from erlvectordb_tpu_torch.core.store import VectorStore
    from erlvectordb_tpu_torch.persist.snapshot import PersistenceManager

    root = sys.argv[1]
    rng = np.random.default_rng(0)
    data = rng.standard_normal((400, 16)).astype(np.float32)
    st = VectorStore("kill", dim=16, device="cpu")
    st.insert_batch([f"v{i}" for i in range(400)], data,
                    [{"i": i} for i in range(400)])
    pm = PersistenceManager(root, sync_interval=9999, device="cpu")
    pm.track(st)
    pm.sync("kill")
    print("BASE_READY", flush=True)
    i = 0
    while True:  # tight mutate+sync loop until killed
        st.insert(f"e{i}", data[i % 400] * 0.5, {"gen": i})
        if i % 7 == 0:
            st.delete(f"v{i % 400}")
        pm.sync("kill")
        i += 1
""")


class TestKillMinusNine:
    @pytest.mark.parametrize("delay", [0.05, 0.35, 0.9])
    def test_survivor_loads_consistent(self, tmp_path, delay):
        """SIGKILL the syncing process at a random point; the snapshot dir
        must still load into an internally-consistent store."""
        worker = tmp_path / "worker.py"
        worker.write_text(_WORKER)
        repo = str(Path(__file__).resolve().parent.parent)
        env = dict(os.environ, PYTHONPATH=repo)
        proc = subprocess.Popen(
            [sys.executable, str(worker), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            cwd=repo, env=env)
        try:
            line = proc.stdout.readline().decode()
            assert "BASE_READY" in line, line
            time.sleep(delay)  # let some syncs land, then pull the plug
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)

        loaded = load_store("kill", tmp_path, device=CPU)
        assert loaded is not None, "no consistent snapshot survived"
        # internal consistency: every id maps to a live row and back
        ids = [vid for vid, _v, _m in loaded.get_all_vectors()]
        assert loaded.count == len(ids)
        assert loaded.count >= 300  # base had 400 (minus a few deletes)
        for vid in ids[:25]:
            vec, meta = loaded.get(vid)
            assert np.isfinite(np.asarray(vec)).all()
        # metadata bookkeeping survived for a base row that was never
        # deleted (v1 is only deleted when i % 400 == 1 and i % 7 == 0,
        # i.e. not before i=57*7; the kill window is far shorter)
        if "v1" in ids:
            assert loaded.get("v1")[1] == {"i": 1}
