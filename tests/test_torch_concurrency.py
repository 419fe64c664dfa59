"""tests/test_concurrency.py re-pointed at the port: mutation of a
VectorStore (erlvectordb_tpu_torch/core/store.py) is serialised by its
lock while searches run beside it, hammered from threads on the CPU, and
parallel OAuth grants stay unique and valid."""

import threading

import numpy as np
import torch

from erlvectordb_tpu_torch.core.store import VectorStore
from erlvectordb_tpu_torch.serve.oauth import OAuthServer

CPU = torch.device("cpu")


class TestStoreConcurrency:
    def test_parallel_inserts_disjoint_ids(self, rng):
        store = VectorStore("c1", dim=8, device=CPU)
        n_threads, per_thread = 8, 50
        errors = []

        def worker(t):
            try:
                data = rng.standard_normal((per_thread, 8)).astype(np.float32)
                for i in range(per_thread):
                    store.insert(f"t{t}_{i}", data[i], {"t": t})
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors
        assert store.count == n_threads * per_thread
        # every id retrievable
        for t in range(n_threads):
            assert store.get(f"t{t}_0") is not None

    def test_search_during_mutation(self, rng):
        store = VectorStore("c2", dim=16, device=CPU)
        base = rng.standard_normal((500, 16)).astype(np.float32)
        store.insert_batch([f"b{i}" for i in range(500)], base)
        stop = threading.Event()
        errors = []

        def mutator():
            i = 0
            try:
                while not stop.is_set():
                    store.insert(f"m{i % 50}", rng.standard_normal(16).astype(np.float32))
                    if i % 3 == 0:
                        store.delete(f"m{(i - 1) % 50}")
                    i += 1
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        def searcher():
            try:
                for _ in range(100):
                    res = store.search(base[7], k=5)
                    assert len(res) >= 1
                    # results are sorted and finite
                    d = [r[2] for r in res]
                    assert all(np.isfinite(x) for x in d)
                    assert d == sorted(d)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        m = threading.Thread(target=mutator)
        searchers = [threading.Thread(target=searcher) for _ in range(4)]
        m.start()
        for s in searchers:
            s.start()
        for s in searchers:
            s.join()
        stop.set()
        m.join()
        assert not errors, errors[:2]

    def test_overwrite_race_last_writer_wins(self, rng):
        store = VectorStore("c3", dim=4, device=CPU)
        errors = []

        def writer(val):
            try:
                for _ in range(50):
                    store.insert("shared", [val] * 4, {"v": val})
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(float(v),)) for v in (1, 2, 3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors
        assert store.count == 1
        vec, meta = store.get("shared")
        # whichever writer won, vector and metadata must be consistent
        assert meta["v"] == vec[0]


class TestOAuthConcurrency:
    def test_parallel_grants_and_validation(self):
        srv = OAuthServer()
        srv.register_client("c", "s")
        tokens, errors = [], []

        def grant():
            try:
                for _ in range(30):
                    tok = srv.grant_client_credentials("c", "s")
                    assert srv.validate_token(tok["access_token"]) is not None
                    tokens.append(tok)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=grant) for _ in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errors
        assert len(tokens) == 180
        assert len({t["access_token"] for t in tokens}) == 180
