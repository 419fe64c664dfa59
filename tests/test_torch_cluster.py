"""tests/test_cluster.py re-pointed at the port's ClusterManager
(erlvectordb_tpu_torch/parallel/cluster.py) on 8 logical CPU devices:
placement and location, the distribution map, health and probes, cluster
stats and state sync, and replica failover with data re-protection."""

import numpy as np
import pytest
import torch

from erlvectordb_tpu_torch.core import VectorStore
from erlvectordb_tpu_torch.parallel import ClusterError, ClusterManager, cpu_devices
from erlvectordb_tpu_torch.parallel.mesh import cpu_device_count, set_cpu_device_count

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def eight_cpu_devices():
    held = cpu_device_count()
    set_cpu_device_count(8)
    yield cpu_devices()
    set_cpu_device_count(held)


@pytest.fixture
def manager(eight_cpu_devices):
    # 8 devices -> 2 replica groups of 4
    return ClusterManager(devices=eight_cpu_devices, replication_factor=2)


@pytest.fixture
def populated(manager, rng):
    data = rng.standard_normal((500, 16)).astype(np.float32)
    local = VectorStore("cstore", device=torch.device("cpu"))
    local.insert_batch([f"v{i}" for i in range(500)], data)
    sharded = manager.distribute_store(local)
    return manager, sharded, data


class TestPlacement:
    def test_distribute_and_locate(self, populated):
        manager, sharded, data = populated
        assert sharded.count == 500
        loc = manager.get_store_location("cstore")
        assert loc["shards"] == 4
        assert loc["replicas"] == 2
        assert len(loc["placement"]) == 4
        assert all(len(v) == 2 for v in loc["placement"].values())

    def test_distribution_map(self, populated):
        manager, _, _ = populated
        assert set(manager.get_store_distribution()) == {"cstore"}

    def test_search_through_cluster(self, populated):
        manager, sharded, data = populated
        assert manager.get_store("cstore").search(data[77], k=1)[0][0] == "v77"

    def test_undistribute(self, populated):
        manager, _, _ = populated
        assert manager.undistribute_store("cstore")
        assert not manager.undistribute_store("cstore")
        assert manager.get_store("cstore") is None


class TestHealth:
    def test_nodes_and_status(self, manager):
        assert len(manager.get_cluster_nodes()) == 8
        status = manager.get_node_status()
        assert len(status) == 8
        assert all(s["healthy"] for s in status)

    def test_probe(self, manager):
        probes = manager.probe_devices()
        assert len(probes) == 8
        assert all(probes.values())

    def test_stats_shape(self, populated):
        manager, _, _ = populated
        stats = manager.get_cluster_stats()
        assert stats["total_devices"] == 8
        assert stats["replica_groups"] == 2
        assert stats["data_shards"] == 4
        assert stats["stores"] == {"cstore": 500}

    def test_sync_state(self, manager):
        assert "state_version" in manager.sync_cluster_state()


class TestFailover:
    def test_fail_device_reprotects(self, populated):
        manager, sharded, data = populated
        dead = manager.get_node_status()[0]["id"]  # a device in group 0
        stats = manager.fail_device(dead)
        assert stats["healthy_devices"] == 7
        assert stats["replica_groups"] == 1  # group 0 poisoned, group 1 serves
        # searches still exact after failover
        assert manager.get_store("cstore").search(data[42], k=1)[0][0] == "v42"
        assert manager.get_store("cstore").count == 500

    def test_recover_device(self, populated):
        manager, _, data = populated
        dead = manager.get_node_status()[0]["id"]
        manager.fail_device(dead)
        stats = manager.recover_device(dead)
        assert stats["replica_groups"] == 2
        assert manager.get_store("cstore").search(data[7], k=1)[0][0] == "v7"

    def test_total_failure_raises(self, manager):
        ids = [s["id"] for s in manager.get_node_status()]
        # kill one device in every replica group
        manager.fail_device(ids[0])
        with pytest.raises(ClusterError):
            manager.fail_device(ids[4])

    def test_unknown_device(self, manager):
        with pytest.raises(ClusterError):
            manager.fail_device(12345)
