from erlvectordb_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    REPLICA_AXIS,
    cpu_devices,
    init_distributed,
    make_mesh,
    mesh_shape,
    set_cpu_device_count,
    single_device_mesh,
)
from erlvectordb_tpu_torch.parallel.sharded_store import ShardedVectorStore  # noqa: F401
from erlvectordb_tpu_torch.parallel.cluster import ClusterError, ClusterManager  # noqa: F401
