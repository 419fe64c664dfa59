"""tests/test_graft_entry.py::test_dryrun_multichip_8 re-pointed at the
port: the sharded pipeline over 8 logical CPU devices
(erlvectordb_tpu_torch/parallel/dryrun.py), which raises on a wrong
answer."""

from erlvectordb_tpu_torch.parallel.dryrun import dryrun_multichip
from erlvectordb_tpu_torch.parallel.mesh import cpu_device_count


def test_dryrun_multichip_8():
    held = cpu_device_count()
    dryrun_multichip(8)  # asserts internally
    assert cpu_device_count() == held  # the device count is restored
