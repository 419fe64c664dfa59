"""The control on the card, at each cell's own size: the reference put in
the program's place in int4 (one precision below the configuration's
int8) must fail the configuration's limits on every seed.

    python -m pytest -p no:cacheprovider -m cuda evdb_bench/tests/test_evdb_bench_control.py
"""

import pytest

from evdb_bench import judge, spec
from evdb_bench.control import control_numbers

CASES = [("glove100_int8", "store"), ("cohere1m_int8", "store"),
         ("cohere1m_int8", "index")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind", CASES)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_at_the_cells_size(cuda_device, name, kind, seed):
    cfg = spec.load_json(spec.ROOT / f"evdb_bench/configs/{name}.json")
    values = control_numbers(cfg, kind, seed, cuda_device)
    ok, rows = judge.verdict(values, cfg["correct"][kind])
    assert not ok, rows
