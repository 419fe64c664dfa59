"""The port's benchmark: one cell of BENCHMARK.json, run once.

    python3 evdb_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json`` and
each per-layer metric's reader in ``metrics/<metric>.py``.  The plain
reference that decides ``correct`` lives in ``reference/``; it imports
nothing of the program under test.
"""
