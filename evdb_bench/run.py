"""Run one cell of BENCHMARK.json once and print its result line.

    python3 evdb_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Measures the port (``erlvectordb_tpu_torch``) on the CUDA card and nothing
else: it exits non-zero, printing no result, without a card (or with fewer
than the cell asks for), and when the JAX package or JAX itself is loaded
in this process once the window has closed.  With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy seconds and a breakdown.  The numbers
that decide ``correct`` are printed last on standard error and last in the
result line, each beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "erlvectordb_tpu")


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed directory of the checkout
    (the port builds its kernels under ``build/erlvectordb_tpu_torch/``)."""
    cache = root / "build" / "evdb_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return f"card and power limit: {out}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cache_env(ROOT)

    from evdb_bench import spec
    from evdb_bench.client import Clients

    cell = spec.cell(args.workload)
    # the load's processes start first: their own start-up runs beside the
    # import of torch and the server's set-up, not after it
    clients = Clients.spawn(cell.traffic["processes"])
    try:
        import torch

        from evdb_bench import harness

        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"error: the cell needs {cell.chips} CUDA card(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        print(power_line(), file=sys.stderr, flush=True)
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START, clients)
    finally:
        clients.stop()
    found = forbidden_modules()
    if found:
        print(f"error: loaded in the measuring process: {found}",
              file=sys.stderr)
        return 3
    for line in result.pop("_check_lines"):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
