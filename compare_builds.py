"""Time the CellProbeIndex build of checkouts of the PyTorch port, phase by
phase, on one card, at chip_smoke.py path (q)'s shape or at the cohere1m
index cell's, and hold each checkout's phases to the first one's outputs.

    python3 compare_builds.py [--rows N] [--choices-from ROOT2] ROOT [ROOT ...]
    python3 compare_builds.py --cohere1m ROOT [ROOT ...]

Each ROOT is a directory holding an ``erlvectordb_tpu_torch`` package (a
checkout, or ``git archive`` of one); each runs in a process of its own, in
the order given.  Every process draws (q)'s corpus on the card (16,777,216
x 128 rows of config 4's recipe, chip_smoke.manifold) and its 1024
held-out points, then times, each step ending in a device synchronise:

  * store_matrix  the index manager's ``_store_matrix`` (pad128) of a
                  float32 euclidean VectorStore of the rows;
  * kpp           k-means++ seeding (``ops/kmeans.py::_kpp_init``) of
                  174,763 centroids on the build's 200,000-row sample;
  * lloyd         15 Lloyd iterations from those seeds;
  * choices       ``core/ivf.py::_top_choices_all`` (32 nearest centroids a
                  row) over the first CHOICE_ROWS rows;
  * assign        ``_balanced_assign`` of every row at cap 128 (choice
                  lists, greedy, stragglers);
  * encode        ``CellProbeIndex.build(hierarchy=False)`` with its
                  k-means and assignment replaced by the shared results
                  below: the host encode and the upload;
  * hierarchy     ``_with_hierarchy(seed=0, iters=15)`` of that index;
  * route         ``ops/cell_probe.py::route_probes`` of the hierarchical
                  index, 1024 queries at nprobe 8 to 256 (median host ms of
                  5 calls after a warm-up).

``--rows N`` draws the first N rows of that corpus instead (a multiple of
chip_smoke.Q_CHUNK; N / 96 cells).  The first ROOT writes the inputs every
later one reads (BUILD_DIR): the
Lloyd centroids and, per k-means call of the hierarchy, the supercentroids
(a checkout whose Lloyd sums have no fixed order on the card fits other
last bits each time; one whose sums differ in order from another's fits
other bits than it), so every checkout assigns, encodes and builds the
hierarchy from the same centroids.  ``--choices-from ROOT2`` gives a
checkout ROOT2's ``_top_choices_all`` inside ``_balanced_assign`` (for a
checkout whose choice lists would take too long at this size; its
``choices`` step still times its own).  Each process prints one JSON line:
per step seconds, a SHA-1 of its output (equal between checkouts whose
step computes the same function) and the process's peak RSS after it.
The card's name and power limit (nvidia-smi) come first.  Exits non-zero
if a checkout fails or no CUDA device is present.

``--cohere1m`` builds instead the index of the benchmark cell
``cohere1m.mcp_index`` as its set-up does: the configuration
``evdb_bench/configs/cohere1m_int8.json`` (1,000,000 x 768 rows of its
manifold recipe, drawn on the card from seed 1 by
``evdb_bench/corpus.py``) in an int8 cosine store, then the index manager's
``_store_matrix`` (pad128) and ``CellProbeIndex.build`` at the manager's
defaults (cell_rows 96, cell_cap 128, 15 Lloyd iterations: 10,417 cells).
Its line
holds the two steps' seconds, the build's own phase seconds
(``build_stats``) and SHA-1s of the k-means++ seeds, the Lloyd centroids,
the assignment and each encoded array, equal between checkouts that build
the same index.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

import chip_smoke as cs

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "compare_builds")
DEVICE = "cuda"
CHOICE_ROWS = 262_144
MAX_TRAIN, CAP, ROUTE_NPROBE = 200_000, 128, (8, 16, 32, 64, 128, 256)
CELL_SEED = 1   # --cohere1m's corpus seed


def sha(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        if hasattr(a, "detach"):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def shared(name, compute):
    """The first checkout's array ``name`` (computed and saved by it)."""
    path = os.path.join(BUILD_DIR, name + ".npy")
    if os.path.exists(path):
        return np.load(path)
    out = np.asarray(compute())
    np.save(path, out)
    return out


def measure(root: str, rows: int, choices_from: str | None) -> dict:
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import erlvectordb_tpu_torch.core.cell_probe as cpi
    import erlvectordb_tpu_torch.core.ivf as ivf
    import erlvectordb_tpu_torch.ops.cell_probe as cp
    import erlvectordb_tpu_torch.ops.kmeans as km
    from erlvectordb_tpu_torch.core.index_manager import IndexManager
    from erlvectordb_tpu_torch.core.store import VectorStore

    out = {"root": root, "steps": {}}

    def step(name, fn, digest=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t0,
               "peak_rss_gb": resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2 ** 20}
        if digest is not None:
            rec["sha1"] = digest(res)
        out["steps"][name] = rec
        print(json.dumps({"root": root, "step": name, **rec}),
              file=sys.stderr, flush=True)
        return res

    cs.Q_ROWS = rows
    chunk = cs.manifold(cs.SEED + cs.Q_SEED, cs.N_CENTRES, cs.J_LATENT,
                        cs.J_DIM, cs.NOISE, 0.05)
    held = chunk(10 ** 6, cs.Q_HELD)
    x, _gt = cs.q_draw(chunk, held)
    out["corpus_sha1"] = sha(x[::4096])
    store = VectorStore.from_matrix("q", x, metric="euclidean",
                                    dtype="float32", device=DEVICE)
    del x
    got = step("store_matrix",
               lambda: IndexManager._store_matrix(store, pad128=True))
    mat, rows = got[0], got[1]
    del got, store
    torch.cuda.empty_cache()
    n = mat.shape[0]
    k = -(-n // 96)
    train = mat[np.random.default_rng(0).choice(n, MAX_TRAIN, replace=False)]
    xt = torch.as_tensor(train, device=DEVICE)

    def kpp():
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(0)
        return km._kpp_init(xt, gen, k)

    cents0 = step("kpp", kpp, sha)
    fit = step("lloyd", lambda: km._lloyd(xt, cents0, k, 15)).cpu().numpy()
    cents = shared("cents", lambda: fit)
    del xt, cents0
    cj = torch.as_tensor(cents, device=DEVICE)
    xj = torch.as_tensor(mat[:CHOICE_ROWS], device=DEVICE)
    step("choices", lambda: ivf._top_choices_all(xj, cj, j=32, chunk=4096),
         lambda r: sha(*r))
    del xj
    torch.cuda.empty_cache()
    if choices_from:
        spec = importlib.util.spec_from_file_location(
            "ivf_choices", os.path.join(choices_from, "erlvectordb_tpu_torch",
                                        "core", "ivf.py"))
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        ivf._top_choices_all = other._top_choices_all
        out["choices_from"] = choices_from
    kw = {}
    if "stats" in inspect.signature(ivf._balanced_assign).parameters:
        kw["stats"] = out["assign_stats"] = {}
    owner = step("assign", lambda: ivf._balanced_assign(
        mat, cents, CAP, device=torch.device(DEVICE), **kw), sha)

    # the build with the shared centroids and this owner: encode + upload
    real_fit = cpi.kmeans_fit

    def fit_shared(x, seed, *, k, iters=25, init="random", balance=0.0):
        if k == cents.shape[0]:
            return torch.as_tensor(cents, device=x.device), None
        sc = shared(f"super_{k}", lambda: real_fit(
            x, seed, k=k, iters=iters, init=init)[0].cpu().numpy())
        return torch.as_tensor(sc, device=x.device), None

    real_assign = cpi._balanced_assign
    cpi.kmeans_fit = fit_shared
    if hasattr(cpi, "kmeans_seeds"):
        cpi.kmeans_seeds = lambda x, seed, *, k, init="random", **kw: None
        cpi._lloyd = lambda x, c0, k, iters, balance=0.0: torch.as_tensor(
            cents, device=x.device)
    cpi._balanced_assign = (
        lambda data, c, cap, **kw2: owner if c.shape[0] == cents.shape[0]
        else real_assign(data, c, cap, **kw2))
    arrays = lambda ix: sha(ix.codes, ix.scales, ix.norms, ix.row_map,
                            ix.centroids)
    idx = step("encode", lambda: cpi.CellProbeIndex.build(
        mat, rows, iters=15, hierarchy=False, device=DEVICE), arrays)
    del mat
    hier = step("hierarchy", lambda: idx._with_hierarchy(seed=0, iters=15),
                arrays)
    out["hier"] = dict(n_cells=hier.n_cells, child_cap=hier.child_cap,
                       supercells=int(hier.super_route.shape[0]))
    del idx
    torch.cuda.empty_cache()
    active = hier.valid.reshape(hier.n_cells, hier.cell_cap).any(dim=1)
    out["route_ms"], probes = {}, []
    for p in ROUTE_NPROBE:
        def route():
            return cp.route_probes(
                hier.centroids, held, active, metric="euclidean", nprobe=p,
                centroids_route=hier.cents_route, cn2=hier.cn2,
                super_route=hier.super_route, child_cap=hier.child_cap)
        probes.append(route())
        out["route_ms"][p] = cs.host_ms(
            lambda: (route(), torch.cuda.synchronize()))
    out["route_sha1"] = sha(*probes)
    return out


def measure_cell(root: str, seed: int) -> dict:
    """The cohere1m index cell's build in checkout ``root`` (``--cohere1m``)."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import erlvectordb_tpu_torch.core.cell_probe as cpi
    from erlvectordb_tpu_torch.core.index_manager import IndexManager
    from erlvectordb_tpu_torch.core.store import VectorStore
    from evdb_bench import corpus

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "evdb_bench", "configs",
                           "cohere1m_int8.json")) as f:
        config = json.load(f)
    out = {"root": root, "seed": seed, "steps": {}}
    x = corpus.draw(config, seed, DEVICE, corpus.CORPUS)
    out["corpus_sha1"] = sha(x[::4096])
    store = VectorStore.from_matrix(config["name"], x,
                                    metric=config["metric"],
                                    dtype=config["store"]["dtype"],
                                    device=DEVICE)
    del x
    torch.cuda.empty_cache()
    # each phase's output, hashed after the build
    kept = {}

    def keep(name, fn):
        def wrapped(*a, **kw):
            kept[name] = fn(*a, **kw)
            return kept[name]
        return wrapped

    cpi.kmeans_seeds = keep("kpp", cpi.kmeans_seeds)
    cpi._lloyd = keep("lloyd", cpi._lloyd)
    cpi._balanced_assign = keep("assign", cpi._balanced_assign)
    t0 = time.perf_counter()
    mat, rows = IndexManager._store_matrix(store, pad128=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = config["index"]["parameters"]
    idx = cpi.CellProbeIndex.build(mat, rows, cell_rows=params["cell_rows"],
                                   cell_cap=params["cell_cap"], iters=15,
                                   device=DEVICE)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out["steps"] = {"store_matrix": {"s": t1 - t0},
                    "build": {"s": t2 - t1},
                    "peak_rss_gb": resource.getrusage(
                        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
                    "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["build_stats"] = idx.build_stats
    out["sha1"] = {name: sha(a) for name, a in kept.items()}
    out["sha1"].update({name: sha(getattr(idx, name)) for name in (
        "centroids", "codes", "scales", "norms", "valid", "row_map")})
    return out


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_builds: no CUDA device", file=sys.stderr)
        return 1
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(argv[1], int(argv[2]),
                                 argv[3] if len(argv) > 3 else None)),
              flush=True)
        return 0
    if argv[:1] == ["--one-cell"]:
        print(json.dumps(measure_cell(argv[1], int(argv[2]))), flush=True)
        return 0
    rows, choices_from, cell = cs.Q_ROWS, None, False
    while argv[:1] in (["--rows"], ["--choices-from"], ["--cohere1m"]):
        if argv[0] == "--cohere1m":
            cell, argv = True, argv[1:]
            continue
        if argv[0] == "--rows":
            rows = int(argv[1])
        else:
            choices_from = os.path.abspath(argv[1])
        argv = argv[2:]
    if not argv or rows % cs.Q_CHUNK:
        print(__doc__, file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    os.makedirs(BUILD_DIR, exist_ok=True)
    for f in os.listdir(BUILD_DIR):
        os.remove(os.path.join(BUILD_DIR, f))
    rc = 0
    for root in argv:
        extra = ([choices_from] if choices_from
                 and os.path.abspath(root) != choices_from else [])
        one = (["--one-cell", root, str(CELL_SEED)] if cell
               else ["--one", root, str(rows), *extra])
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               *one], text=True, stdout=subprocess.PIPE)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            rc = proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
