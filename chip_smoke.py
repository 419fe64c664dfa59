#!/usr/bin/env python3
"""Smoke run of erlvectordb_tpu_torch on one CUDA card (an H100).

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line of its own numbers:

  1. device   the card's name and power limit (nvidia-smi) and versions;
  2. build    the CUDA kernels compiled from csrc/ with nvcc (seconds,
              registers), and the three 1.2M-row stores built on the card;
  3. kernels  each kernel against its plain PyTorch version at the config-3
              shapes (1024 queries x 1.2M rows, W=128), with the stated bars
              and median times;
  4. slice    the stores behind the MCP server: search_vectors, a 1024-query
              search_vectors_batch in b64, insert -> found first, delete ->
              gone; recall@10 against exact f32 ground truth on the card;
              every kernel's launch count over these requests;

then the kernels summary line, the nvidia-smi line and, last, the contract
line ``{"ok": true, "device": {...}}``.  Any failed phase raises and the
script exits non-zero without that line, as it does without a CUDA device
or outside a checkout.  The corpus follows bench.py's make_corpus recipe
(1024 Gaussian centres, noise 0.35), drawn with numpy from a seed.
"""

from __future__ import annotations

import base64
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

N_ROWS, DIM, N_CENTRES, NOISE = 1_200_000, 100, 1024, 0.35
BATCH, K, N_RECALL, SEED = 1024, 10, 256, 0
F32_ROWS = 20_000   # store (d), filled over MCP
DEVICE = "cuda"
SOURCE = "erlvectordb_tpu_torch/csrc/fused_topk.cu"
REPLACES = {  # kernel -> the TPU kernel's pallas_call (file:line)
    "intkey_scan": "erlvectordb_tpu/ops/fused_topk.py:479",
    "l2key_scan": "erlvectordb_tpu/ops/fused_topk.py:551",
    "pos_scan": "erlvectordb_tpu/ops/fused_topk.py:335",
    "fused_scan": "erlvectordb_tpu/ops/fused_topk.py:989",
}


def emit(phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, **numbers}), flush=True)


def make_corpus(seed: int, n: int) -> np.ndarray:
    """bench.py make_corpus's recipe with numpy's generator."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((N_CENTRES, DIM), dtype=np.float32)
    z = centres[rng.integers(0, N_CENTRES, n)]
    z += NOISE * rng.standard_normal((n, DIM), dtype=np.float32)
    return z


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ------------------------------------------------------------------ kernels


def check_keys(name, kern, ref, exact):
    """Integer keys: bit-identical (exact) or, where f32 dots are summed in
    another order than cuBLAS's, one key step (1024) on <= 0.1% of entries."""
    import torch

    diff = kern.long() - ref.long()
    bad = diff != 0
    frac = int(bad.sum()) / bad.numel()
    steps_ok = bool(torch.all(diff[bad].abs() == 1024)) if frac else True
    if exact and frac:
        raise AssertionError(f"{name}: {frac:.2e} of keys differ")
    if not (frac <= 1e-3 and steps_ok):
        raise AssertionError(f"{name}: {frac:.2e} of keys differ (one-step: {steps_ok})")
    return float(diff.abs().max()), frac


def check_tile(name, kern, ref, exact_rows):
    """Masked extraction: rows identical (f32: on >= 99.9% of entries, the
    rest near-ties whose 11-bit keys straddle a step), vals to rtol 2.5e-4."""
    import torch

    (vk, rk), (vr, rr) = kern, ref
    same = rk == rr
    frac = int((~same).sum()) / same.numel()
    if frac > (0.0 if exact_rows else 1e-3):
        raise AssertionError(f"{name}: {frac:.2e} of rows differ")
    err = (vk[same] - vr[same]).abs()
    if not torch.all(err <= 2.5e-4 * vr[same].abs() + 1e-30):
        raise AssertionError(f"{name}: vals beyond rtol 2.5e-4")
    return float(err.max()), frac


def kernel_phase(stores, f32_codes, queries):
    import torch

    import erlvectordb_tpu_torch.ops.fused_topk as ft

    a, b, c = stores["a"], stores["b"], stores["c"]
    nt = ft.n_tiles_for(c._next_row, c.capacity)
    width = c._vectors.shape[1]
    qp = torch.zeros((BATCH, width), dtype=torch.float32, device=DEVICE)
    qp[:, :DIM] = torch.from_numpy(queries[:BATCH]).to(DEVICE)
    out = {}

    def run(name, variant, kern_fn, ref_fn, check, *args):
        kern, ref = kern_fn(), ref_fn()
        torch.cuda.synchronize()
        err, frac = check(f"{name}[{variant}]", kern, ref, *args)
        ms, plain_ms = cuda_ms(kern_fn), cuda_ms(ref_fn, reps=3)
        out.setdefault(name, {})[variant] = dict(
            max_abs_err=err, mismatch=frac, ms=ms, plain_ms=plain_ms)
        emit("kernel", name=name, variant=variant, max_abs_err=err,
             mismatch=frac, ms=ms, plain_ms=plain_ms, batch=BATCH,
             rows=nt * ft.TILE_N, width=width)

    # B1: cosine on the unit plane of store (a)
    q8, qmult, rowmult, rowbias, _ = ft._affine_factors(
        "cosine", a._scales, a._norms, a._valid, qp)
    run("intkey_scan", "int8", lambda: ft.intkey_scan(a._codes_unit, q8, nt),
        lambda: ft.intkey_scan_ref(a._codes_unit, q8, nt), check_keys, True)
    # B2: euclidean on the magnitude plane of store (b)
    q8b, bias = ft.l2key_inputs(qp, b._norms, b._plane_scale)
    run("l2key_scan", "int8", lambda: ft.l2key_scan(b._codes_unit, q8b, bias, nt),
        lambda: ft.l2key_scan_ref(b._codes_unit, q8b, bias, nt), check_keys, True)
    # B3: the pos window over store (c)'s absmax codes, and over f32 rows
    f, g, m, bv = ft._pos_window(c._vectors, c._scales, c._norms, c._valid, q8,
                                 qmult, rowmult, rowbias, "cosine")
    run("pos_scan", "int8",
        lambda: ft.pos_scan(c._vectors, q8, qmult, f, g, m, bv, nt, False),
        lambda: ft.pos_scan_ref(c._vectors, q8, qmult, f, g, m, bv, nt, False),
        check_keys, False)
    t = ft.t_per_tile_for(nt, 16)
    run("fused_scan", "int8",
        lambda: ft.fused_scan(c._vectors, q8, qmult, rowmult, rowbias, nt, t),
        lambda: ft.fused_scan_ref(c._vectors, q8, qmult, rowmult, rowbias, nt, t),
        check_tile, True)
    norms32 = c._norms  # the f32 rows are the same corpus
    qf, qmf, rmf, rbf, _ = ft._affine_factors("cosine", None, norms32, c._valid, qp)
    f, g, m, bv = ft._pos_window(f32_codes, None, norms32, c._valid, qf, qmf,
                                 rmf, rbf, "cosine")
    run("pos_scan", "f32",
        lambda: ft.pos_scan(f32_codes, qf, qmf, f, g, m, bv, nt, False),
        lambda: ft.pos_scan_ref(f32_codes, qf, qmf, f, g, m, bv, nt, False),
        check_keys, False)
    run("fused_scan", "f32",
        lambda: ft.fused_scan(f32_codes, qf, qmf, rmf, rbf, nt, t),
        lambda: ft.fused_scan_ref(f32_codes, qf, qmf, rmf, rbf, nt, t),
        check_tile, False)
    return out


# -------------------------------------------------------------------- slice


class Client:
    def __init__(self, port: int, token: str):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=600)
        self.buf = b""
        self.token = token
        self.next_id = 0

    def _line(self):
        while b"\n" not in self.buf:
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError("server closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\n", 1)
        return json.loads(line)

    def tools(self, calls):
        """Pipelined tools/call requests; answers matched by id."""
        ids, out = [], []
        for name, args in calls:
            self.next_id += 1
            ids.append(self.next_id)
            out.append(json.dumps({
                "jsonrpc": "2.0", "id": self.next_id, "method": "tools/call",
                "params": {"name": name, "arguments": args},
                "auth": {"token": self.token}}))
        self.sock.sendall(("\n".join(out) + "\n").encode())
        got = {}
        while len(got) < len(ids):
            resp = self._line()
            got[resp["id"]] = resp
        res = []
        for i in ids:
            if "error" in got[i]:
                raise RuntimeError(f"MCP error: {got[i]['error']}")
            res.append(json.loads(got[i]["result"]["content"][0]["text"]))
        return res

    def tool(self, tool_name, **args):
        return self.tools([(tool_name, args)])[0]


def b64(a) -> str:
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()).decode()


def batch_rows(client, store, qs):
    r = client.tool("search_vectors_batch", store=store, vectors_b64=b64(qs),
                    dim=DIM, k=K, encoding="b64")
    rows = np.frombuffer(base64.b64decode(r["rows_b64"]), "<i4").reshape(len(qs), K)
    dists = np.frombuffer(base64.b64decode(r["distances_b64"]), "<f4").reshape(len(qs), K)
    if not np.all(np.isfinite(dists)):
        raise AssertionError(f"{store}: non-finite distances")
    return rows


def exact_rows(corpus_dev, queries, metric):
    """Exact f32 top-k row indices on the card (the recall reference)."""
    import torch

    from erlvectordb_tpu_torch.ops.fused_topk import full_f32_matmul

    q = torch.from_numpy(queries).to(DEVICE)
    with full_f32_matmul():
        dots = q @ corpus_dev.T
    if metric == "cosine":
        score = dots / corpus_dev.norm(dim=1)[None, :]
    else:  # euclidean, up to the per-query constant |q|^2
        score = 2.0 * dots - (corpus_dev * corpus_dev).sum(dim=1)[None, :]
    return torch.topk(score, K, dim=1).indices.cpu().numpy()


def recall(got, want) -> float:
    return float(np.mean([len(set(g) & set(w)) / K for g, w in zip(got, want)]))


def slice_phase(db, corpus, queries, f32_rows):
    import torch

    import erlvectordb_tpu_torch.ops.fused_topk as ft
    from erlvectordb_tpu_torch.serve.mcp_server import MCPServer
    from erlvectordb_tpu_torch.utils.metrics import metrics

    server = MCPServer(db, host="127.0.0.1", port=0).start()
    try:
        port = server._sock.getsockname()[1]
        token = db.oauth.grant_client_credentials(
            "erlvectordb_client", "erlvectordb_secret")["access_token"]
        cl = Client(port, token)
        # (d): a 20k-row f32 store created and filled over MCP
        cl.tool("create_store", name="d", dimension=DIM, metric="cosine",
                dtype="float32")
        t0 = time.perf_counter()
        for i in range(0, len(f32_rows), 500):
            cl.tools([("insert_vector", {"store": "d", "id": str(j),
                                         "vector": f32_rows[j].tolist()})
                      for j in range(i, min(i + 500, len(f32_rows)))])
        insert_s = time.perf_counter() - t0
        nq = queries[:N_RECALL]
        # warm the batch path, then count launches over the requests alone
        for s in ("a", "b", "c", "d"):
            batch_rows(cl, s, nq[:8])
        ft.reset_launches()
        metrics.reset()
        hit = cl.tool("search_vectors", store="a", vector=corpus[123].tolist(), k=K)
        if hit["results"][0]["id"] != "123":
            raise AssertionError(f"search_vectors: {hit['results'][:2]}")
        mcp_batch_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            rows_a = batch_rows(cl, "a", queries[:BATCH])
            mcp_batch_s.append(time.perf_counter() - t0)
        rows_b = batch_rows(cl, "b", nq)
        rows_c = batch_rows(cl, "c", nq)
        rows_d = batch_rows(cl, "d", nq)
        # a fresh direction: int8 rescoring blurs cosine by ~1e-3, so the
        # vector must not sit that close to a stored row
        new = np.random.default_rng(SEED + 3).standard_normal(DIM).astype(np.float32)
        cl.tool("insert_vector", store="a", id="new", vector=new.tolist())
        first = cl.tool("search_vectors", store="a", vector=new.tolist(), k=K)
        if first["results"][0]["id"] != "new":
            raise AssertionError(f"inserted vector not first: {first['results'][:2]}")
        cl.tool("delete_vector", store="a", id="new")
        gone = cl.tool("search_vectors", store="a", vector=new.tolist(), k=K)
        if "new" in [h["id"] for h in gone["results"]]:
            raise AssertionError("deleted vector still returned")
        launches = {k.__name__: k.launches for k in ft.KERNELS}
        cl.sock.close()
    finally:
        server.stop()
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was never launched: {launches}")

    corpus_dev = torch.from_numpy(corpus).to(DEVICE)
    gt_cos = exact_rows(corpus_dev, nq, "cosine")
    gt_l2 = exact_rows(corpus_dev, nq, "euclidean")
    del corpus_dev
    gt_d = exact_rows(torch.from_numpy(f32_rows).to(DEVICE), nq, "cosine")
    rec = {"a_int8_intkey_cosine": recall(rows_a[:N_RECALL], gt_cos),
           "b_int8_intkey_euclidean": recall(rows_b, gt_l2),
           "c_int8_cosine": recall(rows_c, gt_cos),
           "d_f32_cosine_20k": recall(rows_d, gt_d)}
    if rec["a_int8_intkey_cosine"] < 0.95:
        raise AssertionError(f"recall@10 of store (a) below 0.95: {rec}")
    if rec["d_f32_cosine_20k"] < 0.99:
        raise AssertionError(f"f32 store (d) disagrees with exact search: {rec}")

    # end to end on the store API: 1024-query batches, host clock around
    # submit -> complete (the readback waits for the device)
    store_a = db.get_store("a")
    qa = queries[:BATCH]
    lat = []
    for _ in range(6):
        t0 = time.perf_counter()
        store_a.search_batch_complete_raw(store_a.search_batch_submit(qa, k=K))
        lat.append(time.perf_counter() - t0)
    lat = sorted(lat[1:])
    emit("slice", recall_at_10=rec, launches=launches,
         store_batch_ms_median=1e3 * lat[len(lat) // 2],
         store_qps=BATCH / lat[len(lat) // 2],
         mcp_b64_batch_ms_median=1e3 * float(np.median(mcp_batch_s)),
         mcp_b64_batch_ms_all=[1e3 * x for x in mcp_batch_s],
         mean_ms_by_span={k: v["mean_ms"] for k, v in
                          metrics.snapshot()["latencies"].items()},
         mcp_insert_rows_per_s=F32_ROWS / insert_s,
         device_bytes={s: db.get_store(s).device_memory_bytes() for s in "abcd"},
         torch_memory_allocated=int(torch.cuda.memory_allocated()),
         torch_max_memory_allocated=int(torch.cuda.max_memory_allocated()))
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import erlvectordb_tpu_torch.ops.fused_topk as ft
        from erlvectordb_tpu_torch.api import Database
        from erlvectordb_tpu_torch.core.store import VectorStore
        from erlvectordb_tpu_torch.infra.config import load_config
        from erlvectordb_tpu_torch.ops import cuda_lib
        from erlvectordb_tpu_torch.utils.metrics import device_stats
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1

    smi = nvidia_smi()
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, **device_stats(),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    regs = [ln.split("info    : ")[-1] for ln in
            cuda_lib.build_info.get("log", "").splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    emit("build", kernel_build_s=build_s, nvcc_report=regs)

    corpus = make_corpus(SEED, N_ROWS)
    queries = make_corpus(SEED + 1, BATCH)
    dev = torch.device(DEVICE)
    stores, build_ms = {}, {}
    for name, kw in (("a", dict(metric="cosine", intkey=True)),
                     ("b", dict(metric="euclidean", intkey=True)),
                     ("c", dict(metric="cosine"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stores[name] = VectorStore.from_matrix(name, corpus, dtype="int8",
                                               device=dev, **kw)
        torch.cuda.synchronize()
        build_ms[name] = 1e3 * (time.perf_counter() - t0)
    f32 = VectorStore.from_matrix("f32", corpus, device=dev)
    emit("build", store_build_ms=build_ms,
         build_rows_per_s_a=N_ROWS / (build_ms["a"] / 1e3),
         n_tiles=ft.n_tiles_for(N_ROWS, stores["a"].capacity))

    kernels = kernel_phase(stores, f32._vectors, queries)
    del f32
    torch.cuda.empty_cache()

    db = Database(load_config(overrides={"persistence_enabled": False}, env={}),
                  device=dev).start()
    try:
        for s in stores.values():
            db.registry.adopt(s)
        f32_rows = make_corpus(SEED + 2, F32_ROWS)
        launches = slice_phase(db, corpus, queries, f32_rows)
    finally:
        db.stop()

    summary = []
    for name, variants in kernels.items():
        main_v = variants["int8"]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in variants.values()),
            "ms": main_v["ms"], "plain_ms": main_v["plain_ms"],
            "variants": variants})
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
