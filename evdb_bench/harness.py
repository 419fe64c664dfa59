"""One run of one cell: set-up, the measured window, the comparison.

The program under test is ``erlvectordb_tpu_torch``: its ``Application``
runs in this process with MCP and gRPC on free ports and persistence off;
the load comes from client processes (``client.py``) that this run starts,
feeds and waits for.  The clients are started first and encode their
requests beside the server's set-up.  Set-up draws the configuration's test
queries and corpus from the seed on the device, builds the store with the
configuration's builder (``stores/<builder>.py``), lets the traffic's
request kind (``requests/<kind>.py``) prepare what it addresses (an index,
built over MCP's ``create_index`` and ``build_index``), warms the store's
search at the traffic's batch sizes, and then has the clients connect and
warm the served path with their own first requests.  The window starts when
every client is ready.
"""

from __future__ import annotations

import gc
import json
import math
import socket
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from evdb_bench import corpus, judge
from evdb_bench.client import Clients, client_groups
from evdb_bench.spec import Cell, read_metrics, request_kind, store_builder

GRACE_S = 60.0       # an answer may come this long after the window closes


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def service_ports() -> Dict[str, int]:
    """A free port for each of the program's services, chosen before the
    Application starts so that the clients can be told it."""
    from erlvectordb_tpu_torch.infra.config import SERVICES

    return {name: free_port() for name in SERVICES}


def app_config(ports: Dict[str, int], settings: Optional[dict] = None):
    """The deployment's server settings: every service on its port, alone
    in its range; by default persistence and OAuth off, REST off (no cell
    drives it), under the configuration's own ``server`` settings."""
    from erlvectordb_tpu_torch.infra.config import load_config

    services = {name: {"preferred_port": p, "range": (p, p)}
                for name, p in ports.items()}
    return load_config(overrides={
        "persistence_enabled": False, "oauth_enabled": False,
        "rest_api_enabled": False, "grpc_enabled": True,
        "development_mode": False, "container_mode": False,
        **(settings or {}), "services": services}, env={})


def mcp_call(port: int, name: str, args: dict, timeout: float = 330.0):
    """One synchronous MCP tool call; raises on an error reply."""
    req = {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
           "params": {"name": name, "arguments": args}}
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(json.dumps(req).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = s.recv(1 << 16)
            if not chunk:
                raise ConnectionError(f"MCP closed during {name}")
            buf += chunk
    resp = json.loads(buf.split(b"\n", 1)[0])
    if "error" in resp or resp["result"].get("isError"):
        raise RuntimeError(f"MCP {name}: {str(resp)[:400]}")
    return json.loads(resp["result"]["content"][0]["text"])


# ----------------------------------------------------------------- answers


def answers_of(kind, traffic: dict, parts, blobs, n_queries: int):
    """The distinct per-query answers [(query, row ids, distances)] in the
    clients' replies, read by the request kind ``kind``."""
    seen = set()
    out = []
    for (key, _n, _count), body in zip(parts, blobs):
        for qi, ids, dists in kind.answers(traffic, int(key), body,
                                           n_queries):
            ids = np.asarray(ids, np.int64)
            dists = np.asarray(dists, np.float64)
            akey = (qi, ids.tobytes(), dists.tobytes())
            if akey not in seen:
                seen.add(akey)
                out.append((qi, ids, dists))
    return out


# -------------------------------------------------------------------- run


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Served:
    """The program under test as set-up leaves it, serving one cell."""
    cell: Cell
    seed: int
    device: torch.device
    kind: object
    queries: torch.Tensor
    queries_np: np.ndarray
    ports: Dict[str, int]
    target: str
    app: object = None
    store: object = None
    spans: object = None
    phases: Dict[str, float] = field(default_factory=dict)
    lap: float = field(default_factory=time.perf_counter)

    def mark(self, name: str) -> None:
        _sync(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self.lap
        self.lap = now


def client_job(srv: Served, traffic: dict, seconds: float) -> dict:
    """What every client process is told: the request kind and the
    traffic's parameters, the address, the rate and the window."""
    cfg = srv.cell.config
    service = {"grpc": "grpc_server", "mcp": "mcp_server"}[
        srv.kind.TRANSPORT]
    return {"request": traffic["request"], "traffic": traffic,
            "host": "127.0.0.1", "port": srv.ports[service],
            "target": srv.target, "k": cfg["k"], "dim": cfg["dim"],
            "rate_per_conn": traffic.get("rate_per_s", 0.0)
            / traffic["connections"],
            "seed": int(srv.seed) % (1 << 63), "seconds": seconds,
            "warmup_requests": traffic["warmup_requests"], "grace_s": GRACE_S,
            "n_queries": int(srv.queries_np.shape[0])}


def serve(cell: Cell, seed: int, device, trace: bool,
          clients: Optional[Clients] = None,
          seconds: Optional[float] = None) -> Served:
    """Draw the queries (and hand them to ``clients``, with their job for a
    window of ``seconds``), draw the corpus, start the Application, build
    the store, let the request kind prepare its target (an index) and warm
    the store's search."""
    from erlvectordb_tpu_torch.app import Application

    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    kind = request_kind(traffic["request"])
    t_draw = time.perf_counter()
    queries = corpus.draw(cfg, seed, device, corpus.QUERIES)
    srv = Served(cell, seed, device, kind, queries, queries.cpu().numpy(),
                 service_ports(), kind.target(cfg), lap=t_draw)
    if clients is not None:
        clients.feed(client_job(srv, traffic, seconds), client_groups(traffic),
                     srv.queries_np)
    data = corpus.draw(cfg, seed, device, corpus.CORPUS)
    if trace:
        from evdb_bench.spans import Spans

        srv.spans = Spans().install()
    srv.app = Application(app_config(srv.ports, cfg.get("server")),
                          device=device).start()
    for name, port in srv.ports.items():
        got = srv.app.service_port(name)
        if got is not None and got != port:
            raise RuntimeError(f"{name} on port {got}, not {port}")
    srv.mark("draw_and_app")
    builder = store_builder(cfg["store"]["builder"])
    srv.store = builder.build(srv.app, cfg, data, device)
    del data
    srv.mark("store")
    prepare = getattr(kind, "prepare", None)
    if prepare is not None:
        port = srv.ports["mcp_server"]
        prepare(cfg, lambda name, args: mcp_call(port, name, args), log)
        srv.mark("prepare")
    builder.warm(srv.store, cfg, traffic)
    srv.mark("warm_store")
    return srv


@dataclass
class Window:
    t0: float
    t1: float
    setup_s: float
    recs: np.ndarray
    parts: list
    blobs: list
    hist: Dict[str, tuple]
    counters: Dict[str, float]
    peak: int
    events: Optional[list]


def measure(srv: Served, traffic: dict, seconds: float, trace: bool,
            t_start: float, clients: Optional[Clients] = None) -> Window:
    """Have the clients (fed by ``serve``, or started here) connect and
    warm up, and measure one window of ``seconds``; returns once every
    client has reported, with every client process ended."""
    from erlvectordb_tpu_torch.utils.metrics import metrics as prog_metrics

    tracer = None
    try:
        if clients is None:
            clients = Clients.spawn(traffic["processes"])
            clients.feed(client_job(srv, traffic, seconds),
                         client_groups(traffic), srv.queries_np)
        clients.connect()
        # set-up's garbage is collected before the window, as a server that
        # has run a while has done; the window sees only its own
        gc.collect()
        srv.mark("clients")
        log(f"cores: {json.dumps(clients.layout)}; client processes (s): "
            "encode " + json.dumps(
            [round(r[0], 4) for r in clients.ready_s]) + ", connect and warm "
            "up " + json.dumps([round(r[1], 4) for r in clients.ready_s]))
        if trace and srv.device.type == "cuda":
            from evdb_bench.devtrace import DeviceTrace

            tracer = DeviceTrace(srv.device)
            tracer.start()
        t0 = time.perf_counter() + 0.25
        clients.go(t0)
        time.sleep(max(0.0, t0 - time.perf_counter()))
        snap0 = prog_metrics.snapshot()
        t1 = t0 + seconds
        time.sleep(max(0.0, t1 - time.perf_counter()))
        snap1 = prog_metrics.snapshot()
        if tracer is not None:
            tracer.stop()
        peak = (torch.cuda.max_memory_allocated(srv.device)
                if srv.device.type == "cuda" else 0)
        recs, parts, blobs = clients.results(GRACE_S + 120.0)
    finally:
        if clients is not None:
            clients.stop()
    srv.mark("window")
    return Window(t0, t1, t0 - t_start, recs, parts, blobs,
                  _hist_delta(snap0, snap1), _counter_delta(snap0, snap1),
                  int(peak), tracer.events() if tracer is not None else None)


def run(cell: Cell, seed: int, seconds: int, trace: bool, device,
        t_start: float, clients: Optional[Clients] = None) -> dict:
    """Run ``cell`` once; returns the result line's object (and, under
    ``_check_lines``, the lines that print the compared numbers).  The
    client processes are those given (started early) or started here."""
    cfg, traffic = cell.config, cell.traffic
    k = cfg["k"]
    st = cfg["store"]
    if clients is None:
        clients = Clients.spawn(traffic["processes"])
    try:
        srv = serve(cell, seed, device, trace, clients, seconds)
        win = measure(srv, traffic, seconds, trace, t_start, clients)
    finally:
        clients.stop()
    kind = srv.kind
    device, queries, queries_np = srv.device, srv.queries, srv.queries_np
    t0, t1, setup_s, recs = win.t0, win.t1, win.setup_s, win.recs
    parts, blobs, peak, events = win.parts, win.blobs, win.peak, win.events
    hist, ctr, spans, phases = win.hist, win.counters, srv.spans, srv.phases
    if spans is not None:
        spans.uninstall()
    srv.app.stop()
    rows_served = srv.store.count
    srv.app = srv.store = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ------------------------------------------------------- correctness
    per_req = kind.queries_per_request(traffic)
    status = recs[:, 5]
    missing = int(np.sum(status < 0))
    failed = int(np.sum(status == 0)) + missing
    answers = answers_of(kind, traffic, parts, blobs,
                         int(queries_np.shape[0]))
    data = corpus.draw(cfg, seed, device, corpus.CORPUS)
    if hasattr(kind, "numbers"):     # a kind that judges its own answers
        values = kind.numbers(answers, queries, data, cfg, seed)
    else:
        values = judge.numbers(kind.ANSWERS, answers, queries, data, k,
                               bits=st.get("bits"))
    del data
    values["missing"] = float(missing)
    ok, checks = judge.verdict(values, cfg["correct"][kind.ANSWERS])
    srv.mark("reference")
    log("judged numbers: " + json.dumps(values))

    # -------------------------------------------------------- end to end
    qps, p50, p99, late = end_to_end(recs, seconds, per_req)
    good = status > 0
    log(f"requests {len(recs)} ({per_req} queries each), answered "
        f"{int(np.sum(good))}, failed {failed} (error replies "
        f"{int(np.sum(status == 0))}, never answered {missing}), shed by the "
        f"batcher {ctr.get('batcher.shed', 0)}; latency p50 {p50:.4f} ms, "
        f"p99 {p99:.4f} ms over {len(recs)} requests")
    log("latency p50 by quarter of the window (ms): " + json.dumps(
        [round(v, 4) for v in p50_by_part(recs, seconds, 4)]))
    if late.size:
        log(f"open loop: offered {traffic['rate_per_s']} req/s, sent "
            f"{len(recs) / seconds:.1f}/s; send lateness p50 "
            f"{np.percentile(late, 50):.4f} ms, p99 "
            f"{np.percentile(late, 99):.4f} ms, max {late.max():.4f} ms")
    log("set-up phases (s): " + json.dumps(
        {k_: round(v, 4) for k_, v in phases.items()}))
    log(f"served rows {rows_served}; device memory peak {peak} bytes")

    e2e = {"qps": qps, "setup_s": setup_s,
           "recall_at_10": values.get("recall_at_10")}
    result = {"correct": bool(ok), "attempted": int(len(recs)),
              "failed": failed}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        ctx = trace_context(cell, t0, t1, spans, hist, ctr, events)
        result["metrics"] = read_metrics(cell.per_layer, ctx)
        if events is not None:
            dev["busy_s"] = ctx["busy_s"]
            dev["window_s"] = ctx["window_s"]
            result["breakdown"] = breakdown(ctx)
    else:
        result["metrics"] = {
            m.name: {"value": float(e2e[m.name]), "unit": m.unit}
            for m in cell.end_to_end if e2e.get(m.name) is not None}
    result["device"] = dev
    result["checks"] = {
        name: {"value": v, ("min" if op == ">=" else "max"): lim}
        for name, v, op, lim in checks}
    result["_check_lines"] = [
        f"check {name} = {v!r} (limit {op} {lim!r})"
        for name, v, op, lim in checks]
    return result


def p50_by_part(recs: np.ndarray, seconds: float, parts: int) -> List[float]:
    """Latency p50 (ms, from the due time) of the requests due in each of
    ``parts`` equal parts of the window: a diagnostic of whether a run's
    latency drifts inside the window or only between runs."""
    due, recv, status = recs[:, 2], recs[:, 4], recs[:, 5]
    lat = np.where(status > 0, recv - due, seconds + GRACE_S - due)
    edges = np.linspace(0.0, seconds, parts + 1)
    out = []
    for a, b in zip(edges[:-1], edges[1:]):
        sel = (due >= a) & (due < b)
        out.append(float(np.percentile(lat[sel], 50)) * 1e3 if sel.any()
                   else math.nan)
    return out


def end_to_end(recs: np.ndarray, seconds: float, per_req: int):
    """(qps, p50 ms, p99 ms, send lateness ms) of the window's requests.

    ``recs`` rows: connection, key, due, sent, answered, status (times from
    the window's start; status 1 answered, 0 an error reply, -1 never
    answered).  The rate counts the queries answered inside the window.
    Latency runs from the time a request was due; a request that failed or
    was never answered counts as answered at the end of the grace period,
    so it misses any latency limit."""
    due, recv, status = recs[:, 2], recs[:, 4], recs[:, 5]
    good = status > 0
    lat = np.where(good, recv - due, seconds + GRACE_S - due)
    qps = float(np.sum(good & (recv <= seconds))) * per_req / seconds
    if not lat.size:
        return qps, math.nan, math.nan, np.zeros(0)
    return (qps, float(np.percentile(lat, 50)) * 1e3,
            float(np.percentile(lat, 99)) * 1e3, (recs[:, 3] - due) * 1e3)


def _hist_delta(s0: dict, s1: dict) -> Dict[str, tuple]:
    out = {}
    for name, h in s1["latencies"].items():
        h0 = s0["latencies"].get(name, {"count": 0, "sum_seconds": 0.0})
        out[name] = (h["count"] - h0["count"],
                     h["sum_seconds"] - h0["sum_seconds"])
    return out


def _counter_delta(s0: dict, s1: dict) -> Dict[str, float]:
    return {name: v - s0["counters"].get(name, 0)
            for name, v in s1["counters"].items()}


# ------------------------------------------------------------------ trace


def trace_context(cell: Cell, t0: float, t1: float, spans, hist, ctr,
                  events) -> dict:
    """What the per-layer readers read: the window, the harness spans, the
    program's counters and histograms over the window, the device trace."""
    from evdb_bench.devtrace import gaps, union

    ctx = {"cell": cell.name, "config": cell.config, "traffic": cell.traffic,
           "t0": t0, "t1": t1, "spans": spans, "hist": hist,
           "counters": ctr, "device_events": None}
    if events is not None:
        ev = [(n, max(s, t0), min(e, t1)) for n, s, e in events
              if e > t0 and s < t1]
        busy = union([(s, e) for _n, s, e in ev], t0, t1)
        ctx.update(device_events=ev, busy=busy,
                   idle=gaps(busy, t0, t1),
                   busy_s=float(sum(e - s for s, e in busy)),
                   window_s=float(t1 - t0))
    return ctx


def _open_at(spans, t: float) -> str:
    names = [name for name in ("frontend.grpc", "frontend.mcp", "store",
                               "index")
             if any(s[0] <= t <= s[1] for s in spans.spans[name])]
    return "+".join(names) if names else "no request span open"


def breakdown(ctx: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the harness spans open on the host meanwhile."""
    by_name: Dict[str, float] = {}
    for n, s, e in ctx["device_events"]:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(ctx["idle"], key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n[:200], v] for n, v in ops],
            "idle_gaps": [[_open_at(ctx["spans"], (s + e) / 2), e - s]
                          for s, e in idle]}
