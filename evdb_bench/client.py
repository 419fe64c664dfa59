"""One client process of a run: the load of some of a cell's connections.

    python3 -m evdb_bench.client      (started by the run; talks over pipes)

The run starts its client processes first, so that their start-up runs
beside the server's set-up, and writes each one JSON line (the job: request
kind, address, rate, connections, seed, seconds, the traffic's parameters)
and then the test queries as little-endian float32 to its standard input.
The process encodes every request of its connections and waits for
``CONNECT``: it then connects, sends each connection's warm-up requests,
writes ``READY <encode seconds> <warm-up seconds>`` and waits for
``GO <t0>``: ``t0`` is the window's start on ``time.perf_counter()``, which
on Linux is CLOCK_MONOTONIC and so shared by every process.  It then drives
the window and, once every request of the window is answered or the grace
period is over, writes one JSON line and the binary parts it announces (the
per-request records and each distinct answer) to its standard output, and
exits.  A closed standard input ends it at any step.

The loop is open: each connection sends on a Poisson schedule of
``rate_per_conn`` whether or not earlier requests were answered; latency is
taken from the time the request was due, so a stall is charged to every
request behind it, and the lateness of each send is recorded.  The schedule
is the same work for every seed (``spacings``): ``rate_per_conn * seconds``
requests, and the same set of gaps between them, in an order drawn from the
seed; the longest gap always closes the window, so the last request is due
at the same time in every run and a sound server answers it inside the
window.

What a request is comes from its kind, ``requests/<kind>.py``, found by the
name the traffic file gives: its transport (``grpc``, a unary call of its
``METHOD``; ``mcp``, a JSON-RPC line on TCP), the key of each request of a
connection, and the bytes of each key.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from evdb_bench.spec import ROOT, request_kind
from evdb_bench.wire import mcp_request

OK, ERROR, NONE = 1.0, 0.0, -1.0


def log(*a) -> None:
    print("[client]", *a, file=sys.stderr, flush=True)


def spacings(n: int, seconds: float) -> np.ndarray:
    """The ``n + 1`` gaps of ``n`` requests in a window of ``seconds``,
    ascending: the midpoint quantiles of the exponential distribution,
    scaled to fill the window: in any order, they stand for the spacings of
    a Poisson process conditioned on its count.  The last and longest closes
    the window."""
    q = -np.log1p(-(np.arange(n + 1) + 0.5) / (n + 1))
    return q * (seconds / q.sum())


class Conn:
    """One connection's schedule, sends and replies."""

    def __init__(self, job: dict, ci: int, queries: np.ndarray):
        self.job, self.ci = job, ci
        self.kind = request_kind(job["request"])
        traffic = job["traffic"]
        rng = np.random.default_rng([job["seed"], ci])
        seconds = job["seconds"]
        # every seed offers the same requests at the same gaps, in an order
        # drawn from the seed; the draws are those the schedule took before,
        # so the keys drawn after them are unchanged
        n = int(round(job["rate_per_conn"] * seconds))
        order = np.argsort(rng.uniform(0.0, seconds, n))
        self.due = np.cumsum(spacings(n, seconds)[:-1][order])
        self.keys = np.asarray(self.kind.keys(
            traffic, ci, rng, queries.shape[0], self.capacity()))
        self.payloads = {int(key): self.kind.encode(
            traffic, job["target"], job["k"], queries, int(key))
            for key in np.unique(self.keys)}
        # records: key, due, send, recv, status (times from t0, seconds)
        self.rec: List[list] = []
        self.answers: Dict[tuple, bytes] = {}
        self.counts: Dict[tuple, int] = {}
        self.lock = threading.Lock()
        self.inflight = 0
        self.done = threading.Condition(self.lock)

    def capacity(self) -> int:
        return len(self.due) + self.job["warmup_requests"]

    @property
    def grpc(self) -> bool:
        return self.kind.TRANSPORT == "grpc"

    # -------------------------------------------------------------- wire

    def connect(self):
        host, port = self.job["host"], self.job["port"]
        if self.grpc:
            import grpc

            self.chan = grpc.insecure_channel(f"{host}:{port}", options=[
                ("grpc.max_receive_message_length", 256 << 20),
                ("grpc.max_send_message_length", 256 << 20),
                ("grpc.use_local_subchannel_pool", 1)])
            self.call = self.chan.unary_unary(self.kind.METHOD)
        elif self.kind.TRANSPORT == "mcp":
            self.sock = socket.create_connection((host, port), timeout=600)
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self.pending: Dict[int, int] = {}   # JSON-RPC id -> record
            self.reader = threading.Thread(target=self._read_mcp, daemon=True)
            self.reader.start()
        else:
            raise ValueError(f"unknown transport {self.kind.TRANSPORT!r}")

    def close(self):
        if self.grpc:
            self.chan.close()
        else:
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.sock.close()
            self.reader.join(timeout=10)

    def _finish(self, idx: int, status: float, key, body: bytes) -> None:
        now = time.perf_counter() - self.t0
        with self.lock:
            rec = self.rec[idx]
            rec[3], rec[4] = now, status
            if status == OK and idx >= self.n_warm:
                akey = (key, hashlib.blake2b(body, digest_size=16).digest())
                if akey not in self.answers:
                    self.answers[akey] = body
                self.counts[akey] = self.counts.get(akey, 0) + 1
            self.inflight -= 1
            self.done.notify_all()

    def _read_mcp(self):
        buf = b""
        while True:
            try:
                chunk = self.sock.recv(1 << 20)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            *lines, buf = buf.split(b"\n")
            for line in lines:
                resp = json.loads(line)
                with self.lock:
                    idx = self.pending.pop(resp["id"])
                res = resp.get("result") or {}
                if "error" in resp or res.get("isError"):
                    log(f"conn {self.ci}: error reply {str(resp)[:300]}")
                    self._finish(idx, ERROR, None, b"")
                else:
                    text = res["content"][0]["text"].encode()
                    self._finish(idx, OK, int(self.rec[idx][0]), text)

    def send(self, idx: int) -> None:
        """Send request ``idx`` (its record exists)."""
        key = int(self.rec[idx][0])
        with self.lock:
            self.inflight += 1
        if self.grpc:
            fut = self.call.future(self.payloads[key], timeout=600)

            def cb(f, idx=idx, key=key):
                try:
                    body = f.result()
                except Exception as e:  # noqa: BLE001 — a failed request
                    log(f"conn {self.ci}: gRPC error {e!r}"[:400])
                    self._finish(idx, ERROR, None, b"")
                else:
                    self._finish(idx, OK, key, body)

            fut.add_done_callback(cb)
        else:
            with self.lock:
                self.pending[idx] = idx
            self.sock.sendall(mcp_request(idx, self.payloads[key]))

    def _new(self, key, due) -> int:
        with self.lock:
            self.rec.append([key, due, time.perf_counter() - self.t0, np.nan,
                             NONE])
            return len(self.rec) - 1

    # ------------------------------------------------------------- loops

    def warm(self) -> None:
        self.t0 = time.perf_counter()
        self.n_warm = self.job["warmup_requests"]
        for i in range(self.n_warm):
            idx = self._new(self.keys[i], 0.0)
            self.send(idx)
            with self.lock:
                while self.inflight:
                    self.done.wait()
            if self.rec[idx][4] != OK:
                raise RuntimeError(f"conn {self.ci}: warm-up request failed")

    def run(self, t0: float) -> None:
        self.t0 = t0
        i = self.n_warm
        for due in self.due:
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.send(self._new(self.keys[i], float(due)))
            i += 1
        deadline = t0 + self.job["seconds"] + self.job["grace_s"]
        with self.lock:
            while self.inflight and time.perf_counter() < deadline:
                self.done.wait(timeout=max(0.0, deadline - time.perf_counter()))


# ------------------------------------------------------ the run's side

READY_TIMEOUT_S = 240.0


@dataclass
class Clients:
    """The run's client processes.  With 4 cores or more they share the
    last core the run may use and every thread of this process (the
    server's, and those it starts later, which inherit the mask) is kept
    off it, so the load's own Python never takes the server's cores;
    ``stop`` puts the threads that were moved back."""
    procs: List[subprocess.Popen] = field(default_factory=list)
    restore: Dict[int, set] = field(default_factory=dict)
    ready_s: List[List[float]] = field(default_factory=list)
    layout: Dict[str, List[int]] = field(default_factory=dict)

    def pin(self) -> Optional[set]:
        cores = sorted(os.sched_getaffinity(0))
        if len(cores) < 4:
            return None
        self.layout = {"server": cores[:-1], "clients": cores[-1:]}
        for tid in os.listdir("/proc/self/task"):
            try:
                self.restore[int(tid)] = os.sched_getaffinity(int(tid))
                os.sched_setaffinity(int(tid), set(cores[:-1]))
            except OSError:   # a thread that has ended meanwhile
                pass
        return {cores[-1]}

    @classmethod
    def spawn(cls, n: int) -> "Clients":
        """Start ``n`` client processes; they wait for their job."""
        self = cls()
        client_core = self.pin()
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "")
                           .split(os.pathsep) if p])}
        try:
            for _ in range(n):
                p = subprocess.Popen(
                    [sys.executable, "-m", "evdb_bench.client"],
                    cwd=str(ROOT), env=env, stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE)
                self.procs.append(p)
                if client_core is not None:
                    os.sched_setaffinity(p.pid, client_core)
        except BaseException:
            self.stop()
            raise
        return self

    def feed(self, job: dict, groups: List[List[int]],
             queries: np.ndarray) -> None:
        """Each process its job (its group of connections) and the test
        queries; it encodes its requests meanwhile."""
        if len(groups) != len(self.procs):
            raise ValueError(f"{len(groups)} connection groups for "
                             f"{len(self.procs)} client processes")
        blob = np.ascontiguousarray(queries, "<f4").tobytes()
        for p, g in zip(self.procs, groups):
            p.stdin.write(json.dumps({**job, "connections": g}).encode()
                          + b"\n")
            p.stdin.write(blob)
            p.stdin.flush()

    def connect(self) -> None:
        """Connect and warm every client; returns when each is ready."""
        for p in self.procs:
            p.stdin.write(b"CONNECT\n")
            p.stdin.flush()
        box: Dict[int, bytes] = {}

        def ready(i, p):
            box[i] = p.stdout.readline()

        ts = [threading.Thread(target=ready, args=(i, p), daemon=True)
              for i, p in enumerate(self.procs)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(READY_TIMEOUT_S)
        bad = [i for i in range(len(self.procs))
               if not box.get(i, b"").startswith(b"READY ")]
        if bad:
            raise RuntimeError(f"client processes {bad} did not get ready")
        self.ready_s = [[float(x) for x in box[i].split()[1:]]
                        for i in range(len(self.procs))]

    def go(self, t0: float) -> None:
        for p in self.procs:
            p.stdin.write(f"GO {t0!r}\n".encode())
            p.stdin.flush()

    def results(self, timeout: float):
        """(records [n, 6], answer parts, answer blobs) of every client."""
        box: Dict[int, tuple] = {}

        def collect(i, p):
            head = json.loads(p.stdout.readline())
            rec = np.frombuffer(p.stdout.read(head["record_bytes"]),
                                "<f8").reshape(-1, 6)
            blobs = [p.stdout.read(n) for _key, n, _c in head["answers"]]
            box[i] = (rec, head["answers"], blobs)

        ts = [threading.Thread(target=collect, args=(i, p), daemon=True)
              for i, p in enumerate(self.procs)]
        for t in ts:
            t.start()
        deadline = time.perf_counter() + timeout
        for t in ts:
            t.join(max(0.0, deadline - time.perf_counter()))
        if len(box) != len(self.procs):
            raise RuntimeError("client processes gave no result in time")
        recs = np.concatenate([box[i][0] for i in range(len(self.procs))])
        parts = [a for i in range(len(self.procs)) for a in box[i][1]]
        blobs = [b for i in range(len(self.procs)) for b in box[i][2]]
        return recs, parts, blobs

    def stop(self) -> None:
        """End every client process and wait for each."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.stdin.close()
                except OSError:
                    pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs = []
        for tid, cores in self.restore.items():
            try:
                os.sched_setaffinity(tid, cores)
            except OSError:
                pass
        self.restore = {}


def client_groups(traffic: dict) -> List[List[int]]:
    conns, procs = traffic["connections"], traffic["processes"]
    return [list(range(conns))[i::procs] for i in range(procs)]


def read_exact(f, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = f.read(n - len(out))
        if not chunk:
            raise EOFError("run closed the pipe")
        out += chunk
    return bytes(out)


def main() -> int:
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    line = stdin.readline()
    if not line:
        return 0
    job = json.loads(line)
    nq, dim = job["n_queries"], job["dim"]
    queries = np.frombuffer(read_exact(stdin, nq * dim * 4),
                            "<f4").reshape(nq, dim)
    t = time.perf_counter()
    conns = [Conn(job, ci, queries) for ci in job["connections"]]
    encode_s = time.perf_counter() - t
    if stdin.readline().strip() != b"CONNECT":
        return 0
    t = time.perf_counter()
    for c in conns:
        c.connect()
    for c in conns:
        c.warm()
    stdout.write(f"READY {encode_s!r} {time.perf_counter() - t!r}\n"
                 .encode())
    stdout.flush()
    line = stdin.readline().split()
    if not line or line[0] != b"GO":
        return 0
    t0 = float(line[1])
    threads = [threading.Thread(target=c.run, args=(t0,)) for c in conns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c in conns:
        c.close()
    recs, blobs, parts = [], [], []
    for c in conns:
        for key, due, sent, recv, status in c.rec[c.n_warm:]:
            recs.append([c.ci, key, due, sent, recv, status])
        for (key, _h), body in c.answers.items():
            parts.append([int(key), len(body), c.counts[(key, _h)]])
            blobs.append(body)
    rec_bytes = np.asarray(recs, "<f8").reshape(-1, 6).tobytes()
    head = {"records": len(recs), "record_bytes": len(rec_bytes),
            "answers": parts}
    stdout.write(json.dumps(head).encode() + b"\n")
    stdout.write(rec_bytes)
    for b in blobs:
        stdout.write(b)
    stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
