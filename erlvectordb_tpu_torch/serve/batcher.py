"""Query micro-batcher — coalesces concurrent search requests into device
batches and keeps the device pipeline full.

The device answers 1024 queries in barely more time than 1 (one scan +
top-k either way), but protocol requests arrive one at a time.  The
reference actually *serializes* concurrent searches through a gen_server
(src/vector_store.erl:143-150); this does the opposite, in two stages:

  collector thread:  drain the queue, group by (store, k, metric, filter),
                     DISPATCH one ``search_batch_submit`` per group — CUDA
                     launches are async, so the next batch is enqueued while
                     the previous still executes on device;
  completion thread: block on each ticket's device->host readback
                     (``search_batch_complete``) and map rows to ids;
  delivery thread:   run caller callbacks — JSON serialization and socket
                     sends live HERE, off the readback-critical thread.

Round 1 ran dispatch -> readback -> host mapping serially per batch, so the
device idled during every readback + mapping + JSON phase; the split keeps
batch i+1 computing while batch i is being read back and delivered.  The
round-4 delivery split (ROADMAP #4 / VERDICT r3 #5) removes the LAST host
work from the readback path: on rigs where readbacks serialize, a callback
that spends 1-2 ms JSON-encoding a 4096-query response used to stall the
next batch's readback by that much; now the completion thread loops
straight into the next ticket.  Per-batch host time is decomposed in
/metrics: ``batcher.readback`` (device wait + row->id mapping) vs
``batcher.deliver`` (serialization + send).

Spans (utils/metrics.py): each request's ``batcher.queue_wait`` (submit to
dispatch) carries its device batch's id as parent; the batch's own
``batcher.inflight_wait`` (the in-flight semaphore), ``batcher.
completion_wait`` and ``batcher.delivery_wait`` (each hand-off queue, put
to get) carry that id, as do the store's spans of its ticket.  A group
(``submit_group``) is one request: its batch id is the request's own.

Callers either block (``search``, ``search_group``) or register a callback
(``submit``, ``submit_group``) — the MCP server uses callbacks so one
connection can pipeline thousands of in-flight requests without one thread
each.

The batcher owns the served route (``_direct``): a request with
``nprobe`` or ``recall_target`` (the sub-linear multiprobe path, whose
point is to skip the window), or any request once the batcher is stopped,
calls the store on the caller's thread and answers there; every other
request rides a device batch.  The frontends decode, call the batcher and
encode.
"""

from __future__ import annotations

import json
import queue
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from erlvectordb_tpu_torch.utils.metrics import metrics, now_ns


class OverloadedError(RuntimeError):
    """Raised/delivered when the batcher's waiting queue is full."""


@dataclass
class _Pending:
    query: np.ndarray
    cb: Optional[Callable[[Any, Optional[Exception]], None]] = None
    event: Optional[threading.Event] = None
    result: Any = None
    error: Optional[Exception] = None
    rid: int = 0         # the request's id (metrics.current at submit)
    t_queued: int = 0    # perf_counter_ns at enqueue
    batch: int = 0       # its device batch's id, once dispatched


class QueryBatcher:
    def __init__(self, get_store, max_batch: int = 256, max_wait: float = 0.002,
                 max_inflight: int = 8, max_queue: int = 8192,
                 min_wait: float = 0.0002):
        """``get_store(name)`` resolves a store (Database.any_store).
        ``max_inflight`` bounds dispatched-but-unread device batches (device
        queue depth / memory backpressure).

        The collection window is ADAPTIVE between ``min_wait`` and
        ``max_wait``: while the device is busy (batches in flight) the
        collector waits up to half the EWMA batch service time — extra
        waiting is free when the device is the bottleneck and grows the
        batch; when the device is idle it waits only ``min_wait`` so a lone
        query is not taxed the full window.  ``max_queue`` bounds waiting
        requests across all groups; past it, submits fail fast with
        ``OverloadedError`` instead of growing an unbounded backlog."""
        self._get_store = get_store
        self.max_batch = max_batch
        self.max_wait = max_wait
        self.min_wait = min_wait
        self.max_queue = max_queue
        self._queues: Dict[Tuple, List[_Pending]] = defaultdict(list)
        self._depth = 0                      # waiting requests, under _lock
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._completer: Optional[threading.Thread] = None
        self._deliverer: Optional[threading.Thread] = None
        self._completion_q: "queue.Queue" = queue.Queue()
        self._delivery_q: "queue.Queue" = queue.Queue()
        self._inflight = threading.Semaphore(max_inflight)
        self._inflight_n = 0                 # gauge mirror of the semaphore
        self._service_ewma = 0.0             # seconds per device batch

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "QueryBatcher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="evdb-batcher", daemon=True
            )
            self._completer = threading.Thread(
                target=self._completion_loop, name="evdb-batcher-complete",
                daemon=True,
            )
            self._deliverer = threading.Thread(
                target=self._delivery_loop, name="evdb-batcher-deliver",
                daemon=True,
            )
            self._thread.start()
            self._completer.start()
            self._deliverer.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        self._completion_q.put(None)  # sentinel
        if self._completer is not None:
            self._completer.join(timeout=2)
            self._completer = None
        self._delivery_q.put(None)  # sentinel (after the completer drained)
        if self._deliverer is not None:
            self._deliverer.join(timeout=2)
            self._deliverer = None
        # fail anything still queued
        with self._lock:
            leftovers = [p for q in self._queues.values() for p in q]
            self._queues.clear()
            self._depth = 0
        err = RuntimeError("batcher stopped")
        for p in leftovers:
            self._deliver(p, None, err)

    def is_alive(self) -> bool:
        """True until ``stop()``: requests ride device batches (a batcher
        not yet started holds them until ``start()``)."""
        return not self._stop.is_set()

    def _direct(self, nprobe, recall_target) -> bool:
        """The route: the store on the caller's thread, or a device batch."""
        return (nprobe is not None or recall_target is not None
                or not self.is_alive())

    def _search_now(self, rid: int, store: str, queries, k, metric, where,
                    nprobe, recall_target, raw: bool):
        """The direct route: ``(answer, error)`` of a [B, D] batch, searched
        on this thread under the request's id."""
        try:
            with metrics.bound(rid):
                st = self._get_store(store)
                t = st.search_batch_submit(queries, k=k, metric=metric,
                                           where=where, nprobe=nprobe,
                                           recall_target=recall_target)
                return (st.search_batch_complete_raw(t) if raw
                        else st.search_batch_complete(t)), None
        except Exception as e:  # noqa: BLE001 — the caller's error
            return None, e

    # ----------------------------------------------------------------- API

    def submit(self, store: str, query, k: int = 10,
               metric: Optional[str] = None, where: Optional[dict] = None,
               callback: Optional[Callable] = None,
               nprobe: Optional[int] = None,
               recall_target: Optional[float] = None) -> Optional[_Pending]:
        """Enqueue a search.  With ``callback``, it is invoked as
        ``callback(result, error)`` on the delivery thread (on this thread
        for the direct route); without one, a waitable ``_Pending`` (with
        ``.event``) is returned."""
        p = _Pending(np.asarray(query, np.float32), cb=callback,
                     rid=metrics.current()[0] or metrics.new_id())
        if callback is None:
            p.event = threading.Event()
        if p.query.ndim != 1:
            # reject HERE: the group key only covers the trailing dim, so a
            # 2-D query with the right trailing dim would land in a healthy
            # group and fail the whole batch's np.stack for every caller
            self._deliver(p, None, ValueError(
                f"query must be 1-D, got shape {p.query.shape}"))
            return p
        if self._direct(nprobe, recall_target):
            out, err = self._search_now(p.rid, store, p.query[None, :], k,
                                        metric, where, nprobe, recall_target,
                                        raw=False)
            self._deliver(p, None if err else out[0], err)
            return p
        # dimension is part of the key so one malformed query cannot poison
        # a whole batch with a stacking error; filters batch with equal filters
        where_key = json.dumps(where, sort_keys=True) if where else None
        key = (store, int(k), metric, int(p.query.shape[-1]), where_key)
        p.t_queued = now_ns()
        with self._lock:
            if self._depth >= self.max_queue:
                metrics.inc("batcher.shed")
                err = OverloadedError(
                    f"batcher queue full ({self.max_queue} waiting)")
                self._deliver(p, None, err)
                return p
            self._queues[key].append(p)
            self._depth += 1
            first = self._depth == 1
            depth = len(self._queues[key])
        metrics.inc("batcher.enqueued")
        metrics.gauge("batcher.queue_depth", self._depth)
        if first or depth >= self.max_batch:
            # first request into an idle batcher: wake the collector from
            # its long idle sleep (it otherwise busy-polled at min_wait
            # ~5000x/s on every idle deployment)
            self._wake.set()
        return p

    def submit_group(self, store: str, queries, k: int = 10,
                     metric: Optional[str] = None, where: Optional[dict] = None,
                     callback: Callable = None, raw: bool = False,
                     nprobe: Optional[int] = None,
                     recall_target: Optional[float] = None) -> None:
        """Dispatch a pre-batched [B, D] query matrix as ONE device batch
        through the same in-flight/completion pipeline.  ``callback`` gets
        ``(list_of_per_query_results, error)`` on the delivery thread (on
        this thread for the direct route) — or, with ``raw=True``,
        ``((dists, rows, ids) columns, error)`` without per-hit tuples (the
        binary serving encoding).
        This is the MCP ``search_vectors_batch`` fast path."""
        bid = metrics.current()[0] or metrics.new_id()
        if self._direct(nprobe, recall_target):
            callback(*self._search_now(bid, store, queries, k, metric, where,
                                       nprobe, recall_target, raw))
            return
        n = int(np.shape(queries)[0])
        t_d = now_ns()
        self._acquire_inflight()
        t_a = metrics.end("batcher.inflight_wait", bid, t_d, n)
        try:
            store_obj = self._get_store(store)
            with metrics.bound(bid):
                ticket = store_obj.search_batch_submit(
                    queries, k=k, metric=metric, where=where)
        except Exception as e:  # noqa: BLE001
            self._release_inflight()
            callback(None, e)
            return
        # hand the ticket over first: the registry's lock is not the
        # completion thread's business
        self._completion_q.put((store_obj, ticket, callback, raw, t_a, bid, n,
                                now_ns()))
        metrics.inc("batcher.batched_queries", n)

    def search(self, store: str, query, k: int = 10,
               metric: Optional[str] = None, timeout: float = 300.0,
               where: Optional[dict] = None, nprobe: Optional[int] = None,
               recall_target: Optional[float] = None):
        """Blocking ``submit``: one query's hits."""
        p = self.submit(store, query, k=k, metric=metric, where=where,
                        nprobe=nprobe, recall_target=recall_target)
        if not p.event.wait(timeout):
            raise TimeoutError("batched search timed out")
        if p.error is not None:
            raise p.error
        return p.result

    def search_group(self, store: str, queries, k: int = 10,
                     metric: Optional[str] = None,
                     where: Optional[dict] = None, raw: bool = False,
                     timeout: float = 300.0, nprobe: Optional[int] = None,
                     recall_target: Optional[float] = None):
        """Blocking ``submit_group``: the batch's hits, or its columns."""
        done = threading.Event()
        box: Dict[str, Any] = {}

        def cb(out, err):
            box["out"], box["err"] = out, err
            done.set()

        self.submit_group(store, queries, k=k, metric=metric, where=where,
                          callback=cb, raw=raw, nprobe=nprobe,
                          recall_target=recall_target)
        if not done.wait(timeout):
            raise TimeoutError("batched search timed out")
        if box["err"] is not None:
            raise box["err"]
        return box["out"]

    # ----------------------------------------------------------------- loops

    @staticmethod
    def _deliver(p: _Pending, result, error) -> None:
        p.result = result
        p.error = error
        if p.cb is not None:
            try:
                p.cb(result, error)
            except Exception:  # noqa: BLE001 — a bad callback must not kill the loop
                pass
        if p.event is not None:
            p.event.set()

    def _effective_wait(self) -> float:
        """Adaptive collection window.  Fully idle (nothing queued, nothing
        in flight) -> long sleep, woken by the first submit; device busy ->
        up to half the EWMA batch service time (bounded by max_wait);
        device idle but requests queued -> min_wait."""
        if self._depth == 0 and self._inflight_n == 0:
            return 0.5  # idle heartbeat; submit()/stop() set _wake
        if self._inflight_n == 0:
            return self.min_wait
        half = self._service_ewma / 2.0
        return min(self.max_wait, max(self.min_wait, half))

    def _loop(self) -> None:
        """Collector: group + dispatch (never blocks on the device)."""
        while not self._stop.is_set():
            self._wake.wait(self._effective_wait())
            self._wake.clear()
            with self._lock:
                batches = {k: v for k, v in self._queues.items() if v}
                self._queues.clear()
                self._depth = 0
            metrics.gauge("batcher.queue_depth", 0)
            for (store_name, k, metric, _dim, where_key), pendings in batches.items():
                # cap each device batch; oversize groups split
                for i in range(0, len(pendings), self.max_batch):
                    self._dispatch(store_name, k, metric,
                                   pendings[i : i + self.max_batch], where_key)

    def _acquire_inflight(self) -> None:
        self._inflight.acquire()
        with self._lock:  # += on a plain int races across the three threads
            self._inflight_n += 1
            n = self._inflight_n
        metrics.gauge("batcher.inflight", n)

    def _release_inflight(self) -> None:
        with self._lock:
            self._inflight_n -= 1
            n = self._inflight_n
        self._inflight.release()
        metrics.gauge("batcher.inflight", n)

    def _dispatch(self, store_name: str, k: int, metric: Optional[str],
                  pendings: List[_Pending], where_key=None) -> None:
        bid, n = metrics.new_id(), len(pendings)
        t_d = now_ns()
        for p in pendings:
            p.batch = bid
            metrics.record("batcher.queue_wait", p.rid, bid, p.t_queued, t_d)
        self._acquire_inflight()
        t_a = metrics.end("batcher.inflight_wait", bid, t_d, n)
        try:
            where = json.loads(where_key) if where_key else None
            store = self._get_store(store_name)
            qs = np.stack([p.query for p in pendings])
            metrics.bind(bid)
            ticket = store.search_batch_submit(qs, k=k, metric=metric,
                                               where=where)
        except Exception as e:  # noqa: BLE001 — deliver the error per caller
            self._release_inflight()
            for p in pendings:
                self._deliver(p, None, e)
            return
        self._completion_q.put((store, ticket, pendings, False, t_a, bid, n,
                                now_ns()))
        metrics.inc("batcher.batched_queries", n)
        metrics.observe("batcher.batch_size", float(n))

    def _completion_loop(self) -> None:
        """Readback + host mapping, overlapped with dispatch.  Delivery
        (caller callbacks: JSON serialization, socket sends) is handed to
        the delivery thread so the next ticket's readback starts
        immediately."""
        while True:
            item = self._completion_q.get()
            if item is None:
                return
            store, ticket, pendings, raw, t_a, bid, n, t_put = item
            t_g = metrics.end("batcher.completion_wait", bid, t_put, n)
            results, err = None, None
            try:
                results = (store.search_batch_complete_raw(ticket) if raw
                           else store.search_batch_complete(ticket))
            except Exception as e:  # noqa: BLE001
                err = e
            finally:
                t_c = now_ns()
                metrics.observe("batcher.readback", (t_c - t_g) / 1e9)
                metrics.inc("batcher.readback_total")
                # EWMA of dispatch->completion service time drives the
                # adaptive collection window
                dt = (t_c - t_a) / 1e9
                self._service_ewma = (0.8 * self._service_ewma + 0.2 * dt
                                      if self._service_ewma else dt)
                metrics.gauge("batcher.service_ewma_ms",
                              round(self._service_ewma * 1e3, 3))
                self._release_inflight()
            self._delivery_q.put((pendings, results, err, bid, n, t_c))

    def _delivery_loop(self) -> None:
        """Caller callbacks, FIFO (per-connection response order is
        preserved — one delivery thread).  All serving-layer host work
        (per-hit JSON, base64 columns, sendall) happens here, measured as
        ``batcher.deliver`` — the decomposition that separates host cost
        from the rig's readback RTT."""
        while True:
            item = self._delivery_q.get()
            if item is None:
                return
            pendings, results, err, bid, n, t_put = item
            t_g = metrics.end("batcher.delivery_wait", bid, t_put, n)
            # each callback runs bound to its own request, so the spans it
            # closes (an MCP reply) name the batch as their parent
            if callable(pendings):  # group callback (submit_group)
                metrics.bind(bid)
                try:
                    pendings(results, err)
                except Exception:  # noqa: BLE001 — must not kill the loop
                    pass
            elif err is not None:
                for p in pendings:
                    metrics.bind(p.rid, bid)
                    self._deliver(p, None, err)
            else:
                for p, r in zip(pendings, results):
                    metrics.bind(p.rid, bid)
                    self._deliver(p, r, None)
            metrics.observe("batcher.deliver", (now_ns() - t_g) / 1e9)
            metrics.inc("batcher.deliver_total")
