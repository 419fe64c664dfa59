"""Metrics + tracing — the observability the reference lacks.

The reference's only instrumentation is timer:tc inside its compression
benchmark and per-health-check durations (SURVEY §5); the rebuild provides:

  * :class:`MetricsRegistry` — process-wide counters and latency histograms
    (lock-free enough: GIL-protected dict updates), exported as JSON and in
    Prometheus text format (the reference's unchecked roadmap item);
  * :func:`timed` — context manager recording a latency sample;
  * request-scoped spans (:meth:`MetricsRegistry.record`, ``span``, and
    :func:`now_ns` then ``end`` for an interval that crosses threads):
    ``(name, rid, parent, start_ns, end_ns, n)`` on
    ``time.perf_counter_ns()``, the clock a device trace is mapped onto, kept
    in a bounded ring (:class:`SpanRing`) and read back with
    ``spans_between``; always on;
  * :func:`device_stats` — the serving device's name and allocated bytes.

``/metrics`` (the REST server) shows the counters, gauges and histograms.
The served request histograms, each with a ``_total`` counter, are
``mcp.<method>`` (from the request's first byte to its reply's
``sendall``, also for searches the batcher answers), ``store.search``
(submit to readback, every completion), ``store.insert``,
``batcher.readback`` (readback and id mapping) and ``batcher.deliver``
(serialization and send); ``trace.dropped`` counts the spans the ring
overwrote, and is absent while 0.  The spans themselves stay in the
process.

A request id (``rid``) is opened where a request enters the program (the
gRPC deserializer, the MCP connection loop) and bound to the thread that
works for it (``bind`` / ``current``); where the work crosses threads the id
rides the object handed over (the batcher's pending, the store's search
ticket).  A coalesced device batch has an id of its own, which each of its
requests' spans after the dispatch carries as ``parent``.
"""

from __future__ import annotations

import contextlib
import itertools
import struct
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

now_ns = time.perf_counter_ns

# Records the ring holds.  The busiest served path, single MCP searches
# through the batcher, writes 4 spans a request (mcp.request, mcp.parse,
# batcher.queue_wait, mcp.encode) and 6 a device batch (batcher.
# inflight_wait, store.submit, batcher.completion_wait, store.readback,
# store.map, batcher.delivery_wait): at most 10 a request, batches of one.
# At 500 requests/s a 20 s window is at most 100,000 records (58,242-73,730
# on an H100 host, batches of 2-3); 2**19 = 524,288 is over 5x that.  A slot
# is 48 bytes, so the ring holds 24 MiB from the start and never more.
SPAN_CAPACITY = 1 << 19

_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 5e-1, 1.0, 5.0)


class Histogram:
    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self):
        self.buckets = _BUCKETS
        self.counts = [0] * (len(_BUCKETS) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, seconds: float) -> None:
        self.total += 1
        self.sum += seconds
        for i, b in enumerate(self.buckets):
            if seconds <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def snapshot(self) -> dict:
        return {
            "count": self.total,
            "sum_seconds": round(self.sum, 6),
            "mean_ms": round(self.sum / self.total * 1e3, 3) if self.total else None,
            "buckets": {
                f"le_{b}": c for b, c in zip(self.buckets, self.counts)
            } | {"inf": self.counts[-1]},
        }


Span = Tuple[str, int, int, int, int, int]  # name, rid, parent, start, end, n


_RECORD = struct.Struct("<qqqqqii")   # number, rid, parent, start, end,
_SLOT = _RECORD.size                   # name code, n: 48 bytes
_RECORD_DTYPE = np.dtype([("num", "<i8"), ("rid", "<i8"), ("parent", "<i8"),
                          ("start", "<i8"), ("end", "<i8"),
                          ("code", "<i4"), ("n", "<i4")])


class SpanRing:
    """A bounded ring of span records in one preallocated buffer, with no
    lock on its append path.  A slot is claimed by ``next`` on an
    ``itertools.count`` (one C call, so two threads never get the same
    slot) and filled by one ``pack_into`` call; a reader copies the buffer
    with one ``bytes`` call.  Neither releases the GIL, so no record is
    read half written.  Once full, each append overwrites the oldest
    record (``dropped``)."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.capacity = capacity
        self._mask = capacity - 1
        self._seq = itertools.count()
        self._codes: Dict[str, int] = {}
        self._names: List[str] = []
        self._code_lock = threading.Lock()
        self._buf = bytearray(_SLOT * capacity)
        np.frombuffer(self._buf, _RECORD_DTYPE)["num"] = -1   # no record
        self._pack = _RECORD.pack_into

    def _code(self, name: str) -> int:
        with self._code_lock:
            code = self._codes.get(name)
            if code is None:
                code = self._codes[name] = len(self._names)
                self._names.append(name)
            return code

    def append(self, name: str, rid: int, parent: int, start_ns: int,
               end_ns: int, n: int) -> None:
        code = self._codes.get(name)
        if code is None:
            code = self._code(name)
        i = next(self._seq)
        self._pack(self._buf, (i & self._mask) * _SLOT, i, rid, parent,
                   start_ns, end_ns, code, n)

    def records(self) -> np.ndarray:
        """The records the ring holds (``_RECORD_DTYPE``), oldest first."""
        recs = np.frombuffer(bytes(self._buf), _RECORD_DTYPE)
        recs = recs[recs["num"] >= 0]
        return recs[np.argsort(recs["num"], kind="stable")]

    def dropped(self) -> int:
        """Records overwritten since the ring was made."""
        last = int(np.frombuffer(self._buf, _RECORD_DTYPE)["num"].max())
        return max(0, last + 1 - self.capacity)

    def between(self, t0_ns: int, t1_ns: int) -> Optional[List[Span]]:
        """The records whose interval meets [t0_ns, t1_ns], oldest first;
        None where records overwritten may have met it (the oldest record
        left ended after ``t0_ns``: records are written as they end)."""
        recs = self.records()
        if not recs.size:
            return []
        if recs["num"][-1] + 1 > self.capacity and recs["end"][0] > t0_ns:
            return None
        recs = recs[(recs["end"] >= t0_ns) & (recs["start"] <= t1_ns)]
        names = self._names
        return [(names[c], r, p, s, e, m) for c, r, p, s, e, m in zip(
            *(recs[f].tolist() for f in ("code", "rid", "parent", "start",
                                         "end", "n")))]


class _Span:
    """``MetricsRegistry.span``: one clock read on entry, one on exit."""
    __slots__ = ("reg", "name", "rid", "parent", "n", "start")

    def __init__(self, reg, name, rid, parent, n):
        self.reg, self.name, self.rid, self.parent, self.n = (
            reg, name, rid, parent, n)

    def __enter__(self) -> "_Span":
        self.start = now_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.reg._ring.append(self.name, self.rid, self.parent, self.start,
                              now_ns(), self.n)


class MetricsRegistry:
    def __init__(self, span_capacity: int = SPAN_CAPACITY):
        self._counters: Dict[str, int] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._gauges: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.started_at = time.time()
        self._span_capacity = span_capacity
        self._ring = SpanRing(span_capacity)
        self._ids = itertools.count(1)
        self._bound = threading.local()

    def inc(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def gauge(self, name: str, value: float) -> None:
        """Set an instantaneous value (queue depth, in-flight count, ...)."""
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:  # the histogram mutation itself must be locked:
            # total/sum/counts are read-modify-write from many threads
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            h.observe(seconds)

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)
            self.inc(name + "_total")

    # ------------------------------------------------------------- spans

    def new_id(self) -> int:
        """A fresh request (or batch) id, never 0."""
        return next(self._ids)

    def bind(self, rid: int, parent: int = 0) -> None:
        """Make ``rid`` (of a request whose batch is ``parent``) the one
        this thread works for."""
        b = self._bound
        b.rid, b.parent = rid, parent

    def current(self) -> Tuple[int, int]:
        """(rid, parent) bound to this thread; (0, 0) where none is."""
        b = self._bound
        return getattr(b, "rid", 0), getattr(b, "parent", 0)

    @contextlib.contextmanager
    def bound(self, rid: int, parent: int = 0) -> Iterator[None]:
        """Bind ``rid`` for a block, restoring the thread's own after."""
        old = self.current()
        self.bind(rid, parent)
        try:
            yield
        finally:
            self.bind(*old)

    def record(self, name: str, rid: int, parent: int, start_ns: int,
               end_ns: int, n: int = 1) -> None:
        """Append one span whose two clock reads the caller took."""
        self._ring.append(name, rid, parent, start_ns, end_ns, n)

    def span(self, name: str, rid: Optional[int] = None, n: int = 1,
             parent: Optional[int] = None) -> _Span:
        """Context manager recording ``name`` around a block, for the
        thread's bound request unless ``rid`` is given."""
        if rid is None or parent is None:
            b_rid, b_parent = self.current()
            rid = b_rid if rid is None else rid
            parent = b_parent if parent is None else parent
        return _Span(self, name, rid, parent, n)

    def end(self, name: str, rid: int, start_ns: int, n: int = 1,
            parent: int = 0) -> int:
        """Close an interval begun at ``start_ns`` (a :func:`now_ns` read,
        maybe on another thread); returns its end."""
        t = now_ns()
        self._ring.append(name, rid, parent, start_ns, t, n)
        return t

    def spans_between(self, t0: float, t1: float) -> Optional[List[Span]]:
        """Spans meeting [t0, t1] (``time.perf_counter()`` seconds) as
        ``(name, rid, parent, start_ns, end_ns, n)``; None where the ring
        no longer holds all of them."""
        return self._ring.between(int(t0 * 1e9), int(t1 * 1e9))

    def _counters_now(self) -> Dict[str, int]:
        """The counters, with ``trace.dropped`` (spans overwritten in the
        ring) once it is not 0."""
        out = dict(self._counters)
        dropped = self._ring.dropped()
        if dropped:
            out["trace.dropped"] = dropped
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uptime_seconds": round(time.time() - self.started_at, 1),
                "counters": self._counters_now(),
                "gauges": dict(self._gauges),
                "latencies": {k: h.snapshot() for k, h in self._histograms.items()},
            }

    def prometheus(self) -> str:
        """Prometheus exposition format (reference roadmap item README:1525)."""
        lines: List[str] = []
        with self._lock:
            for name, v in sorted(self._counters_now().items()):
                safe = "evdb_" + name.replace(".", "_").replace("-", "_")
                lines.append(f"# TYPE {safe} counter")
                lines.append(f"{safe} {v}")
            for name, v in sorted(self._gauges.items()):
                safe = "evdb_" + name.replace(".", "_").replace("-", "_")
                lines.append(f"# TYPE {safe} gauge")
                lines.append(f"{safe} {v}")
            for name, h in sorted(self._histograms.items()):
                safe = "evdb_" + name.replace(".", "_").replace("-", "_")
                lines.append(f"# TYPE {safe} histogram")
                cum = 0
                for b, c in zip(h.buckets, h.counts):
                    cum += c
                    lines.append(f'{safe}_bucket{{le="{b}"}} {cum}')
                cum += h.counts[-1]
                lines.append(f'{safe}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{safe}_sum {h.sum}")
                lines.append(f"{safe}_count {h.total}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._histograms.clear()
            self._gauges.clear()
            self._ring = SpanRing(self._span_capacity)


# process-wide default registry
metrics = MetricsRegistry()


def device_stats() -> dict:
    """Name and allocated bytes of the CUDA device.  With no card visible
    it reports the CPU; the port computes nothing there unless asked."""
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "device": "cpu", "memory_allocated": None}
    return {
        "platform": "gpu",
        "device": torch.cuda.get_device_name(0),
        "memory_allocated": int(torch.cuda.memory_allocated()),
    }
