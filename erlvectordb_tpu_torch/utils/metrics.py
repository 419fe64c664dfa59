"""Metrics + profiling — the observability the reference lacks.

The reference's only instrumentation is timer:tc inside its compression
benchmark and per-health-check durations (SURVEY §5); the rebuild provides:

  * :class:`MetricsRegistry` — process-wide counters and latency histograms
    (lock-free enough: GIL-protected dict updates), exported as JSON and in
    Prometheus text format (the reference's unchecked roadmap item);
  * :func:`timed` — context manager recording a latency sample;
  * :func:`profile_trace` — wraps ``torch.profiler.profile`` so a query
    burst can be captured into a Chrome trace;
  * :func:`device_stats` — the serving device's name and allocated bytes.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List

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


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._gauges: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.started_at = time.time()

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

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "uptime_seconds": round(time.time() - self.started_at, 1),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "latencies": {k: h.snapshot() for k, h in self._histograms.items()},
            }

    def prometheus(self) -> str:
        """Prometheus exposition format (reference roadmap item README:1525)."""
        lines: List[str] = []
        with self._lock:
            for name, v in sorted(self._counters.items()):
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


# process-wide default registry
metrics = MetricsRegistry()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Capture a torch profiler trace (CPU + CUDA activity) around a block,
    written as a Chrome trace into ``log_dir``."""
    if not enabled:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
