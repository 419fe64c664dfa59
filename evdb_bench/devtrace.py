"""The device trace of a traced run: ``torch.profiler`` with CUDA activity
only (no host operator events, so the host path runs as in an untraced run
but for the tracer's per-launch cost).

Device activity (kernels, copies, fills) is read from the profiler's kineto
events and put on the host's ``time.perf_counter()`` clock by a marker: a
spin kernel the trace starts with, whose device end is taken to be the
host time at which a synchronise on it returned (the wall clock of the
events is the fallback).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

MARKER = "spin_kernel"


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.mark_host: Optional[float] = None
        self.wall_minus_perf = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        torch.cuda._sleep(200_000)
        torch.cuda.synchronize(self.device)
        self.mark_host = time.perf_counter()
        self.wall_minus_perf = time.time() - time.perf_counter()

    def stop(self) -> None:
        self.prof.stop()

    def events(self) -> List[Tuple[str, float, float]]:
        """(name, start, end) of every device activity, perf_counter seconds."""
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
                raw.append((e.name(), e.start_ns(), e.start_ns()
                            + e.duration_ns()))
        marks = [ev for ev in raw if MARKER in ev[0]]
        if marks and self.mark_host is not None:
            end_ns = min(marks, key=lambda ev: ev[1])[2]
            offset = self.mark_host - end_ns / 1e9
        else:
            offset = -self.wall_minus_perf
        return [(n, s / 1e9 + offset, e / 1e9 + offset) for n, s, e in raw
                if MARKER not in n]


def union(intervals: List[Tuple[float, float]], t0: float, t1: float
          ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [t0, t1], sorted."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gaps(busy: List[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of [t0, t1] between the busy ones."""
    out, cur = [], t0
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < t1:
        out.append((cur, t1))
    return out
