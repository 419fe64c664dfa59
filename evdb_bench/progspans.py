"""The program's own request spans, as the per-layer readers read them.

The port records a span at each stage of a served request
(``erlvectordb_tpu_torch/utils/metrics.py``): ``(name, rid, parent,
start_ns, end_ns, n)`` on ``time.perf_counter_ns()``, the clock the window
(``ctx["t0"]``, ``ctx["t1"]``, ``time.perf_counter()`` seconds) and the
device trace are on.  A request's spans carry its id; the spans of the
device batch it rode carry the batch's id, which its own spans after the
dispatch name as ``parent``.

The spans are read beside the device trace they share a clock with, so
every function here returns None where there is nothing to read: no
device trace (a run off the card), a program that records no spans, spans
overwritten in the program's ring during the window (its ``trace.dropped``
counter grew), or no span of the kind read.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from evdb_bench.devtrace import union

REQUESTS = ("grpc.request", "mcp.request")


def _registry():
    from erlvectordb_tpu_torch.utils.metrics import metrics
    return metrics


def window(ctx: dict) -> Optional[list]:
    """The program's spans meeting the window, or None."""
    if ctx.get("device_events") is None \
            or ctx.get("counters", {}).get("trace.dropped", 0) > 0:
        return None
    between = getattr(_registry(), "spans_between", None)
    if between is None:
        return None
    return between(ctx["t0"], ctx["t1"]) or None


def _ms(s) -> float:
    return (s[4] - s[3]) / 1e6


def _started_in(spans, name: str, ctx: dict) -> list:
    t0, t1 = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    return [s for s in spans if s[0] == name and t0 <= s[3] <= t1]


def _mean(vals: List[float]) -> Optional[float]:
    return sum(vals) / len(vals) if vals else None


def _by_rid(spans) -> Dict[int, list]:
    out = defaultdict(list)
    for s in spans:
        out[s[1]].append(s)
    return out


def _related(by_rid: Dict[int, list], req) -> Iterable:
    """The spans of request ``req``: its own and its device batch's."""
    yield from by_rid.get(req[1], ())
    if req[2] and req[2] != req[1]:
        yield from by_rid.get(req[2], ())


def mean_stage_ms(ctx: dict, name: str) -> Optional[float]:
    """Mean milliseconds of the spans ``name`` begun in the window."""
    spans = window(ctx)
    if spans is None:
        return None
    return _mean([_ms(s) for s in _started_in(spans, name, ctx)])


def mean_request_stage_ms(ctx: dict, request: str,
                          stage: str) -> Optional[float]:
    """Mean over the ``request`` spans begun in the window of the summed
    milliseconds of the request's own ``stage`` spans (a stage may come in
    parts, as gRPC's parse and rows)."""
    spans = window(ctx)
    if spans is None:
        return None
    by_rid = _by_rid(s for s in spans if s[0] == stage)
    return _mean([sum(_ms(s) for s in by_rid[r[1]])
                  for r in _started_in(spans, request, ctx) if r[1] in by_rid])


def mean_wait_ms(ctx: dict, request: str) -> Optional[float]:
    """Mean over the ``request`` spans begun in the window of the summed
    milliseconds of the batcher's waits (``batcher.*_wait``) the request
    and its device batch went through; requests the batcher never saw are
    left out."""
    spans = window(ctx)
    if spans is None:
        return None
    by_rid = _by_rid(s for s in spans
                     if s[0].startswith("batcher.") and s[0].endswith("_wait"))
    vals = []
    for r in _started_in(spans, request, ctx):
        waits = list(_related(by_rid, r))
        if waits:
            vals.append(sum(_ms(s) for s in waits))
    return _mean(vals)


def mean_self_ms(ctx: dict, request: str,
                 inner: Tuple[str, ...] = ("batcher.", "store.", "index.")
                 ) -> Optional[float]:
    """Mean over the ``request`` spans begun in the window of the request's
    milliseconds not covered by its (or its batch's) spans of the layers
    below: the union of those, clipped to the request, subtracted."""
    spans = window(ctx)
    if spans is None:
        return None
    by_rid = _by_rid(s for s in spans if s[0].startswith(inner))
    vals = []
    for r in _started_in(spans, request, ctx):
        cover = union([(s[3], s[4]) for s in _related(by_rid, r)], r[3], r[4])
        vals.append((r[4] - r[3] - sum(e - s for s, e in cover)) / 1e6)
    return _mean(vals)


def mean_less_child_ms(ctx: dict, name: str,
                       child: str) -> Optional[float]:
    """Mean over the spans ``name`` begun in the window of their
    milliseconds less those of their own id's ``child`` spans inside."""
    spans = window(ctx)
    if spans is None:
        return None
    by_rid = _by_rid(s for s in spans if s[0] == child)
    vals = []
    for p in _started_in(spans, name, ctx):
        inside = [c for c in by_rid.get(p[1], ())
                  if p[3] <= c[3] and c[4] <= p[4]]
        vals.append(_ms(p) - sum(_ms(c) for c in inside))
    return _mean(vals)


def host_bound_idle_pct(ctx: dict) -> Optional[float]:
    """Share of the window (%) in which the device was idle while at least
    one request was open in the program: idle a faster host path could
    take away (the rest of the device's idle had nothing in the system)."""
    spans = window(ctx)
    if spans is None or not ctx.get("window_s"):
        return None
    reqs = [(s[3] / 1e9, s[4] / 1e9) for s in spans if s[0] in REQUESTS]
    if not reqs:
        return None
    open_ = union(reqs, ctx["t0"], ctx["t1"])
    both = 0.0
    i = 0
    for s, e in ctx["idle"]:          # both lists sorted and disjoint
        while i < len(open_) and open_[i][1] <= s:
            i += 1
        j = i
        while j < len(open_) and open_[j][0] < e:
            both += max(0.0, min(e, open_[j][1]) - max(s, open_[j][0]))
            j += 1
    return 100.0 * both / ctx["window_s"]


def device_ops_per_query(ctx: dict) -> Optional[float]:
    """Device operations (kernels, copies, fills) in the window over the
    queries of the requests that completed in it."""
    spans = window(ctx)
    if spans is None:
        return None
    t0, t1 = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    queries = sum(s[5] for s in spans
                  if s[0] in REQUESTS and t0 <= s[4] <= t1)
    return len(ctx["device_events"]) / queries if queries else None
