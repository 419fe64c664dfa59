"""Arithmetic the per-layer readers (``metrics/<name>.py``) share.

A reader is given the traced run's context (``harness.trace_context``) and
returns its metric, or None where the run has nothing for it to read.
"""

from __future__ import annotations

import re
from typing import List, Optional

from evdb_bench import roofline


def mean_ms(durations: List[float]) -> Optional[float]:
    return 1e3 * sum(durations) / len(durations) if durations else None


def span_ms(ctx: dict, name: str) -> Optional[float]:
    """Mean milliseconds of the harness spans ``name`` begun in the window."""
    spans = ctx["spans"]
    if spans is None:
        return None
    return mean_ms([s[1] - s[0] for s in spans.within(name, ctx["t0"],
                                                      ctx["t1"])])


def hist_mean(ctx: dict, name: str) -> Optional[float]:
    """Sum over count of the program's histogram ``name`` in the window."""
    count, total = ctx["hist"].get(name, (0, 0.0))
    return total / count if count else None


def idle_pct(ctx: dict) -> Optional[float]:
    if ctx.get("device_events") is None or not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def int8_scan_roofline_pct(ctx: dict, kernel: str,
                           per_row_bytes: int) -> Optional[float]:
    """Bound over measured time of the int8 scan kernels whose name matches
    ``kernel`` (a regular expression), in the window.  Each call is taken
    to answer the mean query count of the store searches of the window
    (the cells that read this submit one call a search)."""
    if ctx.get("device_events") is None or ctx["spans"] is None:
        return None
    pat = re.compile(kernel)
    calls = [e - s for n, s, e in ctx["device_events"] if pat.search(n)]
    searches = ctx["spans"].within("store", ctx["t0"], ctx["t1"])
    if not calls or not searches:
        return None
    nq = sum(s[2] for s in searches) / len(searches)
    cfg = ctx["config"]
    bound = len(calls) * roofline.int8_scan_bound_s(
        cfg["rows"], cfg["dim"], nq, cfg["k"], per_row_bytes)
    return 100.0 * bound / sum(calls)


def prepare_stat(ctx: dict, key: str) -> Optional[float]:
    """The number ``key`` of what set-up's ``prepare`` reported (an index
    build's ``stats.build``); None where it reported none."""
    value = (ctx.get("prepare_stats") or {}).get(key)
    return None if value is None else float(value)
