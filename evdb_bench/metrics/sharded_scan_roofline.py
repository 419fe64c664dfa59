"""Roofline share of B3-int8 (``slice_scan_kernel`` on int8 codes in pos
mode) under a sharded store: the least time the window's searches need
over the device time of the kernel.  Each search's bound is taken from the
configuration's rows and width and the query count of its program
``store.submit`` span, so the same work counts the same however many
launches or shards carry it; the scan reads the codes and two float
factors a row."""

import re

from evdb_bench import progspans, roofline

KERNEL = re.compile(r"slice_scan_kernel<false, 2,")


def read(ctx):
    spans = progspans.window(ctx)
    if spans is None:
        return None
    t0, t1 = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    nqs = [s[5] for s in spans if s[0] == "store.submit" and t0 <= s[3] <= t1]
    busy = sum(e - s for n, s, e in ctx["device_events"] if KERNEL.search(n))
    if not nqs or busy <= 0:
        return None
    cfg = ctx["config"]
    bound = sum(roofline.int8_scan_bound_s(cfg["rows"], cfg["dim"], nq,
                                           cfg["k"], 8) for nq in nqs)
    return 100.0 * bound / busy
