"""Roofline share of B3-int8, the pos scan (``slice_scan_kernel`` on int8
codes in pos mode): the configuration's bound over the kernel's device
time.  The scan reads the codes and two float factors a row."""

from evdb_bench.readers import int8_scan_roofline_pct


def read(ctx):
    return int8_scan_roofline_pct(ctx, r"slice_scan_kernel<false, 2,", 8)
