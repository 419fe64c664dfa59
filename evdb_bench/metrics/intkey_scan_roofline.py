"""Roofline share of B1, the intkey scan (``slice_scan_kernel`` on int8
codes in intkey mode): the configuration's bound over the kernel's device
time.  The key scan reads the unit-plane codes and no row factor."""

from evdb_bench.readers import int8_scan_roofline_pct


def read(ctx):
    return int8_scan_roofline_pct(ctx, r"slice_scan_kernel<false, 0,", 0)
