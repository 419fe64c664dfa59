"""The yardstick of the kernels' roofline shares: the card's published peaks
and, for each scan, the operations and bytes the configuration's work needs.

Peaks: NVIDIA H100 SXM data sheet, dense: 1,979 TOP/s int8, 989 TFLOP/s
bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM.  They
assume the full 700 W; the run prints the card's power limit beside them.

Counts are taken from the configuration's widths and rows (not the
program's padding) and the queries a call answers, with each input byte
read once and each output byte written once: a call over ``rows`` rows of
``width`` int8 codes for ``nq`` queries needs ``2 * rows * width * nq``
integer operations, reads the codes, ``per_row_bytes`` of row factors a
row and the ``nq`` int8 queries, and writes ``k`` (distance, row) pairs a
query.
"""

from __future__ import annotations

INT8_OPS = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def int8_scan_ops(rows: int, width: int, nq: int) -> float:
    return 2.0 * rows * width * nq


def int8_scan_bytes(rows: int, width: int, nq: int, k: int,
                    per_row_bytes: int) -> float:
    return rows * (width + per_row_bytes) + nq * width + nq * k * 8


def int8_scan_bound_s(rows: int, width: int, nq: int, k: int,
                      per_row_bytes: int) -> float:
    """The least time the card could take: the larger of operations over
    the int8 peak and bytes over the HBM peak."""
    return max(int8_scan_ops(rows, width, nq) / INT8_OPS,
               int8_scan_bytes(rows, width, nq, k, per_row_bytes) / HBM_BYTES)
