"""Host byte codecs (zlib / lz4) for float32 payloads — this package's copy
of ``erlvectordb_tpu/quant/codecs.py`` (numpy and zlib only).

Parity with the reference's lossless algorithms: zlib over the packed f32
binary (src/vector_compression.erl:232-245) and an "lz4" entry that falls
back to zlib when no LZ4 implementation is available (the reference does the
same — a NIF would be required, src/vector_compression.erl:247-254).  If the
``lz4`` package exists in the environment it is used transparently.
"""

from __future__ import annotations

import zlib

import numpy as np

try:  # optional accelerator; stdlib-only environments fall back to zlib
    import lz4.frame as _lz4  # type: ignore

    HAVE_LZ4 = True
except Exception:  # pragma: no cover
    _lz4 = None
    HAVE_LZ4 = False


def f32_to_bytes(x) -> bytes:
    return np.ascontiguousarray(np.asarray(x, np.float32)).tobytes()


def bytes_to_f32(b: bytes) -> np.ndarray:
    return np.frombuffer(b, dtype=np.float32).copy()


def zlib_compress(x, level: int = 6) -> bytes:
    return zlib.compress(f32_to_bytes(x), level)


def zlib_decompress(b: bytes) -> np.ndarray:
    return bytes_to_f32(zlib.decompress(b))


def lz4_compress(x) -> bytes:
    if HAVE_LZ4:
        return _lz4.compress(f32_to_bytes(x))
    return zlib_compress(x)  # documented fallback, same as the reference


def lz4_decompress(b: bytes) -> np.ndarray:
    if HAVE_LZ4:
        return bytes_to_f32(_lz4.decompress(b))
    return zlib_decompress(b)
