"""Unified compression API — counterpart of
``erlvectordb_tpu/quant/compression.py``: the reference's
compress/decompress/batch/ratio/benchmark verbs over six algorithms.

  * ``8bit``     — per-vector min/max affine -> uint8 codes (quant/affine.py)
  * ``4bit``     — same with nibble packing
  * ``pca``      — a fitted PCA model when a training batch (>= 8 rows) or a
                   ``pca_model`` is given; single vectors truncate to half
  * ``zlib``     — deflate over the f32 bytes (lossless, host)
  * ``lz4``      — lz4 when the package is importable, else zlib (host)
  * ``product``  — product quantization (quant/pq.py) when a batch of >= 256
                   rows or a ``pq_codebook`` is given; single vectors train
                   a micro-codebook over their own 4-wide subvectors

The model-based and affine algorithms run on ``device`` (default: the input
tensor's own, else the CUDA card).  A :class:`CompressedVector` serializes to
the JAX package's byte layout (``EVQZ`` header + payload + npz of side
arrays), so a blob from either package decompresses in the other.
"""

from __future__ import annotations

import io
import json
import struct
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from erlvectordb_tpu_torch.ops.fused_topk import div_scalar
from erlvectordb_tpu_torch.quant import affine, codecs
from erlvectordb_tpu_torch.quant.pca import (
    PCAModel,
    truncate_project,
    truncate_restore,
)
from erlvectordb_tpu_torch.quant.pq import PQCodebook, _as_f32, _device_of

SUPPORTED_ALGORITHMS = ("8bit", "4bit", "pca", "zlib", "lz4", "product")

_MAGIC = b"EVQZ"


@dataclass
class CompressedVector:
    algorithm: str
    payload: bytes
    meta: Dict[str, Any] = field(default_factory=dict)
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return len(self.payload) + sum(a.nbytes for a in self.arrays.values())

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, **self.arrays)
        arr_blob = buf.getvalue()
        header = json.dumps({"algorithm": self.algorithm,
                             "meta": self.meta}).encode()
        return b"".join([
            _MAGIC,
            struct.pack("<III", len(header), len(self.payload), len(arr_blob)),
            header,
            self.payload,
            arr_blob,
        ])

    @classmethod
    def from_bytes(cls, blob: bytes) -> "CompressedVector":
        if blob[:4] != _MAGIC:
            raise ValueError("not a CompressedVector blob")
        hlen, plen, alen = struct.unpack("<III", blob[4:16])
        off = 16
        header = json.loads(blob[off:off + hlen].decode())
        off += hlen
        payload = blob[off:off + plen]
        off += plen
        arrays: Dict[str, np.ndarray] = {}
        if alen:
            with np.load(io.BytesIO(blob[off:off + alen])) as z:
                arrays = {k: z[k] for k in z.files}
        return cls(header["algorithm"], payload, header.get("meta", {}), arrays)


def get_supported_algorithms() -> List[str]:
    return list(SUPPORTED_ALGORITHMS)


# ------------------------------------------------------------------ compress


def compress_vector(vector, algorithm: str, device=None,
                    **kw) -> CompressedVector:
    """Compress a single vector.  ``kw`` may carry a fitted ``pca_model`` or
    ``pq_codebook`` for the model-based algorithms."""
    if isinstance(vector, torch.Tensor):
        vector = vector.reshape(1, -1)
    else:
        vector = np.asarray(vector, np.float32)[None, :]
    return compress_batch(vector, algorithm, device=device, **kw)[0]


def _affine_batch(alg: str, x: torch.Tensor) -> List[CompressedVector]:
    quantize = affine.quantize_u8 if alg == "8bit" else affine.quantize_u4
    codes, mn, scale = (t.cpu().numpy() for t in quantize(x))
    d = x.shape[1]
    return [CompressedVector(alg, codes[i].tobytes(),
                             {"dim": d, "min": float(mn[i, 0]),
                              "scale": float(scale[i, 0])})
            for i in range(x.shape[0])]


def compress_batch(vectors, algorithm: str, device=None,
                   **kw) -> List[CompressedVector]:
    if algorithm not in SUPPORTED_ALGORITHMS:
        raise ValueError(f"unsupported algorithm {algorithm!r}; choose from "
                         f"{SUPPORTED_ALGORITHMS}")
    if algorithm in ("zlib", "lz4"):
        x = (vectors.detach().cpu().numpy()
             if isinstance(vectors, torch.Tensor) else vectors)
        x = np.asarray(x, np.float32)
        x = x[None, :] if x.ndim == 1 else x
        d = x.shape[1]
        if algorithm == "zlib":
            return [CompressedVector("zlib", codecs.zlib_compress(row),
                                     {"dim": d}) for row in x]
        return [CompressedVector("lz4", codecs.lz4_compress(row),
                                 {"dim": d, "lz4_native": codecs.HAVE_LZ4})
                for row in x]
    x = _as_f32(vectors, _device_of(vectors, device))
    if x.ndim == 1:
        x = x[None, :]
    n, d = x.shape
    if algorithm in ("8bit", "4bit"):
        return _affine_batch(algorithm, x)
    if algorithm == "pca":
        model: Optional[PCAModel] = kw.get("pca_model")
        n_components = kw.get("n_components")
        if model is None and n >= 8:
            model = PCAModel.fit(x, n_components or max(1, d // 2))
        if model is not None:
            z = model.transform(x).cpu().numpy()
            marrs = model.to_arrays()
            return [CompressedVector(
                "pca", z[i].tobytes(),
                {"dim": d, "mode": "model", "n_components": model.n_components},
                {"mean": marrs["mean"], "components": marrs["components"]})
                for i in range(n)]
        # single-vector fallback: truncation (the reference's behaviour)
        z = truncate_project(x, n_components).cpu().numpy()
        return [CompressedVector("pca", z[i].tobytes(),
                                 {"dim": d, "mode": "truncate"})
                for i in range(n)]
    codebook: Optional[PQCodebook] = kw.get("pq_codebook")
    if codebook is None and n >= 256:
        codebook = PQCodebook.fit(x, m=kw.get("m") or _default_m(d),
                                  k=min(256, max(16, n // 4)), seed=0)
    if codebook is not None:
        codes = codebook.encode(x).cpu().numpy()
        cb = codebook.to_arrays()["codebooks"]
        return [CompressedVector(
            "product", codes[i].tobytes(),
            {"dim": d, "mode": "codebook", "m": codebook.m, "k": codebook.k},
            {"codebooks": cb}) for i in range(n)]
    # per-vector micro-codebook over the vector's own 4-wide subvectors
    return [_pq_single(x[i]) for i in range(n)]


def _default_m(d: int) -> int:
    for m in (8, 16, 4, 32, 2):
        if d % m == 0:
            return m
    return 1


def _pq_single(vec: torch.Tensor) -> CompressedVector:
    from erlvectordb_tpu_torch.ops.kmeans import kmeans_fit

    d = vec.shape[0]
    sub = 4
    pts = torch.nn.functional.pad(vec, (0, (-d) % sub)).reshape(-1, sub)
    k = int(min(16, pts.shape[0]))
    cents, assign = kmeans_fit(pts, 0, k=k, iters=10)
    return CompressedVector(
        "product", assign.cpu().numpy().astype(np.uint8).tobytes(),
        {"dim": d, "mode": "single", "sub": sub, "k": k},
        {"centroids": cents.cpu().numpy().astype(np.float32)})


# ---------------------------------------------------------------- decompress


def decompress_vector(cv, device=None, **kw) -> np.ndarray:
    return decompress_batch([cv], device=device, **kw)[0]


def _group_key(cv: CompressedVector, kw: dict):
    """Rows that decompress together on the device: affine rows of one
    dimension, and model-based rows that share one model (the side arrays
    of one compress_batch call, or the caller's ``pca_model`` /
    ``pq_codebook``).  None for the host codecs and single-vector modes."""
    alg, mode = cv.algorithm, cv.meta.get("mode")
    if alg in ("8bit", "4bit"):
        return alg, int(cv.meta["dim"])
    if alg == "pca" and mode == "model":
        return alg, id(kw.get("pca_model") or cv.arrays["components"])
    if alg == "product" and mode == "codebook":
        return alg, id(kw.get("pq_codebook") or cv.arrays["codebooks"])
    return None


def _decompress_group(group: list, device, **kw) -> np.ndarray:
    alg = group[0].algorithm
    payload = b"".join(cv.payload for cv in group)
    if alg == "pca":
        model = kw.get("pca_model") or PCAModel.from_arrays(
            group[0].arrays, device=device)
        z = np.frombuffer(payload, np.float32).reshape(len(group), -1)
        return model.inverse_transform(z).cpu().numpy()
    if alg == "product":
        codebook = kw.get("pq_codebook") or PQCodebook.from_arrays(
            group[0].arrays, device=device)
        codes = np.frombuffer(payload, np.uint8).reshape(len(group), -1)
        return codebook.decode(codes).cpu().numpy()
    # affine rows, with the JAX package's host formula codes / L * scale +
    # min (three f32 roundings)
    device = _device_of(None, device)
    d = int(group[0].meta["dim"])
    codes = torch.from_numpy(np.frombuffer(payload, np.uint8).reshape(
        len(group), -1).copy()).to(device)
    if alg == "4bit":
        codes, levels = affine.unpack_u4(codes, d), 15.0
    else:
        codes, levels = codes.to(torch.float32), 255.0
    side = torch.tensor([[cv.meta["scale"], cv.meta["min"]] for cv in group],
                        dtype=torch.float32, device=device)
    return (div_scalar(codes, levels) * side[:, :1] + side[:, 1:]).cpu().numpy()


def decompress_batch(cvs: Sequence[CompressedVector], device=None,
                     **kw) -> List[np.ndarray]:
    """Decompress blobs or CompressedVectors; rows of one algorithm and
    model run as one batch on ``device`` (default: the CUDA card)."""
    cvs = [CompressedVector.from_bytes(bytes(cv))
           if isinstance(cv, (bytes, bytearray)) else cv for cv in cvs]
    out: List[Optional[np.ndarray]] = [None] * len(cvs)
    groups: Dict[tuple, List[int]] = {}
    for i, cv in enumerate(cvs):
        key = _group_key(cv, kw)
        if key is None:
            out[i] = _decompress_one(cv)
        else:
            groups.setdefault(key, []).append(i)
    for idx in groups.values():
        rows = _decompress_group([cvs[i] for i in idx], device, **kw)
        for i, row in zip(idx, rows):
            out[i] = row
    return out


def _decompress_one(cv: CompressedVector) -> np.ndarray:
    """The host codecs and the single-vector modes (numpy)."""
    alg, meta = cv.algorithm, cv.meta
    d = int(meta["dim"])
    if alg == "zlib":
        return codecs.zlib_decompress(cv.payload)
    if alg == "lz4":
        if meta.get("lz4_native") and not codecs.HAVE_LZ4:
            raise RuntimeError("blob was lz4-compressed but lz4 is unavailable")
        return (codecs.lz4_decompress(cv.payload) if meta.get("lz4_native")
                else codecs.zlib_decompress(cv.payload))
    if alg == "pca":  # truncate mode: zero-pad back to the dimension
        z = torch.from_numpy(np.frombuffer(cv.payload, np.float32).copy())
        return truncate_restore(z, d).numpy()
    if alg == "product":  # single mode: the vector's own micro-codebook
        cents = cv.arrays["centroids"]
        assign = np.frombuffer(cv.payload, np.uint8).astype(np.int64)
        return cents[assign].reshape(-1)[:d].astype(np.float32)
    raise ValueError(f"unsupported algorithm {alg!r}")


# ------------------------------------------------------------------- ratios


def get_compression_ratio(original, compressed: CompressedVector) -> float:
    """original f32 bytes / compressed payload bytes (model-based algorithms
    amortize their side arrays; benchmark_compression reports them)."""
    orig_bytes = 4 * int(np.prod(np.shape(original)))
    return orig_bytes / max(len(compressed.payload), 1)


def benchmark_compression(vector, algorithm: str, iterations: int = 10,
                          device=None, **kw) -> dict:
    """Time compress/decompress, compute ratio and MSE accuracy loss — the
    reference's benchmark tool."""
    x = np.asarray(vector, np.float32)
    t0 = time.perf_counter()
    for _ in range(iterations):
        cv = compress_vector(x, algorithm, device=device, **kw)
    compress_us = (time.perf_counter() - t0) / iterations * 1e6
    t0 = time.perf_counter()
    for _ in range(iterations):
        recon = decompress_vector(cv, device=device, **kw)
    decompress_us = (time.perf_counter() - t0) / iterations * 1e6
    recon = np.asarray(recon, np.float32)
    n = min(x.shape[0], recon.shape[0])
    return {
        "algorithm": algorithm,
        "compress_time_us": compress_us,
        "decompress_time_us": decompress_us,
        "compression_ratio": get_compression_ratio(x, cv),
        "payload_bytes": len(cv.payload),
        "side_bytes": sum(a.nbytes for a in cv.arrays.values()),
        "mse": float(np.mean((x[:n] - recon[:n]) ** 2)),
    }
