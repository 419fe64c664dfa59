"""Build and load the hand-written CUDA kernels (csrc/*.cu) with nvcc + ctypes.

The sources are compiled at first use into a plain-C shared library for
``sm_90a`` (Hopper) under ``build/erlvectordb_tpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources, the shared headers and the flags so
an edited kernel is never served from a stale build.  The compiler's
``-Xptxas -v`` report (registers and spills of every kernel) is kept beside
the library as ``ptxas.log``, so a build served from that directory reports
it too.  Each source compiles
in its own nvcc process, all started together, and one link joins the
objects.  Nothing here runs at import: the CPU test suite imports every
module and has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_topk.cu", "tile_scan.cu", "residual_scan.cu", "cell_probe.cu",
           "adc_scan.cu", "index_build.cu")
HEADERS = ("scan_common.cuh", "mma_scan.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "erlvectordb_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C entry point -> argtypes (every function returns cudaGetLastError())
_SIGNATURES = {
    "evdb_intkey_scan": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    "evdb_l2key_scan": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "evdb_pos_scan_i8": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P, _P],
    "evdb_pos_scan_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "evdb_pos_scan_i4": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P, _P],
    "evdb_fused_scan_i8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P],
    "evdb_fused_scan_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                            _P, _P, _P],
    "evdb_fused_scan_i4": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P],
    "evdb_pos_residual_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P, _P],
    "evdb_cell_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _P, _P, _P],
    "evdb_gather_dots": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                         _P],
    "evdb_adc_scan_i8": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "evdb_adc_scan_bf16": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                           _P],
    "evdb_adc_rerank_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P, _P, _P],
    "evdb_kpp_update": [_P, _P, _I, _I, _I, _D, _D, _P, _P, _P, _P, _P],
    "evdb_pairwise_norms": [_P, _I, _I, _P, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}  # seconds, path and the compiler's -Xptxas -v report
LOG_NAME = "ptxas.log"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library() -> ctypes.CDLL:
    """The kernel library, built on first call (one build per process and
    source hash; concurrent builds race to an atomic rename)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in SOURCES + HEADERS:
            digest.update((CSRC / name).read_bytes())
        out_dir = BUILD_ROOT / digest.hexdigest()[:16]
        so = out_dir / "libevdb_kernels.so"
        t0 = time.perf_counter()
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            _build(out_dir, so)
        report = out_dir / LOG_NAME
        log = report.read_text() if report.exists() else ""
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                          log=log)
        _lib = lib
        return lib


def _build(out_dir: Path, so: Path) -> None:
    """One nvcc per source, all running at once, then one link; the
    compiler's report and then the library land under their final names by
    atomic renames."""
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        nvcc = _nvcc()
        objs = [work / (Path(src).stem + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        failed = [src for src, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = work / so.name
        proc = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        (work / LOG_NAME).write_text(log)
        os.replace(work / LOG_NAME, out_dir / LOG_NAME)
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check(rc: int, name: str) -> None:
    """Raise on a refused or failed launch (the entry points return
    cudaGetLastError(); 0 is cudaSuccess)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
