"""The cell-probe index build's passes over its rows, on their device:
k-means++'s distance update and the int8 residual encode.

Two hand-written kernels (``csrc/index_build.cu``), each with its plain
PyTorch version beside it, which the wrapper takes for CPU tensors:

  kpp_update_     one k-means++ distance update (ops/kmeans.py::_kpp_init):
                  the distance of each row the new seed can reach, summed in
                  ``row_d2``'s order, into the running minimum; rows that
                  keep their owner's distance by the triangle inequality are
                  not read;
  pairwise_norms  the reconstruction norms, summed in numpy's pairwise order
                  (np.linalg.norm(recon, axis=1)).

``encode_cells`` is the host encode's arithmetic on device tensors, in row
chunks: its codes, scales, norms, valid flags and slot -> row map equal the
numpy encode's bit for bit.  Neither kernel replaces a TPU kernel: the JAX
package seeds with whole-array passes and encodes on the host.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from erlvectordb_tpu_torch.ops.fused_topk import _count, _stream, div_scalar

D2_LANES = 128          # row_d2's accumulators: 32 lanes of 4
PW_BLOCK = 128          # numpy's pairwise block (PW_BLOCKSIZE)
PW_CHUNK = 8192         # numpy 2.0's reduction buffer (numpy_chunk)
_PW_SMEM_FLOATS = 12288  # the kernel's 48 KB of staged squares a block
_ENCODE_ELEMS = 1 << 24  # rows x width of one encode chunk's temporaries


def row_d2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """|x_r - c|^2 of each row of x [n, d], in the kernel's order: each
    difference and square rounded; element e added, in order of e, into
    accumulator e % 128; lane l's four accumulators 4l .. 4l + 3 added in
    turn; then the 32 lane sums halved pairwise (lane l plus lane l + h,
    h = 16, 8, 4, 2, 1)."""
    sq = (x - c) ** 2
    n, d = sq.shape
    full = d - d % D2_LANES
    if full:
        blocks = sq[:, :full].reshape(n, full // D2_LANES, D2_LANES)
        acc = blocks[:, 0]
        for j in range(1, blocks.shape[1]):
            acc = acc + blocks[:, j]
        if full < d:
            acc[:, :d - full] += sq[:, full:]
    else:
        acc = torch.nn.functional.pad(sq, (0, D2_LANES - d))
    v = acc.reshape(n, D2_LANES // 4, 4)
    v = ((v[..., 0] + v[..., 1]) + v[..., 2]) + v[..., 3]
    h = D2_LANES // 8
    while h:
        v = v[:, :h] + v[:, h:2 * h]
        h //= 2
    return v[:, 0]


def kpp_reach(d: int) -> Tuple[float, float]:
    """(grow, eta): a row is out of a new seed c's reach when |c_owner -
    c|^2 >= 4 (mind2 + eta) grow.  Each f32 sum of d rounded squares, in
    any order, is off by at most (d + 4) 2^-24 of itself, and by d 2^-126
    where it underflows; grow = 1 + 2 (d + 4) 2^-24 covers both sums, so a
    row past that bound cannot compute a distance below its mind2."""
    return 1.0 + 2.0 * (d + 4) * 2.0 ** -24, d * 2.0 ** -126


def kpp_update_ref_(x, cents, i, mind2, owner, scanned, prune=True):
    """Plain ``kpp_update_``: mind2 = min(mind2, row_d2(x, cents[i])) and
    owner = i where the new seed is nearer (NaN wins, as in torch.minimum),
    in place; ``scanned`` (an int64 tensor) grows by the rows whose distance
    was computed.  ``prune``: only the rows the seed can reach (a row's sum
    does not depend on the rows beside it); i = 0 reads every row."""
    c = cents[i]
    if prune and i > 0:
        grow, eta = kpp_reach(x.shape[1])
        sd2 = torch.sum((cents[:i].double() - c.double()) ** 2, dim=1)
        keep = ~(sd2[owner.long()] >= 4.0 * (mind2.double() + eta) * grow)
        rows = torch.nonzero(keep).squeeze(1)
        s = row_d2(x[rows], c)
    else:
        rows = torch.arange(x.shape[0], device=x.device)
        s = row_d2(x, c)
    closer = (s < mind2[rows]) | torch.isnan(s)
    hit = rows[closer]
    mind2[hit] = s[closer]
    owner[hit] = i
    scanned += rows.numel()


def kpp_update_(x, cents, i, mind2, owner, scanned):
    """The k-means++ distance update for the seed ``cents[i]`` over x [n, d]
    f32: ``kpp_update_ref_``'s result, in place.  On CUDA the kernel reads
    only the rows the seed can reach (every row for i = 0), summing each in
    ``row_d2``'s order, so the result is the whole-sample pass's bit for
    bit; it takes every shape, and refuses other dtypes and layouts."""
    if x.device.type == "cpu":
        return kpp_update_ref_(x, cents, i, mind2, owner, scanned)
    from erlvectordb_tpu_torch.ops import cuda_lib

    n, d = x.shape
    if not all(t.is_cuda and t.is_contiguous()
               for t in (x, cents, mind2, owner, scanned)):
        raise ValueError("kpp_update_: inputs must be contiguous CUDA tensors")
    if (x.dtype != torch.float32 or cents.dtype != torch.float32
            or cents.shape[1] != d or mind2.dtype != torch.float32
            or owner.dtype != torch.int32 or scanned.dtype != torch.int64
            or mind2.shape != (n,) or owner.shape != (n,)
            or not 0 <= i < cents.shape[0] or not 1 <= n < 2 ** 31 or d < 1):
        raise ValueError("kpp_update_: need f32 x [n, d] and cents [k, d], "
                         "f32 mind2 and int32 owner [n], an int64 counter, "
                         "0 <= i < k")
    grow, eta = kpp_reach(d)
    sd2 = torch.empty((max(i, 1),), dtype=torch.float64, device=x.device)
    rc = cuda_lib.library().evdb_kpp_update(
        x.data_ptr(), cents.data_ptr(), n, d, i, grow, eta, sd2.data_ptr(),
        mind2.data_ptr(), owner.data_ptr(), scanned.data_ptr(), _stream())
    cuda_lib.check(rc, "kpp_update_")
    _count(kpp_update_, "pruned")


def pairwise_program(d: int, chunk: Optional[int] = None
                     ) -> List[Tuple[int, int]]:
    """numpy's sum of d values along a row as a postfix program: (start,
    count) for a leaf (under 8 values summed in turn from -0.0, else 8
    accumulators in blocks of up to PW_BLOCK), (-1, 0) to add the two sums
    on top.  The row is summed in chunks of ``chunk`` values added in turn
    (0: the whole row at once; None: as the installed numpy does,
    ``numpy_chunk``); within a chunk a run longer than PW_BLOCK splits at
    half its length, less that modulo 8."""
    if chunk is None:
        chunk = numpy_chunk() if d > PW_CHUNK else 0
    prog: List[Tuple[int, int]] = []

    def walk(start: int, n: int) -> None:
        if n <= PW_BLOCK:
            prog.append((start, n))
            return
        n2 = n // 2 - (n // 2) % 8
        walk(start, n2)
        walk(start + n2, n - n2)
        prog.append((-1, 0))

    step = chunk or d
    for lo in range(0, d, step):
        walk(lo, min(step, d - lo))
        if lo:
            prog.append((-1, 0))
    return prog


@functools.lru_cache(maxsize=None)
def numpy_chunk() -> int:
    """How numpy sums a float32 row longer than PW_CHUNK: in chunks of
    PW_CHUNK values (its reduction buffer) added in turn, as numpy 2.0
    does, or whole (0), as numpy 2.3 does; read once from numpy itself."""
    sq = np.random.default_rng(0).random((8, 3 * PW_CHUNK + 11),
                                         dtype=np.float32)
    want = np.add.reduce(sq, axis=1)   # np.linalg.norm's sum
    for chunk in (PW_CHUNK, 0):
        got = 0.0 + _pairwise_sum(torch.from_numpy(sq), chunk)
        if np.array_equal(got.numpy(), want):
            return chunk
    raise RuntimeError("numpy sums rows wider than 8,192 values in an "
                       "order pairwise_norms does not know")


def _pairwise_leaf(a: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise sum of the columns of a [m, count <= PW_BLOCK]."""
    count = a.shape[1]
    if count < 8:
        r = torch.full((a.shape[0],), -0.0, dtype=a.dtype, device=a.device)
        for k in range(count):
            r = r + a[:, k]
        return r
    r = a[:, :8]
    k = 8
    while k < count - count % 8:
        r = r + a[:, k:k + 8]
        k += 8
    res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + (
        (r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
    for k in range(k, count):
        res = res + a[:, k]
    return res


def _pairwise_sum(sq: torch.Tensor, chunk: Optional[int] = None
                  ) -> torch.Tensor:
    """The rows of sq summed along ``pairwise_program``."""
    stack = []
    for start, count in pairwise_program(sq.shape[1], chunk):
        if start >= 0:
            stack.append(_pairwise_leaf(sq[:, start:start + count]))
        else:
            b = stack.pop()
            stack[-1] = stack[-1] + b
    return stack[0]


def _sqrt(s: torch.Tensor) -> torch.Tensor:
    """numpy's float32 square root of the reduction's identity plus s
    (torch's float32 square root on the CPU is not always correctly
    rounded; the float64 one, rounded to float32, is)."""
    return torch.sqrt(0.0 + s.double()).float()


def pairwise_norms_ref(recon: torch.Tensor) -> torch.Tensor:
    """Plain ``pairwise_norms``: each row's squares summed along
    ``pairwise_program``, then the square root."""
    return _sqrt(_pairwise_sum(recon * recon))


def pairwise_norms(recon: torch.Tensor) -> torch.Tensor:
    """np.linalg.norm(recon, axis=1) of recon [m, d] f32, bit for bit, on
    recon's device; on CUDA the kernel takes every width, and refuses other
    dtypes and layouts."""
    m, d = recon.shape
    if d < 1:
        raise ValueError("pairwise_norms: rows need a width of at least 1")
    if recon.device.type == "cpu":
        return pairwise_norms_ref(recon)
    from erlvectordb_tpu_torch.ops import cuda_lib

    if (not recon.is_cuda or recon.dtype != torch.float32
            or not recon.is_contiguous() or m >= 2 ** 31):
        raise ValueError("pairwise_norms: need a contiguous f32 CUDA tensor")
    out = torch.empty((m,), dtype=torch.float32, device=recon.device)
    if m == 0:
        return out
    prog = torch.tensor(pairwise_program(d), dtype=torch.int32,
                        device=recon.device)
    # rows staged a block in shared memory; 0: too wide, read unstaged
    rows = min(32, _PW_SMEM_FLOATS // (d + 1))
    rc = cuda_lib.library().evdb_pairwise_norms(
        recon.data_ptr(), m, d, prog.data_ptr(), prog.shape[0], rows,
        out.data_ptr(), _stream())
    cuda_lib.check(rc, "pairwise_norms")
    _count(pairwise_norms, "pairwise" if rows else "unstaged")
    return out


KERNELS = (kpp_update_, pairwise_norms)


def reset_launches() -> None:
    """Zero the kernels' launch counts (``launches`` and ``launches_by``)."""
    for k in KERNELS:
        k.launches = 0
        k.launches_by = {}


reset_launches()


def encode_cells(data, rows, owner, cents, cell_cap):
    """The cell-major layout of rows ``data`` [N, D] f32 placed by ``owner``
    [N] around ``cents`` [K, D], all tensors on one device (``rows`` [N]
    int64 store rows): (codes [K*cap, D] int8, scales, reconstruction norms,
    valid, slot -> row map), as tensors there.

    The numpy encode's arithmetic, each step its own rounding: rows stably
    sorted by cell; the residual, its absmax and the scale absmax / 127 (a
    true division; 1 for a zero residual); codes rounded half to even from a
    true division and clipped to +-127; the reconstruction as a product and
    then a sum; its norm summed in numpy's pairwise order.  Rows run in
    chunks of _ENCODE_ELEMS elements."""
    dev = data.device
    n, d = data.shape
    n_cells = cents.shape[0]
    oc, order = torch.sort(owner, stable=True)
    starts = torch.searchsorted(oc, torch.arange(n_cells, device=dev))
    dest = oc * cell_cap + (torch.arange(n, device=dev) - starts[oc])
    total = n_cells * cell_cap
    codes = torch.zeros((total, d), dtype=torch.int8, device=dev)
    scales = torch.ones((total,), dtype=torch.float32, device=dev)
    norms = torch.zeros((total,), dtype=torch.float32, device=dev)
    row_map = torch.full((total,), -1, dtype=torch.int64, device=dev)
    step = max(1, _ENCODE_ELEMS // max(d, 1))
    for lo in range(0, n, step):
        src, to = order[lo:lo + step], dest[lo:lo + step]
        c = cents[oc[lo:lo + step]]
        res = data[src] - c
        absmax = res.abs().amax(dim=1)
        scale = torch.where(absmax > 0, div_scalar(absmax, 127.0),
                            torch.ones_like(absmax))
        q = torch.clamp(torch.round(res / scale[:, None]), -127,
                        127).to(torch.int8)
        codes[to] = q
        scales[to] = scale
        # scored with reconstruction norms (what the codes encode), as the
        # int4r store is
        recon = c + q.float() * scale[:, None]
        norms[to] = pairwise_norms(recon)
        row_map[to] = rows[src]
    return codes, scales, norms, row_map >= 0, row_map
