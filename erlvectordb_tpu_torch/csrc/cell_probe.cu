// B7, the multiprobe gather + dot for Hopper (sm_90a), ported from
// erlvectordb_tpu/ops/cell_probe.py (_dma_gather_dots, kernel bodies
// _gather_dots_kernel and _gather_dots_kernel_packed).
//
//   out[b, j, c] = sum_w q[b, w] * code(cells[probe[b, j]], c, w)
//
// for each query b and each probed cell j: the f32 query row against the
// probed cell's [cap, W] block of residual codes.  Two code layouts:
//
//   I8   [K, cap, W] int8 (the cell-probe index's 8-bit residuals);
//   I4   [K, cap, W/2] uint8, two signed nibbles a byte, element 2p in the
//        high nibble (the int4r store's own rows), unpacked with nib_hi /
//        nib_lo from scan_common.cuh.
//
// One block per (query, probe): the block reads probe[b, j], offsets the code
// pointer by cell * cap * row_bytes, holds the query row in shared memory and
// walks the cell's rows.  A row is G lanes of a warp (G = the row's 16-byte
// pieces rounded up to a power of two, at most 32): each lane loads 16-byte
// pieces of the row, converts the codes to f32 and accumulates products with
// the query in f32 (one __fmaf_rn chain per lane), and the G lanes finish with
// a shuffle reduction.  The wrapper hands over the query rounded to bf16 (and
// held as f32), so every product is exact and results differ from any other
// f32 order of summation only by rounding of the sums.
//
// A lane's piece meets 64 (int8) or 128 (int4) contiguous bytes of the query,
// so neighbouring lanes would read shared memory 64 or 128 bytes apart, all in
// the same banks.  The query's 16-byte chunks are therefore stored swizzled
// (chunk c at c ^ ((c >> 3) & 7)): the eight lanes of a quarter warp, which
// hold eight consecutive pieces, read eight different bank groups.  A code
// becomes an f32 by a byte permute into the mantissa of 2^23 and one
// subtraction (both full rate), not by the quarter-rate I2F.
//
// Where the TPU kernel has Mosaic double-buffer each probed block's DMA behind
// the previous block's matmul, blocks here run in parallel on the SMs and the
// hardware keeps many loads in flight.
//
// What bounds it on an H100: the bytes.  At the cell-probe index's shapes
// (256 queries x 64 probes x a 512 x 768 int8 block) each block reads 384 KB
// and does 393 k multiply-adds, ~1 per byte, far below the ~295 operations a
// byte where the tensor cores would be the limit.  This simple kernel reads a
// block once per (query, probe); grouping the pairs by cell, so that a block
// is read once for every query that probes it, and bf16 tensor cores (wgmma)
// with TMA are the open design work.
//
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "scan_common.cuh"

namespace {

using namespace evdb;

constexpr int kProbeThreads = 256;

// the shared-memory slot of the query's 16-byte chunk c
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

// signed byte i of a 32-bit word, as f32: the biased byte in the mantissa of
// 2^23, less 2^23 + 128 (exact)
template <int I>
__device__ __forceinline__ float sbyte(uint32_t biased) {
  return __fsub_rn(__int_as_float((int)__byte_perm(biased, 0x4B000000u, 0x7440 | I)),
                   8388736.0f);
}

// the four signed bytes of w against q.x..q.w
__device__ __forceinline__ float word4(uint32_t w, float4 q, float acc) {
  const uint32_t b = w ^ 0x80808080u;
  acc = __fmaf_rn(sbyte<0>(b), q.x, acc);
  acc = __fmaf_rn(sbyte<1>(b), q.y, acc);
  acc = __fmaf_rn(sbyte<2>(b), q.z, acc);
  return __fmaf_rn(sbyte<3>(b), q.w, acc);
}

// the 16 int8 codes of piece p against query chunks 4p .. 4p+3
__device__ __forceinline__ float piece_i8(uint4 c, const float4* __restrict__ qs,
                                          int p, float acc) {
  acc = word4(c.x, qs[swz(4 * p + 0)], acc);
  acc = word4(c.y, qs[swz(4 * p + 1)], acc);
  acc = word4(c.z, qs[swz(4 * p + 2)], acc);
  return word4(c.w, qs[swz(4 * p + 3)], acc);
}

// the 8 packed int4 codes of one word (element 2i in the high nibble of byte
// i, 2i + 1 in the low) against query chunks a (elements 0-3) and b (4-7)
__device__ __forceinline__ float word8(uint32_t w, float4 a, float4 b, float acc) {
  const uint32_t hi = (uint32_t)nib_hi(w) ^ 0x80808080u;
  const uint32_t lo = (uint32_t)nib_lo(w) ^ 0x80808080u;
  acc = __fmaf_rn(sbyte<0>(hi), a.x, acc);
  acc = __fmaf_rn(sbyte<0>(lo), a.y, acc);
  acc = __fmaf_rn(sbyte<1>(hi), a.z, acc);
  acc = __fmaf_rn(sbyte<1>(lo), a.w, acc);
  acc = __fmaf_rn(sbyte<2>(hi), b.x, acc);
  acc = __fmaf_rn(sbyte<2>(lo), b.y, acc);
  acc = __fmaf_rn(sbyte<3>(hi), b.z, acc);
  return __fmaf_rn(sbyte<3>(lo), b.w, acc);
}

// the 32 packed int4 codes of piece p against query chunks 8p .. 8p+7
__device__ __forceinline__ float piece_i4(uint4 c, const float4* __restrict__ qs,
                                          int p, float acc) {
  acc = word8(c.x, qs[swz(8 * p + 0)], qs[swz(8 * p + 1)], acc);
  acc = word8(c.y, qs[swz(8 * p + 2)], qs[swz(8 * p + 3)], acc);
  acc = word8(c.z, qs[swz(8 * p + 4)], qs[swz(8 * p + 5)], acc);
  return word8(c.w, qs[swz(8 * p + 6)], qs[swz(8 * p + 7)], acc);
}

template <bool PACKED>
__global__ void __launch_bounds__(kProbeThreads) gather_dots_kernel(
    const uint8_t* __restrict__ codes, const int* __restrict__ probe,
    const float* __restrict__ q, int n_cells, int cap, int row_bytes, int w,
    int nprobe, int group, float* __restrict__ out) {
  extern __shared__ __align__(16) float4 qs[];
  const long long pair = blockIdx.x;            // b * nprobe + j
  const long long b = pair / nprobe;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float4* qrow = reinterpret_cast<const float4*>(q + b * w);
  for (int c = t; c < w / 4; c += kProbeThreads) qs[swz(c)] = qrow[c];
  const int cell = min(max(probe[pair], 0), n_cells - 1);
  const uint8_t* blk = codes + (long long)cell * cap * row_bytes;
  float* o = out + pair * cap;
  __syncthreads();

  const int pieces = row_bytes / 16;
  const int rows_per_warp = 32 / group;
  const int sub = lane / group, gl = lane % group;
  const int nwarps = kProbeThreads / 32;
  // the bound is uniform across the warp, so every lane reaches the shuffles
  for (int r0 = warp * rows_per_warp; r0 < cap; r0 += nwarps * rows_per_warp) {
    const int row = r0 + sub;
    float acc = 0.f;
    if (row < cap) {
      const uint4* src = reinterpret_cast<const uint4*>(blk + (long long)row * row_bytes);
      for (int p = gl; p < pieces; p += group) {
        const uint4 c = src[p];
        acc = PACKED ? piece_i4(c, qs, p, acc) : piece_i8(c, qs, p, acc);
      }
    }
    for (int off = group / 2; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (row < cap && gl == 0) o[row] = acc;
  }
}

}  // namespace

// ---------------------------------------------------------------- C interface
// ``codes`` [n_cells, cap, row_bytes] (row_bytes = W int8 codes or W/2 packed
// bytes, a multiple of 16, 16-byte aligned); ``probe`` [B, nprobe] int32 cell
// ids (clamped to the table); ``q`` [B, W] f32; ``out`` [B, nprobe, cap] f32.

extern "C" {

int evdb_gather_dots(const void* codes, const void* probe, const void* q,
                     int n_cells, int cap, int row_bytes, int w, int B,
                     int nprobe, int packed, void* out, void* stream) {
  if (n_cells < 1 || cap < 1 || B < 1 || nprobe < 1 || row_bytes % 16 ||
      w % 16 || w != row_bytes * (packed ? 2 : 1))
    return (int)cudaErrorInvalidValue;
  int group = 1;
  while (group < 32 && group < row_bytes / 16) group *= 2;
  const long long blocks = (long long)B * nprobe;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // whole groups of eight 16-byte chunks: the swizzle permutes within them
  const size_t smem = (size_t)((w + 31) / 32) * 32 * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* c = (const uint8_t*)codes;
  if (packed)
    gather_dots_kernel<true><<<(unsigned)blocks, kProbeThreads, smem, st>>>(
        c, (const int*)probe, (const float*)q, n_cells, cap, row_bytes, w,
        nprobe, group, (float*)out);
  else
    gather_dots_kernel<false><<<(unsigned)blocks, kProbeThreads, smem, st>>>(
        c, (const int*)probe, (const float*)q, n_cells, cap, row_bytes, w,
        nprobe, group, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
