// Scans of the cell-residual (int4r) store for Hopper (sm_90a), ported from
// erlvectordb_tpu/ops/fused_topk.py.  Row r of such a store is its cell's
// centroid plus a packed int4 residual, so every score is the residual dot
// plus a per-(query, cell) centroid term ``table[b, r / cell_cap]``.
//
//   B5 pos_residual_scan <- _pos_residual_scan / _make_pos_residual_kernel
//        s = (fma(dot * qa[b], ma[r], table[b, cell] * mb[r]) + bb[r] - f[b]) * g[b]
//        key = (int32(clip(rint(s), +-2e9)) & ~1023) | lane;
//        the top t_top (2 or 8) keys of each 1024-row slice, max first
//   B6 cell_scan         <- _fused_scan / _make_scan_kernel, cell_cap > 0
//        B4's masked extraction plus fma(table[b, cell] * qmult2[b], rowmult2[r], sims)
//        (tile_scan_kernel in scan_common.cuh with CELL)
//
// The multiply-add pattern of both scores is the one XLA compiles the JAX
// kernels' expressions to (found by matching the interpret-mode keys); every
// other step is its own correctly rounded operation (built with -fmad=false).
//
// Where the TPU kernels expand the cell term to lanes with a matmul against a
// 0/1 block-indicator matrix over a transposed [cells, B] table, these read
// ``table[b * ldt + r / cell_cap]`` directly: a [B, cells] f32 table padded to
// cover every scanned row, which the L1 cache serves (a 256-row piece touches
// 256 / cell_cap cells per query).
//
// What bounds them on an H100: at 1024 queries x 1,605,632 rows x 128 dims
// (the int4r store of 1.2M rows) the residual dots are ~421 G MACs against
// 103 MB of packed codes, compute-bound like B1-B4; the dots run on __dp4a
// after a per-word nibble unpack, far from the int8 tensor-core rate.  B5
// keeps up to 8 keys per query and slice, which is why it takes B4's layout
// (8 queries per block, a sorted per-thread list per query, T rounds of a
// block max) rather than B3's 32 queries with one running max.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "scan_common.cuh"

namespace {

using namespace evdb;

// B5: one block per (kSlice-row slice, 8 queries).
template <int T>
__global__ void __launch_bounds__(kThreads) residual_slice_kernel(
    const int* __restrict__ q, const int* __restrict__ codes, int B, int ww,
    int n_slices, const float* __restrict__ qa,
    const float* __restrict__ f, const float* __restrict__ g,
    const float* __restrict__ ma, const float* __restrict__ mb,
    const float* __restrict__ bb, const float* __restrict__ table, int ldt,
    int cell_cap, int* __restrict__ out) {
  __shared__ int cs[kThreads][kWords + 1];
  __shared__ __align__(16) int qs[kTileQ][kWords * I4::QW];
  __shared__ int red[2][kThreads / 32];
  __shared__ float qa_s[kTileQ], f_s[kTileQ], g_s[kTileQ];
  const int s = blockIdx.x, q0 = blockIdx.y * kTileQ, t = threadIdx.x;
  if (t < kTileQ) {  // read after piece_dots' first barrier
    const bool ok = q0 + t < B;
    qa_s[t] = ok ? qa[q0 + t] : 0.f;
    f_s[t] = ok ? f[q0 + t] : 0.f;
    g_s[t] = ok ? g[q0 + t] : 0.f;
  }
  int top[kTileQ][T];
#pragma unroll
  for (int j = 0; j < kTileQ; ++j)
#pragma unroll
    for (int i = 0; i < T; ++i) top[j][i] = INT32_MIN;

  for (int p = 0; p < kSlice / kThreads; ++p) {
    const long long row0 = (long long)s * kSlice + p * kThreads;
    int acc[kTileQ];
    piece_dots<I4, kTileQ>(q, codes, B, ww, q0, row0, cs, qs, acc);
    const long long row = row0 + t;
    const uint32_t lane = (uint32_t)(p * kThreads + t);  // row & (kSlice - 1)
    const float mar = ma[row], mbr = mb[row], br = bb[row];
    const long long cell = row / cell_cap;
#pragma unroll
    for (int j = 0; j < kTileQ; ++j) {
      const float tv = (q0 + j < B) ? table[(long long)(q0 + j) * ldt + cell] : 0.f;
      float v = __fmaf_rn(__fmul_rn(to_f32(acc[j]), qa_s[j]), mar, __fmul_rn(tv, mbr));
      v = __fadd_rn(v, br);
      v = __fmul_rn(__fsub_rn(v, f_s[j]), g_s[j]);
      v = fminf(fmaxf(rintf(v), -2.0e9f), 2.0e9f);
      push_top<T>(top[j], (int)(((uint32_t)(int)v & ~(uint32_t)(kSlice - 1)) | lane));
    }
  }

  int round = 0;
#pragma unroll
  for (int j = 0; j < kTileQ; ++j) {
#pragma unroll
    for (int r = 0; r < T; ++r, ++round) {
      const int mx = pop_block_max<T>(top[j], red, round);
      if (t == 0 && q0 + j < B)
        out[(long long)(q0 + j) * n_slices * T + (long long)s * T + r] = mx;
    }
  }
}

template <int T>
void launch_residual(dim3 grid, cudaStream_t st, const void* q, const void* codes,
                     int B, int ww, int n_slices, const void* qa,
                     const void* f, const void* g, const void* ma, const void* mb,
                     const void* bb, const void* table, int ldt, int cell_cap,
                     void* out) {
  residual_slice_kernel<T><<<grid, kThreads, 0, st>>>(
      (const int*)q, (const int*)codes, B, ww, n_slices,
      (const float*)qa, (const float*)f, (const float*)g, (const float*)ma,
      (const float*)mb, (const float*)bb, (const float*)table, ldt, cell_cap,
      (int*)out);
}

}  // namespace

// ---------------------------------------------------------------- C interface
// ``ww`` is the packed row width in 32-bit words (W/8); the int8 query is
// W/4 words with each 8-element group reordered to [evens | odds].  ``table``
// is [B, ldt] f32 with ldt >= the cells the scanned rows fall in.

extern "C" {

int evdb_pos_residual_scan(const void* q, const void* codes, const void* qa,
                           const void* f, const void* g, const void* ma,
                           const void* mb, const void* bb, const void* table,
                           int ldt, int cell_cap, int B, int ww, int n_slices,
                           int t_top, void* out, void* stream) {
  if (cell_cap < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_slices, (B + kTileQ - 1) / kTileQ);
  cudaStream_t st = (cudaStream_t)stream;
  switch (t_top) {
    case 2: launch_residual<2>(grid, st, q, codes, B, ww, n_slices, qa, f, g, ma, mb, bb, table, ldt, cell_cap, out); break;
    case 8: launch_residual<8>(grid, st, q, codes, B, ww, n_slices, qa, f, g, ma, mb, bb, table, ldt, cell_cap, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int evdb_cell_scan(const void* q, const void* codes, const void* qmult,
                   const void* rowmult, const void* rowbias, const void* qmult2,
                   const void* rowmult2, const void* table, int ldt, int cell_cap,
                   int B, int ww, int n_tiles, int t, void* vals, void* rows,
                   void* stream) {
  if (cell_cap < 1) return (int)cudaErrorInvalidValue;
  return launch_tile<I4, true>(q, codes, B, ww, n_tiles, t, qmult, rowmult,
                               rowbias, qmult2, rowmult2, table, ldt, cell_cap,
                               vals, rows, stream);
}

}  // extern "C"
