// Masked-extraction scans on the int8 tensor cores for Hopper (sm_90a),
// ported from erlvectordb_tpu/ops/fused_topk.py:
//
//   B4 fused_scan <- _fused_scan / _make_scan_kernel, cell_cap == 0, on
//        int8 and packed int4 codes (f32 codes: fused_topk.cu)
//        sims = fma(dot * qmult[b], rowmult[r], rowbias[r])
//   B6 cell_scan  <- the same with cell_cap > 0 (int4r stores below the
//        pos gate), plus the centroid term
//        sims = fma(table[b, r / cell_cap] * qmult2[b], rowmult2[r], sims)
//
// the product pattern XLA compiles the JAX kernel's expressions to; the key
// is (monotone int of sims & ~0xFFF) | lane, lane = the row in its 4096-row
// tile, and each tile keeps its top T (2, 4 or 8) keys per query, max first,
// handed back as (vals, rows).
//
// What bounds them on an H100: at (c) with k = 32 (1024 queries x 1.2M rows
// x 128) the dots are 1.6e11 int8 MACs, 0.16 ms at the int8 tensor-core
// rate, against 1.2e9 scores of ~8 f32 and integer steps and a top-T
// insertion each.  The design is B5's (residual_scan.cu) on mma_scan.cuh's
// scan_block: one block of 8 warps per (128-query tile, run of 4096-row
// tiles), codes staged once per 128 queries (the __dp4a kernel this
// replaces staged them once per 8 and unpacked packed words as often), the
// row factors {rowmult, rowbias, rowmult2, cell} and B6's table block
// through the copy ring, the score on the mma's C fragment, a sorted
// register list of T keys per (thread, query), and at the end of a tile T
// rounds of a shuffle max over the quad that shares a query (the old
// kernel: T rounds of a block-wide max, one barrier each).
//
// The entry points launch on the given stream, allocate nothing, and
// return cudaGetLastError().

#include "mma_scan.cuh"

namespace {

using namespace evdb;
namespace mm = evdb::mma;

constexpr int kPiecesPerTile = kTile / mm::kRows;

// One block per (kBlockQ-query tile, run of ``run`` 4096-row tiles), in a
// 1-D grid with the query tile fastest.  With CELL, ``ncell`` bounds the
// cells a 64-row stage spans.
template <bool PACKED, int T, bool CELL, bool WIDE>
__global__ void __launch_bounds__(mm::kBlockThreads, 2) tile_scan_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ codes, int B, int W,
    int n_tiles, int run, const float* __restrict__ qmult,
    const float* __restrict__ rowmult, const float* __restrict__ rowbias,
    const float* __restrict__ qmult2, const float* __restrict__ rowmult2,
    const float* __restrict__ table, int ldt, int cell_cap, int ncell,
    float* __restrict__ vals, int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int q_tiles = (B + mm::kBlockQ - 1) / mm::kBlockQ;
  const int q0 = (int)(blockIdx.x % q_tiles) * mm::kBlockQ;
  const int t0 = (int)(blockIdx.x / q_tiles) * run;
  const int t1 = min(t0 + run, n_tiles);

  // this thread's two queries (g and g + 8 of its warp's 16)
  float qm_r[2], qm2_r[2];
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = warp * mm::kWarpQ + gq + 8 * h;
    const bool ok = q0 + qi[h] < B;
    qm_r[h] = ok ? qmult[q0 + qi[h]] : 0.f;
    qm2_r[h] = (CELL && ok) ? qmult2[q0 + qi[h]] : 0.f;
  }
  int top[2][T];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < T; ++i) top[h][i] = INT32_MIN;

  mm::scan_block<PACKED, CELL ? 3 : 2, CELL>(
      smem, q, codes, B, W, q0, (long long)t0 * kTile, (t1 - t0) * kPiecesPerTile,
      rowmult, rowbias, rowmult2, table, ldt, cell_cap, ncell,
      [&](int (&acc)[8][4], int piece, const float4* rf, const float* tb) {
        const int tp = piece % kPiecesPerTile;   // piece within its tile
        int key[2][16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * j + 2 * tq + e;
            const float4 fr = rf[r];
            const uint32_t ln = (uint32_t)(tp * mm::kRows + r);   // row & 4095
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float sims = __fmaf_rn(
                  __fmul_rn(mm::dot_f32<WIDE>(acc[j][2 * h + e]), qm_r[h]), fr.x, fr.y);
              if constexpr (CELL) {
                const float tv = tb[qi[h] * ncell + __float_as_int(fr.w)];
                sims = __fmaf_rn(__fmul_rn(tv, qm2_r[h]), fr.z, sims);
              }
              key[h][2 * j + e] = (int)((float_key(sims) & ~0xFFFu) | ln);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) fold_keys<T>(top[h], key[h]);
        if (tp == kPiecesPerTile - 1) {
          // the quad's four lists -> the tile's top T per query, max first
          const int tile = t0 + piece / kPiecesPerTile;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool ok = tq == 0 && q0 + qi[h] < B;
            const long long o = ((long long)(q0 + qi[h]) * n_tiles + tile) * T;
#pragma unroll
            for (int rd = 0; rd < T; ++rd) {
              const int mx = pop_quad_max<T>(top[h]);
              if (ok) {
                const uint32_t kt = (uint32_t)mx & ~0xFFFu;
                const uint32_t sr = ((int)kt >= 0) ? kt : 0x80000000u - kt;
                vals[o + rd] = __int_as_float((int)sr);
                rows[o + rd] = (int)((uint32_t)mx & 0xFFFu) + tile * kTile;
              }
            }
#pragma unroll
            for (int i = 0; i < T; ++i) top[h][i] = INT32_MIN;
          }
        }
      });
}

template <bool PACKED, int T, bool CELL, bool WIDE>
int launch_tile(int blocks, int smem, cudaStream_t st, const void* q,
                const void* codes, int B, int W, int n_tiles, int run,
                const void* qmult, const void* rowmult, const void* rowbias,
                const void* qmult2, const void* rowmult2, const void* table,
                int ldt, int cell_cap, int ncell, void* vals, void* rows) {
  static const int rc = mm::configure(tile_scan_kernel<PACKED, T, CELL, WIDE>);
  if (rc) return rc;
  tile_scan_kernel<PACKED, T, CELL, WIDE><<<blocks, mm::kBlockThreads, smem, st>>>(
      (const int8_t*)q, (const int8_t*)codes, B, W, n_tiles, run,
      (const float*)qmult, (const float*)rowmult, (const float*)rowbias,
      (const float*)qmult2, (const float*)rowmult2, (const float*)table, ldt,
      cell_cap, ncell, (float*)vals, (int*)rows);
  return (int)cudaGetLastError();
}

template <bool PACKED, int T, bool CELL>
using Launch = decltype(&launch_tile<PACKED, T, CELL, false>);

template <bool PACKED, bool CELL>
int tile_scan(const void* q, const void* codes, const void* qmult,
              const void* rowmult, const void* rowbias, const void* qmult2,
              const void* rowmult2, const void* table, int ldt, int cell_cap,
              int B, int W, int n_tiles, int t, int run, int ncell, int smem,
              void* vals, void* rows, void* stream) {
  if (run < 1 || W % mm::kK || smem > mm::kSmemMax || (CELL && (cell_cap < 1 || ncell < 1)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + mm::kBlockQ - 1) / mm::kBlockQ * ((n_tiles + run - 1) / run);
  const bool wide = mm::wide_dots(PACKED, W);
  Launch<PACKED, 2, CELL> go = nullptr;
  if (t == 2) go = wide ? &launch_tile<PACKED, 2, CELL, true> : &launch_tile<PACKED, 2, CELL, false>;
  if (t == 4) go = wide ? &launch_tile<PACKED, 4, CELL, true> : &launch_tile<PACKED, 4, CELL, false>;
  if (t == 8) go = wide ? &launch_tile<PACKED, 8, CELL, true> : &launch_tile<PACKED, 8, CELL, false>;
  if (!go) return (int)cudaErrorInvalidValue;
  return go(blocks, smem, (cudaStream_t)stream, q, codes, B, W, n_tiles, run, qmult,
            rowmult, rowbias, qmult2, rowmult2, table, ldt, cell_cap, ncell, vals,
            rows);
}

}  // namespace

// ---------------------------------------------------------------- C interface
// Row widths arrive in 32-bit code words: W/4 for int8 rows, W/8 for packed
// int4 rows (whose int8 query is W/4 words, each 8-element group reordered
// to [evens | odds]).  B6's ``table`` is [B, ldt] f32 with ldt >= the cells
// the scanned rows fall in.  The launch layout (``run`` tiles a block,
// ``ncell`` cells a 64-row stage spans, ``smem`` bytes) comes from
// ops/fused_topk.py::mma_scan_layout.

extern "C" {

int evdb_fused_scan_i8(const void* q, const void* codes, const void* qmult,
                       const void* rowmult, const void* rowbias, int B, int ww,
                       int n_tiles, int t, int run, int smem, void* vals,
                       void* rows, void* stream) {
  return tile_scan<false, false>(q, codes, qmult, rowmult, rowbias, nullptr,
                                 nullptr, nullptr, 0, 0, B, 4 * ww, n_tiles, t,
                                 run, 0, smem, vals, rows, stream);
}

int evdb_fused_scan_i4(const void* q, const void* codes, const void* qmult,
                       const void* rowmult, const void* rowbias, int B, int ww,
                       int n_tiles, int t, int run, int smem, void* vals,
                       void* rows, void* stream) {
  return tile_scan<true, false>(q, codes, qmult, rowmult, rowbias, nullptr,
                                nullptr, nullptr, 0, 0, B, 8 * ww, n_tiles, t,
                                run, 0, smem, vals, rows, stream);
}

int evdb_cell_scan(const void* q, const void* codes, const void* qmult,
                   const void* rowmult, const void* rowbias, const void* qmult2,
                   const void* rowmult2, const void* table, int ldt, int cell_cap,
                   int B, int ww, int n_tiles, int t, int run, int ncell,
                   int smem, void* vals, void* rows, void* stream) {
  return tile_scan<true, true>(q, codes, qmult, rowmult, rowbias, qmult2,
                               rowmult2, table, ldt, cell_cap, B, 8 * ww,
                               n_tiles, t, run, ncell, smem, vals, rows, stream);
}

}  // extern "C"
