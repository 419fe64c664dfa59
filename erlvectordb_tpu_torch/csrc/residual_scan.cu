// The full scan of the cell-residual (int4r) store for Hopper (sm_90a),
// ported from erlvectordb_tpu/ops/fused_topk.py.  Row r of such a store is
// its cell's centroid plus a packed int4 residual, so every score is the
// residual dot plus a per-(query, cell) centroid term ``table[b, r /
// cell_cap]``.
//
//   B5 pos_residual_scan <- _pos_residual_scan / _make_pos_residual_kernel
//        s = (fma(dot * qa[b], ma[r], table[b, cell] * mb[r]) + bb[r] - f[b]) * g[b]
//        key = (int32(clip(rint(s), +-2e9)) & ~1023) | lane;
//        the top t_top (2 or 8) keys of each 1024-row slice, max first
//
// (B6, the int4r store's masked extraction, is tile_scan.cu's.)  The
// multiply-add pattern of the score is the one XLA compiles the JAX
// kernel's expression to (found by matching the interpret-mode keys); every
// other step is its own correctly rounded operation (built with
// -fmad=false).  Where the TPU kernel expands the cell term to lanes with a
// matmul against a 0/1 block-indicator matrix, this reads a [B, ldt] f32
// table directly.
//
// B5 on an H100.  At (f) — 1024 queries x 1,605,632 rows x 128 dims — the
// dots are 2.1e11 int8 MACs against 103 MB of packed codes: 0.21 ms at the
// int8 tensor-core rate, while the 1.64e9 scores each need ~12 f32 steps of
// epilogue and a top-T insertion (2T min/max).  So the dots go to the
// tensor cores (mma_scan.cuh's scan_block: one block of 8 warps per
// (128-query tile, run of 1024-row slices), packed codes unpacked once per
// 128 queries, a 4-stage cp.async ring carrying the row factors {ma, mb,
// bb, cell} and the table block a 64-row piece touches) and the epilogue
// and selection set the pace:
//   * the epilogue runs on the accumulator fragment: thread (g, t) of a warp
//     scores queries g and g + 8 against rows 2t, 2t + 1 of each n-block and
//     keeps a sorted register list of T keys per query (fold_keys: at T = 8
//     two sorted runs of 8 merged in).  The int dot becomes f32 by a
//     mantissa add and the rounded key by one conversion, since conversions
//     issue at a quarter of the FFMA rate;
//   * at the end of a slice the 4 threads that share a query (a quad) merge
//     their lists by T rounds of a shuffle max, the one holder of each
//     winner popping it (keys carry their lane, so they are unique in a
//     slice).
// What bounds it now, by count: not the dots (their int8 bound is ~0.2 ms
// at (f)), but ~40 instructions a score of epilogue, selection, fragment
// loads and mma, ~1.9 ms at one instruction a cycle per scheduler, against
// a measured time near twice that (PERF.md section 6): two blocks of 8
// warps an SM (at most 128 registers a thread) are few to hide the epilogue's
// dependent chains.
//
// The entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "mma_scan.cuh"

namespace {

using namespace evdb;
namespace mm = evdb::mma;

constexpr int kPiecesPerSlice = kSlice / mm::kRows;

// B5: one block per (kBlockQ-query tile, run of ``run`` 1024-row slices), in
// a 1-D grid with the query tile fastest, so the blocks that read the same
// codes run together.  ``ncell`` bounds the cells a 64-row stage spans.
template <int T, bool WIDE>
__global__ void __launch_bounds__(mm::kBlockThreads, 2) residual_mma_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ codes, int B, int W,
    int n_slices, int run, const float* __restrict__ qa,
    const float* __restrict__ f, const float* __restrict__ g,
    const float* __restrict__ ma, const float* __restrict__ mb,
    const float* __restrict__ bb, const float* __restrict__ table, int ldt,
    int cell_cap, int ncell, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int q_tiles = (B + mm::kBlockQ - 1) / mm::kBlockQ;
  const int q0 = (int)(blockIdx.x % q_tiles) * mm::kBlockQ;
  const int s0 = (int)(blockIdx.x / q_tiles) * run;
  const int s1 = min(s0 + run, n_slices);

  // this thread's two queries (g and g + 8 of its warp's 16)
  float qa_r[2], f_r[2], g_r[2];
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = warp * mm::kWarpQ + gq + 8 * h;
    const bool ok = q0 + qi[h] < B;
    qa_r[h] = ok ? qa[q0 + qi[h]] : 0.f;
    f_r[h] = ok ? f[q0 + qi[h]] : 0.f;
    g_r[h] = ok ? g[q0 + qi[h]] : 0.f;
  }
  int top[2][T];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < T; ++i) top[h][i] = INT32_MIN;

  mm::scan_block<true, 3, true>(
      smem, q, codes, B, W, q0, (long long)s0 * kSlice,
      (s1 - s0) * kPiecesPerSlice, ma, mb, bb, table, ldt, cell_cap, ncell,
      [&](int (&acc)[8][4], int piece, const float4* rf, const float* tb) {
        // in the JAX kernel's operation order: each thread's 16 keys per
        // query (8 n-blocks x rows 2t, 2t + 1)
        const int sp = piece % kPiecesPerSlice;   // piece within its slice
        int key[2][16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * j + 2 * tq + e;
            const float4 fr = rf[r];
            const int cell = __float_as_int(fr.w);
            const uint32_t ln = (uint32_t)(sp * mm::kRows + r);   // row & 1023
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float tv = tb[qi[h] * ncell + cell];
              float v = __fmaf_rn(__fmul_rn(mm::dot_f32<WIDE>(acc[j][2 * h + e]),
                                            qa_r[h]), fr.x, __fmul_rn(tv, fr.y));
              v = __fadd_rn(v, fr.z);
              v = __fmul_rn(__fsub_rn(v, f_r[h]), g_r[h]);
              // rint after the clamp: the bounds are integers, so this is
              // clip(rint(s)) in one conversion
              const int si = __float2int_rn(fminf(fmaxf(v, -2.0e9f), 2.0e9f));
              key[h][2 * j + e] = (int)(((uint32_t)si & ~(uint32_t)(kSlice - 1)) | ln);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) fold_keys<T>(top[h], key[h]);
        if (sp == kPiecesPerSlice - 1) {
          // the quad's four lists -> the slice's top T per query, max first
          const int s = s0 + piece / kPiecesPerSlice;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool ok = tq == 0 && q0 + qi[h] < B;
            int* o = out + ((long long)(q0 + qi[h]) * n_slices + s) * T;
#pragma unroll
            for (int rd = 0; rd < T; ++rd) {
              const int mx = pop_quad_max<T>(top[h]);
              if (ok) o[rd] = mx;
            }
#pragma unroll
            for (int i = 0; i < T; ++i) top[h][i] = INT32_MIN;
          }
        }
      });
}

template <int T, bool WIDE>
int launch_residual(int blocks, int smem, cudaStream_t st, const void* q,
                    const void* codes, int B, int W, int n_slices, int run,
                    const void* qa, const void* f, const void* g, const void* ma,
                    const void* mb, const void* bb, const void* table, int ldt,
                    int cell_cap, int ncell, void* out) {
  static const int rc = mm::configure(residual_mma_kernel<T, WIDE>);
  if (rc) return rc;
  residual_mma_kernel<T, WIDE><<<blocks, mm::kBlockThreads, smem, st>>>(
      (const int8_t*)q, (const int8_t*)codes, B, W, n_slices, run,
      (const float*)qa, (const float*)f, (const float*)g, (const float*)ma,
      (const float*)mb, (const float*)bb, (const float*)table, ldt, cell_cap,
      ncell, (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C interface
// ``ww`` is the packed row width in 32-bit words (W/8); the int8 query is
// W/4 words with each 8-element group reordered to [evens | odds].  ``table``
// is [B, ldt] f32 with ldt >= the cells the scanned rows fall in.  The
// launch layout (``run`` slices a block, ``ncell`` cells a 64-row stage
// spans, ``smem`` bytes) comes from ops/fused_topk.py::residual_scan_layout,
// the one place that sizes its shared memory.

extern "C" {

int evdb_pos_residual_scan(const void* q, const void* codes, const void* qa,
                           const void* f, const void* g, const void* ma,
                           const void* mb, const void* bb, const void* table,
                           int ldt, int cell_cap, int B, int ww, int n_slices,
                           int t_top, int run, int ncell, int smem, void* out,
                           void* stream) {
  const int W = 8 * ww;
  if (cell_cap < 1 || run < 1 || ncell < 1 || W % mm::kK || smem > mm::kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + mm::kBlockQ - 1) / mm::kBlockQ * ((n_slices + run - 1) / run);
  const bool wide = mm::wide_dots(true, W);
  decltype(&launch_residual<2, false>) go = nullptr;
  if (t_top == 2) go = wide ? &launch_residual<2, true> : &launch_residual<2, false>;
  if (t_top == 8) go = wide ? &launch_residual<8, true> : &launch_residual<8, false>;
  if (!go) return (int)cudaErrorInvalidValue;
  return go(blocks, smem, (cudaStream_t)stream, q, codes, B, W, n_slices, run,
            qa, f, g, ma, mb, bb, table, ldt, cell_cap, ncell, out);
}

}  // extern "C"
