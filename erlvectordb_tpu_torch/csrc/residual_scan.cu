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
// Where the TPU kernels expand the cell term to lanes with a matmul against a
// 0/1 block-indicator matrix, these read a [B, ldt] f32 table directly.
//
// B5 on an H100.  At (f) — 1024 queries x 1,605,632 rows x 128 dims — the
// dots are 2.1e11 int8 MACs against 103 MB of packed codes: 0.21 ms at the
// int8 tensor-core rate, while the 1.64e9 scores each need ~12 f32 steps of
// epilogue and a top-T insertion (2T min/max).  So the dots go to the
// tensor cores (mma_scan.cuh) and the epilogue and selection set the pace:
//   * one block of 8 warps per (128-query tile, run of 1024-row slices); each
//     warp owns 16 of the tile's queries against every row of the slice, and
//     a warp whose 16 queries all lie past the batch skips the dots and the
//     epilogue (a 1-query request runs one warp's worth of them);
//   * codes stream through in stages of 64 rows x 128 elements (k), by
//     cp.async into a ring of 4 stages of packed bytes, with the per-row
//     factors {ma, mb, bb, cell} and the [128 queries x cells] block of the
//     table that a 64-row piece touches (so the epilogue reads them from
//     shared memory): three stages of copies stay in flight, one barrier a
//     stage.  Each thread unpacks the 16 bytes it copied, one stage ahead,
//     into a double buffer of int8 rows; a code piece is unpacked once per
//     128 queries (the old kernel: once per 8);
//   * rows of up to 4 k stages (W <= 512) keep the query tile in shared
//     memory for the whole run; wider rows stream its k stage through the
//     ring beside the codes', so shared memory stays within 206,848 B (W
//     256 at cell_cap 1) at any W and cell_cap (the factor ring holds the
//     pieces in flight: 4 slots up to W 256, 2 from W 384);
//   * the epilogue runs on the accumulator fragment: thread (g, t) of a warp
//     scores queries g and g + 8 against rows 2t, 2t + 1 of each n-block and
//     keeps a sorted register list of T keys per query.  At T = 8 a stage's
//     16 keys a query are sorted as two runs of 8 and merged into the list
//     (~9 integer min/max a key, against push_top's 16; those run at half
//     the FFMA rate); at T = 2 each key goes through push_top.  The int dot
//     becomes f32 by a mantissa add and the rounded key by one conversion,
//     since conversions issue at a quarter of the FFMA rate;
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
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "mma_scan.cuh"

namespace {

using namespace evdb;
namespace mm = evdb::mma;

constexpr int kResWarps = 8;
constexpr int kResThreads = 32 * kResWarps;
constexpr int kResQ = mm::kWarpQ * kResWarps;   // 128 queries per block
constexpr int kStagesPerSlice = kSlice / mm::kRows;
constexpr int kSmemMax = 232448;                 // 227 KB a block may use
constexpr int kResStages = 4;                    // copy ring depth, stages
constexpr int kPackedStage = mm::kRows * mm::kK / 2;   // 4 KB of packed codes
constexpr int kQStage = kResQ * mm::kCodePitch;        // a k stage of the query tile

// The int dot as f32.  |d| <= 8 * 128 * W < 2^22 for W < 4096, and then
// 1.5 * 2^23 + d has d in its low mantissa bits: an add instead of a
// conversion (those issue at a quarter of the FFMA rate).  Wider rows take
// the conversion, which rounds as the reference's int -> f32 does.
template <bool WIDE>
__device__ __forceinline__ float dot_f32(int d) {
  if constexpr (WIDE) return __int2float_rn(d);
  return __fsub_rn(__int_as_float(0x4B400000 + d), 12582912.0f);
}

// B5: one block per (kResQ-query tile, run of ``run`` 1024-row slices), in a
// 1-D grid with the query tile fastest, so the blocks that read the same
// codes run together.  ``ncell`` bounds the cells a 64-row stage spans.
// Dynamic shared memory, as ops/fused_topk.py::residual_scan_layout sizes
// it: unpacked codes [2][64][144] int8 | ring of kResStages packed stages
// [64 x 64 B] | query k stages [min(kw, kResStages)][kResQ][144] int8 |
// ring of nf pieces' row factors [64] float4 and table blocks
// [kResQ][ncell] f32.
template <int T, bool WIDE>
__global__ void __launch_bounds__(kResThreads, 2) residual_mma_kernel(
    const int8_t* __restrict__ q, const uint8_t* __restrict__ codes, int B, int W,
    int n_slices, int run, const float* __restrict__ qa,
    const float* __restrict__ f, const float* __restrict__ g,
    const float* __restrict__ ma, const float* __restrict__ mb,
    const float* __restrict__ bb, const float* __restrict__ table, int ldt,
    int cell_cap, int ncell, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kw = W / mm::kK;                       // k stages per 64-row piece
  // the query's k stages stay resident when there are at most kResStages
  // of them; wider rows stream theirs through the ring beside the codes
  const bool q_res = kw <= kResStages;
  // slots for the pieces whose factors are in flight at once: a piece's
  // are issued kResStages - 1 stages ahead of its first k stage and read at
  // its last, so 1 + ceil(3 / kw) of them; a power of two, for the index
  const int nf = kw <= 2 ? 4 : 2;
  int8_t* cs = reinterpret_cast<int8_t*>(smem);    // unpacked, 2 buffers
  uint8_t* pk = reinterpret_cast<uint8_t*>(cs + 2 * mm::kRows * mm::kCodePitch);
  int8_t* qs = reinterpret_cast<int8_t*>(pk + kResStages * kPackedStage);
  float4* rf = reinterpret_cast<float4*>(qs + min(kw, kResStages) * kQStage);
  float* tab = reinterpret_cast<float*>(rf + nf * mm::kRows);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int q_tiles = (B + kResQ - 1) / kResQ;
  const int q0 = (int)(blockIdx.x % q_tiles) * kResQ;
  const int s0 = (int)(blockIdx.x / q_tiles) * run;
  const int s1 = min(s0 + run, n_slices);
  const int n_stage = (s1 - s0) * kStagesPerSlice * kw;
  const int half = W / 2;                          // packed bytes per row
  // the tile's rows up to the last warp with a query below B; the warps
  // past it take part in the copies and barriers only
  const int n_live = min(kResQ, (B - q0 + mm::kWarpQ - 1) / mm::kWarpQ * mm::kWarpQ);
  const bool live = warp * mm::kWarpQ < n_live;

  if (q_res) {   // the whole query tile, k stage by k stage, zero past B
    const int q16 = W / 16;
    for (int i = tid; i < n_live * q16; i += kResThreads) {
      const int r = i / q16, c = i % q16;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (q0 + r < B)
        v = __ldg(reinterpret_cast<const uint4*>(q + (long long)(q0 + r) * W) + c);
      *reinterpret_cast<uint4*>(qs + (c >> 3) * kQStage + r * mm::kCodePitch
                                + 16 * (c & 7)) = v;
    }
  }
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

  // stage st: piece = st / kw (64 rows), kc = st % kw (128 elements); each
  // thread copies 16 packed bytes of a stage (row tid / 4, part tid % 4) and
  // unpacks the same 16 bytes itself, so no barrier stands between the two
  const int ld_row = tid >> 2, ld_part = tid & 3;   // 64 rows x 4 x 16 B
  // a piece's row factors and table block, into slot piece % nf
  auto load_factors = [&](int piece) {
    const int buf = piece & (nf - 1);
    const long long row0 = (long long)s0 * kSlice + piece * mm::kRows;
    const long long c0 = row0 / cell_cap;
    if (tid < mm::kRows) {
      const long long row = row0 + tid;
      float4* d = rf + buf * mm::kRows + tid;
      cp_async4(&d->x, ma + row, true);
      cp_async4(&d->y, mb + row, true);
      cp_async4(&d->z, bb + row, true);
      d->w = __int_as_float((int)(row / cell_cap - c0));
    }
    float* tb = tab + buf * kResQ * ncell;
    for (int i = tid; i < n_live * ncell; i += kResThreads) {
      const int r = i / ncell, c = i % ncell;
      const bool ok = q0 + r < B && c0 + c < ldt;
      cp_async4(tb + i, ok ? table + (long long)(q0 + r) * ldt + c0 + c : table, ok);
    }
  };
  // one commit group per stage (empty past the end, to keep the count)
  auto issue = [&](int st) {
    if (st < n_stage) {
      const int piece = st / kw, kc = st % kw;
      const long long row = (long long)s0 * kSlice + piece * mm::kRows + ld_row;
      cp_async16(pk + (st % kResStages) * kPackedStage + 16 * tid,
                 codes + row * half + kc * (mm::kK / 2) + ld_part * 16);
      if (!q_res) {   // k stage kc of the query tile: n_live rows x 8 x 16 B
        int8_t* d = qs + (st % kResStages) * kQStage;
        for (int e = tid; e < n_live * 8; e += kResThreads) {
          const int r = e >> 3, c = e & 7;
          const bool ok = q0 + r < B;
          cp_async16(d + r * mm::kCodePitch + 16 * c,
                     ok ? q + (long long)(q0 + r) * W + kc * mm::kK + 16 * c : q, ok);
        }
      }
      if (kc == 0) load_factors(piece);
    }
    cp_async_commit();
  };
  auto unpack = [&](int st) {   // this thread's 16 bytes of stage st
    const uint4 p = *reinterpret_cast<const uint4*>(
        pk + (st % kResStages) * kPackedStage + 16 * tid);
    mm::unpack_store(cs + (st & 1) * mm::kRows * mm::kCodePitch
                     + ld_row * mm::kCodePitch + ld_part * 32, p);
  };

  int top[2][T];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < T; ++i) top[h][i] = INT32_MIN;
  int acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  // a ring of kResStages stages in flight: at stage st, the copies of stage
  // st + kResStages - 1 are issued and stage st + 1 is unpacked
#pragma unroll
  for (int st = 0; st < kResStages - 1; ++st) issue(st);
  cp_async_wait<kResStages - 2>();
  if (n_stage > 0) unpack(0);
  __syncthreads();

  for (int st = 0; st < n_stage; ++st) {
    const int cur = st & 1, piece = st / kw, kc = st % kw;
    issue(st + kResStages - 1);        // into the slots stage st - 1 freed
    cp_async_wait<kResStages - 2>();   // this thread's stage st + 1
    if (st + 1 < n_stage) unpack(st + 1);
    if (live) {
      const int8_t* qw = qs + (q_res ? kc : st % kResStages) * kQStage
                         + warp * mm::kWarpQ * mm::kCodePitch;
      mm::warp_tile_dots(qw, mm::kCodePitch, cs + cur * mm::kRows * mm::kCodePitch, acc);
    }

    if (live && kc == kw - 1) {
      // epilogue of this 64-row piece, in the JAX kernel's operation order:
      // each thread's 16 keys per query (8 n-blocks x rows 2t, 2t + 1)
      const float4* rfb = rf + (piece & (nf - 1)) * mm::kRows;
      const float* tb = tab + (piece & (nf - 1)) * kResQ * ncell;
      const int sp = piece % kStagesPerSlice;      // piece within its slice
      int key[2][16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + 2 * tq + e;
          const float4 fr = rfb[r];
          const int cell = __float_as_int(fr.w);
          const uint32_t ln = (uint32_t)(sp * mm::kRows + r);   // row & 1023
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float tv = tb[qi[h] * ncell + cell];
            float v = __fmaf_rn(__fmul_rn(dot_f32<WIDE>(acc[j][2 * h + e]), qa_r[h]),
                                fr.x, __fmul_rn(tv, fr.y));
            v = __fadd_rn(v, fr.z);
            v = __fmul_rn(__fsub_rn(v, f_r[h]), g_r[h]);
            // rint after the clamp: the bounds are integers, so this is
            // clip(rint(s)) in one conversion
            const int si = __float2int_rn(fminf(fmaxf(v, -2.0e9f), 2.0e9f));
            key[h][2 * j + e] = (int)(((uint32_t)si & ~(uint32_t)(kSlice - 1)) | ln);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (T == 8) {   // two sorted runs of 8 merged into the list
          sort8_desc(key[h]);
          sort8_desc(key[h] + 8);
          merge_top8(top[h], key[h]);
          merge_top8(top[h], key[h] + 8);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) push_top<T>(top[h], key[h][i]);
        }
      }
      if (sp == kStagesPerSlice - 1) {
        // the quad's four lists -> the slice's top T per query, max first
        const int s = s0 + piece / kStagesPerSlice;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = tq == 0 && q0 + qi[h] < B;
          int* o = out + ((long long)(q0 + qi[h]) * n_slices + s) * T;
#pragma unroll
          for (int rd = 0; rd < T; ++rd) {
            int mx = max(top[h][0], __shfl_xor_sync(0xffffffffu, top[h][0], 1));
            mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const bool pop = top[h][0] == mx;
#pragma unroll
            for (int i = 0; i + 1 < T; ++i) top[h][i] = pop ? top[h][i + 1] : top[h][i];
            top[h][T - 1] = pop ? INT32_MIN : top[h][T - 1];
            if (ok) o[rd] = mx;
          }
#pragma unroll
          for (int i = 0; i < T; ++i) top[h][i] = INT32_MIN;
        }
      }
    }

    __syncthreads();
  }
}

template <int T, bool WIDE>
int launch_residual(int blocks, int smem, cudaStream_t st, const void* q,
                    const void* codes, int B, int W, int n_slices, int run,
                    const void* qa, const void* f, const void* g, const void* ma,
                    const void* mb, const void* bb, const void* table, int ldt,
                    int cell_cap, int ncell, void* out) {
  static bool configured = false;   // raise the dynamic shared-memory cap once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        residual_mma_kernel<T, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  residual_mma_kernel<T, WIDE><<<blocks, kResThreads, smem, st>>>(
      (const int8_t*)q, (const uint8_t*)codes, B, W, n_slices, run,
      (const float*)qa, (const float*)f, (const float*)g, (const float*)ma,
      (const float*)mb, (const float*)bb, (const float*)table, ldt, cell_cap,
      ncell, (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------- C interface
// ``ww`` is the packed row width in 32-bit words (W/8); the int8 query is
// W/4 words with each 8-element group reordered to [evens | odds].  ``table``
// is [B, ldt] f32 with ldt >= the cells the scanned rows fall in.  B5's
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
  if (cell_cap < 1 || run < 1 || ncell < 1 || W % mm::kK || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + kResQ - 1) / kResQ * ((n_slices + run - 1) / run);
  const bool wide = W >= 4096;   // dots that may reach 2^22 (dot_f32)
  decltype(&launch_residual<2, false>) go = nullptr;
  if (t_top == 2) go = wide ? &launch_residual<2, true> : &launch_residual<2, false>;
  if (t_top == 8) go = wide ? &launch_residual<8, true> : &launch_residual<8, false>;
  if (!go) return (int)cudaErrorInvalidValue;
  return go(blocks, smem, (cudaStream_t)stream, q, codes, B, W, n_slices, run,
            qa, f, g, ma, mb, bb, table, ldt, cell_cap, ncell, out);
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
