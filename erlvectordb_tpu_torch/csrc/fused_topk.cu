// Fused distance + top-k scans for Hopper (sm_90a): the key scans of the
// store's search path, ported from erlvectordb_tpu/ops/fused_topk.py, and
// the masked extraction over f32 codes.
//
//   B1 intkey_scan  <- _intkey_scan / _make_intkey_kernel
//        key[b, s] = max over the 1024-row slice s of (dot(q8[b], c8[r]) << 10) | lane
//   B2 l2key_scan   <- _l2key_scan / _make_l2key_kernel
//        key[b, s] = max over s of ((dot - bias[r]) << 10) | lane
//   B3 pos_scan     <- _pos_scan / _make_pos_kernel (int8, packed int4 and f32 codes)
//        s = (fma(dot * m[r] (* qm[b]), bv[r]) - f[b]) * g[b]
//        key = (int32(clip(rint(s), +-2e9)) & ~1023) | lane, max per slice
//   B4 fused_scan   <- _fused_scan / _make_scan_kernel, cell_cap == 0, on f32
//        codes (int8 and packed int4: tile_scan.cu)
//        sims = fma(dot * qmult[b], rowmult[r], rowbias[r]); monotone float->int
//        key with the low 12 bits = lane in a 4096-row tile; top-T per tile
//
// B1-B3 on int8 and packed int4 codes: slice_scan_kernel.  At 1024 queries
// x 1.2M rows x 128 the dots are 1.6e11 int8 MACs against 154 MB of int8
// codes (77 MB packed): 0.16 ms at the int8 tensor-core rate, while the
// epilogue is light (B1: a shift, an or and a max a score; B3: ~10 f32 and
// integer steps and one conversion).  So the dots go to the tensor cores
// through mma_scan.cuh's scan_block (one block of 8 warps per (128-query
// tile, run of 1024-row slices), codes staged once per 128 queries, where
// the __dp4a kernel this replaces staged them once per 32; int8 stages
// copied by cp.async straight into the rows ldmatrix reads, packed ones
// unpacked once a stage; B2's bias and B3's m, bv through the copy ring
// beside them).  The epilogue runs on the C fragment: thread (g, t) of a
// warp folds its 16 scores a piece for each of queries g and g + 8 into one
// running max per query, and at the end of a slice two shuffles merge the
// quad's maxima (keys carry their lane, so the max is the JAX kernel's).
// What bounds it, by count: the fragment loads (a warp reads a stage's codes
// with 16 ldmatrix.x4 for 32 mma) and, for B3, the epilogue's ~12
// instructions a score; no longer the dots.
//
// B3 on f32 codes (the default f32 store's scan) is its own kernel,
// pos_f32_kernel: at 1024 queries x 1.2M rows x 128 dims it is 1.57e11 f32
// FMAs, 4.7 ms at the 67 TFLOP/s of the CUDA cores.  It is a register-tiled
// SIMT product, as an SGEMM is:
//   * one block of 256 threads per (128-query tile, 1024-row slice), the
//     slice walked in 128-row tiles; each thread owns an 8 x 8 (rows x
//     queries) outer-product micro-tile, rows ty + 16 i and queries tx + 16 j
//     of the 16 x 16 thread grid;
//   * codes and queries come in chunks of 64 k (rows at a pitch of 68
//     floats) by 16-byte cp.async, double-buffered with one barrier a chunk
//     (a wide chunk means fewer barriers and copies per FFMA); a thread
//     reads 4 k of its 8 rows and 8 queries with 16 LDS.128 and does 256
//     FFMA;
//   * every dot is one fmaf chain over k = 0 .. W-1 in order: no TF32 and no
//     split-precision tensor-core emulation, whose products round otherwise;
//   * the epilogue runs on the micro-tile in the order above, folding each
//     key into a running max per (query, slice); at the end of the slice the
//     16 threads of a query column reduce by one shuffle and shared memory.
// What bounds it now: a bit over half the FFMA rate.  One block of 8 warps
// an SM (254 registers a thread) leaves little to hide each chunk's barrier
// and the epilogue, by count about a tenth of the FFMAs' issue at W 128.
//
// B4 on f32 codes (every f32 store below the pos gate's 144 tiles, and
// every f32 store at k > 16 or under EVDB_EXACT_SCAN=1) runs on the same
// mainloop (f32_block), so its dots, and so its keys, are B3-f32's fmaf
// chains; only the epilogue differs.  Where B3 keeps a running max per
// (query, slice) in registers, B4 needs the top-T (2, 4, 8) per (query,
// 4096-row tile), and T keys for each of a thread's 8 queries would spill
// a kernel already at ~250 registers.  So:
//   * after each 128-row tile the epilogue writes the 128 x 128 keys to a
//     key tile in shared memory (one barrier), and each query's two
//     selecting threads fold 64 keys each into a sorted list of T that
//     lives in shared memory between row tiles: one compare a key, an
//     insertion only past the list's last key;
//   * the two lists of a query merge by T shuffle rounds at the end;
//   * a tile is split into 1-16 pieces across blocks (4096 / split rows
//     each) so that a small store still fills the card (at 20k rows and
//     1024 queries a whole-tile block gives 40 blocks for 132 SMs); the
//     pieces' lists go to a scratch buffer and tile_merge_kernel takes the
//     top-T of their union, the tile's top-T (keys carry their lane, so ties
//     fall as in the plain version);
//   * a batch under 128 queries runs a narrower micro-tile (JN of 8 query
//     columns, 16 JN queries), so 1-16 queries cost 1/8 of a full block;
//   * the row factors of both f32 scans come through the copy ring with
//     each row tile's first k chunk: loaded from global memory in the
//     epilogue, their latency stalled every warp before the key tile's
//     barrier, a fifth of B4's time at 1.2M rows.
// What bounds it: the FFMAs, as B3 (1.57e11 of them at (c32)'s 1.2M rows,
// 1024 queries, k = 32: 4.7 ms at 67 TFLOP/s); by count the epilogue and
// selection add a few percent of the mainloop's issue at W 128, and what
// B4 loses to B3 beyond that is waiting at the key tile's barrier.  It
// replaces a first design of one block per (4096-row tile, 8 queries),
// which staged every tile's codes 128 times for a 1024-query batch and
// ended each tile in T x 8 rounds of a block-wide max, a barrier each.
//
// Bit-exactness with the JAX kernels: keys are shifted and subtracted as
// uint32 (JAX wraps int32; signed overflow is undefined in C++); B3/B4 keep
// the JAX operation order with __fmul_rn/__fsub_rn, and the one place where
// XLA fuses the JAX expression into a multiply-add (``x * m + b``, the row
// bias add) is an explicit __fmaf_rn — no other contraction (the file is
// built with -fmad=false); rounding is half to even, like jnp.round.
//
// Every entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include "mma_scan.cuh"

namespace {

using namespace evdb;
namespace mm = evdb::mma;

enum Mode { kIntkey = 0, kL2key = 1, kPos = 2 };
constexpr int kPiecesPerSlice = kSlice / mm::kRows;

// B1, B2, B3 on int8 or PACKED int4 codes: one block per (kBlockQ-query
// tile, run of ``run`` 1024-row slices), in a 1-D grid with the query tile
// fastest, so the blocks that read the same codes run together.  QM: B3's
// per-query multiplier (euclidean); WIDE: dots that may pass 2^22.
template <bool PACKED, int MODE, bool QM, bool WIDE>
__global__ void __launch_bounds__(mm::kBlockThreads, 2) slice_scan_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ codes, int B, int W,
    int n_slices, int run, const int* __restrict__ bias,
    const float* __restrict__ qm, const float* __restrict__ f,
    const float* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ bv, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int q_tiles = (B + mm::kBlockQ - 1) / mm::kBlockQ;
  const int q0 = (int)(blockIdx.x % q_tiles) * mm::kBlockQ;
  const int s0 = (int)(blockIdx.x / q_tiles) * run;
  const int s1 = min(s0 + run, n_slices);

  // this thread's two queries (g and g + 8 of its warp's 16) and, for B3,
  // their factors (zero past B)
  float qm_r[2] = {0.f, 0.f}, f_r[2] = {0.f, 0.f}, g_r[2] = {0.f, 0.f};
  int qi[2], best[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qi[h] = warp * mm::kWarpQ + gq + 8 * h;
    best[h] = INT32_MIN;
    if constexpr (MODE == kPos) {
      if (q0 + qi[h] < B) {
        if constexpr (QM) qm_r[h] = qm[q0 + qi[h]];
        f_r[h] = f[q0 + qi[h]];
        g_r[h] = g[q0 + qi[h]];
      }
    }
  }

  // row factors through the ring: B2's bias (its bits in .x), B3's m, bv
  constexpr int NF = MODE == kIntkey ? 0 : MODE == kL2key ? 1 : 2;
  mm::scan_block<PACKED, NF, false>(
      smem, q, codes, B, W, q0, (long long)s0 * kSlice,
      (s1 - s0) * kPiecesPerSlice,
      MODE == kL2key ? reinterpret_cast<const float*>(bias) : m, bv, nullptr,
      nullptr, 0, 1, 0,
      [&](int (&acc)[8][4], int piece, const float4* rf, const float*) {
        const int sp = piece % kPiecesPerSlice;   // piece within its slice
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * j + 2 * tq + e;
            const uint32_t ln = (uint32_t)(sp * mm::kRows + r);   // row & 1023
            float4 fr = make_float4(0.f, 0.f, 0.f, 0.f);
            if constexpr (NF > 0) fr = rf[r];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int d = acc[j][2 * h + e];
              int key;
              if constexpr (MODE == kIntkey) {
                key = (int)(((uint32_t)d << 10) | ln);
              } else if constexpr (MODE == kL2key) {
                const uint32_t dd = (uint32_t)d - (uint32_t)__float_as_int(fr.x);
                key = (int)((dd << 10) | ln);
              } else {
                // in the JAX kernel's operation order; rint after the clamp
                // (integer bounds): clip(rint(s)) in one conversion
                float v = mm::dot_f32<WIDE>(d);
                v = QM ? __fmaf_rn(__fmul_rn(v, fr.x), qm_r[h], fr.y)
                       : __fmaf_rn(v, fr.x, fr.y);
                v = __fmul_rn(__fsub_rn(v, f_r[h]), g_r[h]);
                const int si = __float2int_rn(fminf(fmaxf(v, -2.0e9f), 2.0e9f));
                key = (int)(((uint32_t)si & ~(uint32_t)(kSlice - 1)) | ln);
              }
              best[h] = max(best[h], key);
            }
          }
        }
        if (sp == kPiecesPerSlice - 1) {   // the quad's maxima -> the slice's
          const int s = s0 + piece / kPiecesPerSlice;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            int mx = max(best[h], __shfl_xor_sync(0xffffffffu, best[h], 1));
            mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            if (tq == 0 && q0 + qi[h] < B)
              out[(long long)(q0 + qi[h]) * n_slices + s] = mx;
            best[h] = INT32_MIN;
          }
        }
      });
}

template <bool PACKED, int MODE, bool QM, bool WIDE>
int launch_slice(int blocks, int smem, cudaStream_t st, const void* q,
                 const void* codes, int B, int W, int n_slices, int run,
                 const void* bias, const void* qm, const void* f, const void* g,
                 const void* m, const void* bv, void* out) {
  static const int rc = mm::configure(slice_scan_kernel<PACKED, MODE, QM, WIDE>);
  if (rc) return rc;
  slice_scan_kernel<PACKED, MODE, QM, WIDE><<<blocks, mm::kBlockThreads, smem, st>>>(
      (const int8_t*)q, (const int8_t*)codes, B, W, n_slices, run,
      (const int*)bias, (const float*)qm, (const float*)f, (const float*)g,
      (const float*)m, (const float*)bv, (int*)out);
  return (int)cudaGetLastError();
}

using SliceLaunch = decltype(&launch_slice<false, kIntkey, false, false>);

int slice_scan(SliceLaunch go, const void* q, const void* codes, int B, int W,
               int n_slices, int run, int smem, const void* bias, const void* qm,
               const void* f, const void* g, const void* m, const void* bv,
               void* out, void* stream) {
  if (run < 1 || W % mm::kK || smem > mm::kSmemMax) return (int)cudaErrorInvalidValue;
  const int blocks = (B + mm::kBlockQ - 1) / mm::kBlockQ * ((n_slices + run - 1) / run);
  return go(blocks, smem, (cudaStream_t)stream, q, codes, B, W, n_slices, run,
            bias, qm, f, g, m, bv, out);
}

// B3's launcher for the row format: per-query multiplier x wide dots
template <bool PACKED>
SliceLaunch pos_launch(bool use_qm, int W) {
  const bool wide = mm::wide_dots(PACKED, W);
  if (use_qm)
    return wide ? &launch_slice<PACKED, kPos, true, true> : &launch_slice<PACKED, kPos, true, false>;
  return wide ? &launch_slice<PACKED, kPos, false, true> : &launch_slice<PACKED, kPos, false, false>;
}

// ------------------------------------------- the f32 mainloop of B3 and B4

// One block of 256 threads covers kFQ queries x a run of kFR-row tiles.
constexpr int kFQ = 128;          // queries per block
constexpr int kFR = 128;          // rows per row tile
constexpr int kFK = 64;           // k per staged chunk
constexpr int kFP = kFK + 4;      // smem row pitch (floats): 16-B aligned, and
                                  // 8 rows 68 words apart hit distinct banks
constexpr int kFStages = 2;       // cp.async pipeline depth
constexpr int kFStageFloats = 2 * kFR * kFP;   // codes then queries
constexpr int kFRing = 2 * 2 * kFR;   // two row tiles' two factor planes
constexpr int kFSmem = (kFStages * kFStageFloats + kFRing) * 4;   // 141,312 B, dynamic

// The register-tiled FFMA mainloop B3-f32 and B4-f32 share.  Thread (tx, ty)
// of the 16 x 16 grid owns rows ty + 16 i (i < 8) and queries tx + 16 j (j <
// JN) of the block's tile; JN < 8 only where the whole batch is under 128
// queries, so a block of 1-16 queries does 1/8 of the work of a full one.
// The stages hold rows of kFK k each (row-major at pitch kFP), so a thread
// reads 4 k of a row or a query with one LDS.128 and the 8 queries' reads
// of a warp phase fall on distinct banks.  Every dot is one fmaf chain over
// k = 0 .. W-1 in order.  The row tile's two row-factor planes (f0, f1:
// 16-byte aligned) arrive by cp.async with its first k chunk, so the
// epilogue does not wait on global loads.  ``epi(acc, rt, fr)`` runs on the
// finished micro-tile of row tile rt, fr[r] and fr[kFR + r] being its
// factors (every thread calls it at the same point, so it may
// synchronise); the loop then zeroes acc.  The ring's barrier at the top of
// each stage also orders one row tile's epilogue before the next one's.
template <int JN, typename Epi>
__device__ __forceinline__ void f32_block(
    float* fsm, const float* __restrict__ q, const float* __restrict__ codes,
    const float* __restrict__ f0, const float* __restrict__ f1, int B, int W,
    int q0, long long row0, int n_rt, Epi&& epi) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kch = W / kFK;
  const int n_stage = n_rt * kch;

  // stage st: row tile st / kch, k chunk st % kch; 16-byte piece e = tid +
  // 256 p of each [128 x kFK] operand is row e / (kFK / 4) = ty + 16 p,
  // k 4 (e % (kFK / 4)); query rows past 16 JN are never read
  auto issue = [&](int st) {
    if (st < n_stage) {
      float* cs = fsm + (st % kFStages) * kFStageFloats;
      float* qs = cs + kFR * kFP;
      const long long r0 = row0 + (long long)(st / kch) * kFR;
      const int k0 = (st % kch) * kFK;
#pragma unroll
      for (int p = 0; p < kFR * kFK / 4 / kThreads; ++p) {
        const int e = tid + kThreads * p, r = e / (kFK / 4), c = 4 * (e % (kFK / 4));
        cp_async16(cs + r * kFP + c, codes + (r0 + r) * W + k0 + c, true);
        if (p < JN) {
          const bool ok = q0 + r < B;
          cp_async16(qs + r * kFP + c, ok ? q + (long long)(q0 + r) * W + k0 + c : q, ok);
        }
      }
      if (st % kch == 0 && tid < 2 * kFR / 4) {   // the row tile's factors
        float* fs = fsm + kFStages * kFStageFloats + ((st / kch) & 1) * 2 * kFR;
        const int plane = tid / (kFR / 4), c = 4 * (tid % (kFR / 4));
        cp_async16(fs + plane * kFR + c, (plane ? f1 : f0) + r0 + c, true);
      }
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };

  float acc[8][JN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) issue(st);
  for (int st = 0; st < n_stage; ++st) {
    cp_async_wait<kFStages - 2>();   // this thread's copies of stage st
    __syncthreads();                 // everyone's, and stage st - 1 is done
    issue(st + kFStages - 1);        // into the buffer stage st - 1 used
    const float* cs = fsm + (st % kFStages) * kFStageFloats;
    const float* qs = cs + kFR * kFP;
#pragma unroll
    for (int k4 = 0; k4 < kFK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * kFP + k4);
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(qs + (tx + 16 * j) * kFP + k4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {   // k in order: one fmaf chain per dot
          float c = __fmaf_rn(a[i].x, b.x, acc[i][j]);
          c = __fmaf_rn(a[i].y, b.y, c);
          c = __fmaf_rn(a[i].z, b.z, c);
          acc[i][j] = __fmaf_rn(a[i].w, b.w, c);
        }
      }
    }
    if (st % kch == kch - 1) {
      epi(acc, st / kch, fsm + kFStages * kFStageFloats + ((st / kch) & 1) * 2 * kFR);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
    }
  }
  cp_async_wait<0>();
}

// B3 on f32 codes: one block per (kFQ-query tile, 1024-row slice), in a 1-D
// grid with the query tile fastest, so the blocks that read a slice's codes
// run together (and the slice count has no grid.y limit).
template <bool QM>
__global__ void __launch_bounds__(kThreads, 1) pos_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ codes, int B, int W,
    int n_slices, const float* __restrict__ qm, const float* __restrict__ f,
    const float* __restrict__ g, const float* __restrict__ m,
    const float* __restrict__ bv, int* __restrict__ out) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ float qm_s[kFQ], f_s[kFQ], g_s[kFQ];
  __shared__ int red[kThreads / 32][kFQ];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_tiles = (B + kFQ - 1) / kFQ;
  const int q0 = (int)(blockIdx.x % q_tiles) * kFQ, s = (int)(blockIdx.x / q_tiles);
  const long long slice0 = (long long)s * kSlice;
  if (tid < kFQ) {   // read after the mainloop's first barrier
    const bool ok = q0 + tid < B;
    qm_s[tid] = ok ? qm[q0 + tid] : 0.f;
    f_s[tid] = ok ? f[q0 + tid] : 0.f;
    g_s[tid] = ok ? g[q0 + tid] : 0.f;
  }
  int best[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) best[j] = INT32_MIN;

  f32_block<8>(fsm, q, codes, m, bv, B, W, q0, slice0, kSlice / kFR,
               [&](float (&acc)[8][8], int rt, const float* fr) {
    // the row tile's keys, in the JAX kernel's operation order
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rl = rt * kFR + ty + 16 * i;   // row & 1023
      const float mr = fr[ty + 16 * i], br = fr[kFR + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qj = tx + 16 * j;
        float v = acc[i][j];
        v = QM ? __fmaf_rn(__fmul_rn(v, mr), qm_s[qj], br) : __fmaf_rn(v, mr, br);
        v = __fmul_rn(__fsub_rn(v, f_s[qj]), g_s[qj]);
        // rint after the clamp (integer bounds): one conversion, not two
        const int si = __float2int_rn(fminf(fmaxf(v, -2.0e9f), 2.0e9f));
        best[j] = max(best[j], (int)(((uint32_t)si & ~1023u) | (uint32_t)rl));
      }
    }
  });

  // the 16 threads of a query column: ty = 2w, 2w + 1 in warp w, then 8 warps
  const int warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int v = max(best[j], __shfl_xor_sync(0xffffffffu, best[j], 16));
    if ((tid & 31) < 16) red[warp][tx + 16 * j] = v;
  }
  __syncthreads();
  if (tid < kFQ && q0 + tid < B) {
    int v = red[0][tid];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) v = max(v, red[w][tid]);
    out[(long long)(q0 + tid) * n_slices + s] = v;
  }
}

template <typename K>
int set_smem(K kern, int bytes) {   // above 48 KB of dynamic shared memory
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

template <bool QM>
int launch_pos_f32(int blocks, cudaStream_t st, const float* q, const float* codes,
                   int B, int W, int n_slices, const float* qm, const float* f,
                   const float* g, const float* m, const float* bv, int* out) {
  static const int rc = set_smem(pos_f32_kernel<QM>, kFSmem);
  if (rc) return rc;
  pos_f32_kernel<QM><<<blocks, kThreads, kFSmem, st>>>(q, codes, B, W, n_slices, qm,
                                                     f, g, m, bv, out);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ B4 on f32 codes

// The row tile's keys, staged for the selection: [kFQ queries][kFR rows] at
// a pitch of 130 words.  The epilogue's stores (thread (tx, ty): query tx +
// 16 j, row ty + 16 i) land on banks 2 tx + ty, and the selection's loads
// (lane l: query l & 15, row 2 r + (l >> 4)) on 2 (l & 15) + (l >> 4): both
// conflict-free.
constexpr int kKP = kFR + 2;
constexpr int kKeyBytes = kFQ * kKP * 4;          // 66,560 B
constexpr int tile_f32_smem(int T) { return kFSmem + kKeyBytes + T * kThreads * 4; }

__device__ __forceinline__ void put_tile_key(float* vals, int* rows, long long o,
                                             int key, int tile) {
  const uint32_t kt = (uint32_t)key & ~0xFFFu;
  const uint32_t sr = ((int)kt >= 0) ? kt : 0x80000000u - kt;
  vals[o] = __int_as_float((int)sr);
  rows[o] = (int)((uint32_t)key & 0xFFFu) + tile * kTile;
}

// One block per (kFQ-query tile, piece of a 4096-row tile): ``split``
// pieces of 4096 / split rows a tile, the query tile fastest in a 1-D grid.
// After each 128-row tile the epilogue stages its 128 x 128 keys in shared
// memory; then each query's two selecting threads (lanes l and l ^ 16 of
// warp l / 16's query group) fold their 64 of the row tile's keys into a
// sorted list of T, kept in shared memory between row tiles (so nothing
// more stays live in registers across the mainloop), skipping every key
// below the list's last (one compare).  At the end of the piece the pair
// merges by T shuffle rounds.  With one piece a tile, the result goes
// straight out; else to ``part`` [B, n_tiles, split, T], merged by
// tile_merge_kernel.
template <int T, int JN>
__global__ void __launch_bounds__(kThreads, 1) tile_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ codes, int B, int W,
    int n_tiles, int split, const float* __restrict__ qmult,
    const float* __restrict__ rowmult, const float* __restrict__ rowbias,
    float* __restrict__ vals, int* __restrict__ rows, int* __restrict__ part) {
  extern __shared__ __align__(16) float fsm[];
  int* ks = reinterpret_cast<int*>(fsm + kFStages * kFStageFloats + kFRing);
  int* lists = ks + kFQ * kKP;   // [T][kThreads]: each thread's sorted list
  __shared__ float qm_s[kFQ];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int q_tiles = (B + kFQ - 1) / kFQ;
  const int q0 = (int)(blockIdx.x % q_tiles) * kFQ;
  const int seg = (int)(blockIdx.x / q_tiles);
  const int tile = seg / split, piece = seg % split;
  const int piece_rows = kTile / split;
  const long long row0 = (long long)seg * piece_rows;
  if (tid < kFQ)   // read after the mainloop's first barrier
    qm_s[tid] = q0 + tid < B ? qmult[q0 + tid] : 0.f;
#pragma unroll
  for (int i = 0; i < T; ++i) lists[i * kThreads + tid] = INT32_MIN;
  // the selecting thread's query and half of each row tile
  const int sq = 16 * warp + (lane & 15), sh = lane >> 4;
  const bool s_live = sq < 16 * JN && q0 + sq < B;

  f32_block<JN>(fsm, q, codes, rowmult, rowbias, B, W, q0, row0, piece_rows / kFR,
                [&](float (&acc)[8][JN], int rt, const float* fr) {
    const int lane0 = piece * piece_rows + rt * kFR;   // tile lane of row 0
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rl = ty + 16 * i;
      const float rm = fr[rl], rb = fr[kFR + rl];
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const int qj = tx + 16 * j;
        const float sims = __fmaf_rn(__fmul_rn(acc[i][j], qm_s[qj]), rm, rb);
        ks[qj * kKP + rl] = (int)((float_key(sims) & ~0xFFFu) | (uint32_t)(lane0 + rl));
      }
    }
    __syncthreads();
    if (s_live) {
      int top[T];
#pragma unroll
      for (int i = 0; i < T; ++i) top[i] = lists[i * kThreads + tid];
      int thr = top[T - 1];
      const int* kr = ks + sq * kKP + sh;
#pragma unroll 8
      for (int r = 0; r < kFR / 2; ++r) {
        const int k = kr[2 * r];
        if (k > thr) {
          push_top<T>(top, k);
          thr = top[T - 1];
        }
      }
#pragma unroll
      for (int i = 0; i < T; ++i) lists[i * kThreads + tid] = top[i];
    }
  });

  int top[T];
#pragma unroll
  for (int i = 0; i < T; ++i) top[i] = lists[i * kThreads + tid];
#pragma unroll
  for (int r = 0; r < T; ++r) {   // the pair's lists, merged
    const int mx = max(top[0], __shfl_xor_sync(0xffffffffu, top[0], 16));
    const bool pop = top[0] == mx;
#pragma unroll
    for (int i = 0; i + 1 < T; ++i) top[i] = pop ? top[i + 1] : top[i];
    top[T - 1] = pop ? INT32_MIN : top[T - 1];
    if (sh == 0 && s_live) {
      const long long qt = (long long)(q0 + sq) * n_tiles + tile;
      if (split == 1)
        put_tile_key(vals, rows, qt * T + r, mx, tile);
      else
        part[(qt * split + piece) * T + r] = mx;
    }
  }
}

// The pieces' lists of each (query, tile) -> its top-T: the top-T of the
// union of the pieces' top-T lists is the tile's.
template <int T>
__global__ void __launch_bounds__(kThreads) tile_merge_kernel(
    const int* __restrict__ part, int B, int n_tiles, int split,
    float* __restrict__ vals, int* __restrict__ rows) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * n_tiles) return;
  const int* p = part + idx * split * T;
  int top[T];
#pragma unroll
  for (int i = 0; i < T; ++i) top[i] = INT32_MIN;
  for (int i = 0; i < split * T; ++i) push_top<T>(top, p[i]);
  const int tile = (int)(idx % n_tiles);
#pragma unroll
  for (int r = 0; r < T; ++r) put_tile_key(vals, rows, idx * T + r, top[r], tile);
}

template <int T, int JN>
int launch_tile_f32(int blocks, cudaStream_t st, const float* q, const float* codes,
                    int B, int W, int n_tiles, int split, const float* qm,
                    const float* rm, const float* rb, float* vals, int* rows,
                    int* part) {
  static const int rc = set_smem(tile_f32_kernel<T, JN>, tile_f32_smem(T));
  if (rc) return rc;
  tile_f32_kernel<T, JN><<<blocks, kThreads, tile_f32_smem(T), st>>>(
      q, codes, B, W, n_tiles, split, qm, rm, rb, vals, rows, part);
  if (split > 1) {
    const long long n = (long long)B * n_tiles;
    tile_merge_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        part, B, n_tiles, split, vals, rows);
  }
  return (int)cudaGetLastError();
}

using TileF32Launch = decltype(&launch_tile_f32<2, 8>);

template <int T>
TileF32Launch tile_f32_launch(int jn) {
  return jn == 1 ? &launch_tile_f32<T, 1> : jn == 2 ? &launch_tile_f32<T, 2>
       : jn == 4 ? &launch_tile_f32<T, 4> : &launch_tile_f32<T, 8>;
}

}  // namespace

// ---------------------------------------------------------------- C interface
// Row widths arrive in 32-bit code words: W/4 for int8 rows, W for f32 rows,
// W/8 for packed int4 rows (whose int8 query is W/4 words, each 8-element
// group reordered to [evens | odds]).  The tensor-core scans' launch layout
// (``run`` slices a block, ``smem`` bytes) comes from
// ops/fused_topk.py::mma_scan_layout.

extern "C" {

int evdb_intkey_scan(const void* q, const void* codes, int B, int ww,
                     int n_slices, int run, int smem, void* out, void* stream) {
  return slice_scan(&launch_slice<false, kIntkey, false, false>, q, codes, B,
                    4 * ww, n_slices, run, smem, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, out, stream);
}

int evdb_l2key_scan(const void* q, const void* codes, const void* bias, int B,
                    int ww, int n_slices, int run, int smem, void* out,
                    void* stream) {
  return slice_scan(&launch_slice<false, kL2key, false, false>, q, codes, B,
                    4 * ww, n_slices, run, smem, bias, nullptr, nullptr,
                    nullptr, nullptr, nullptr, out, stream);
}

int evdb_pos_scan_i8(const void* q, const void* codes, const void* qm,
                     const void* f, const void* g, const void* m,
                     const void* bv, int use_qm, int B, int ww, int n_slices,
                     int run, int smem, void* out, void* stream) {
  return slice_scan(pos_launch<false>(use_qm, 4 * ww), q, codes, B, 4 * ww,
                    n_slices, run, smem, nullptr, qm, f, g, m, bv, out, stream);
}

int evdb_pos_scan_i4(const void* q, const void* codes, const void* qm,
                     const void* f, const void* g, const void* m,
                     const void* bv, int use_qm, int B, int ww, int n_slices,
                     int run, int smem, void* out, void* stream) {
  return slice_scan(pos_launch<true>(use_qm, 8 * ww), q, codes, B, 8 * ww,
                    n_slices, run, smem, nullptr, qm, f, g, m, bv, out, stream);
}

int evdb_pos_scan_f32(const void* q, const void* codes, const void* qm,
                      const void* f, const void* g, const void* m,
                      const void* bv, int use_qm, int B, int ww, int n_slices,
                      void* out, void* stream) {
  if (ww % kFK) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kFQ - 1) / kFQ * n_slices;
  auto go = use_qm ? launch_pos_f32<true> : launch_pos_f32<false>;
  return go(blocks, (cudaStream_t)stream, (const float*)q, (const float*)codes, B,
            ww, n_slices, (const float*)qm, (const float*)f, (const float*)g,
            (const float*)m, (const float*)bv, (int*)out);
}

int evdb_fused_scan_f32(const void* q, const void* codes, const void* qmult,
                        const void* rowmult, const void* rowbias, int B, int ww,
                        int n_tiles, int t, int split, int jn, void* part,
                        void* vals, void* rows, void* stream) {
  if (ww % kFK || B < 1 || n_tiles < 1 || !(split == 1 || split == 2 ||
      split == 4 || split == 8 || split == 16) || !(jn == 1 || jn == 2 ||
      jn == 4 || jn == 8) || (jn < 8 && B > 16 * jn) || (split > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const TileF32Launch go = t == 2 ? tile_f32_launch<2>(jn)
                         : t == 4 ? tile_f32_launch<4>(jn)
                         : t == 8 ? tile_f32_launch<8>(jn) : nullptr;
  if (!go) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kFQ - 1) / kFQ * n_tiles * split;
  return go(blocks, (cudaStream_t)stream, (const float*)q, (const float*)codes, B,
            ww, n_tiles, split, (const float*)qmult, (const float*)rowmult,
            (const float*)rowbias, (float*)vals, (int*)rows, (int*)part);
}

}  // extern "C"
